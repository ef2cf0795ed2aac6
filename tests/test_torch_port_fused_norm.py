"""The port's fused LayerNorm route against the JAX package's, on the CPU.

Rows 12-13 of the kernel table: ``fused_layer_norm`` (the plain version
that the port's CUDA kernels are held to on the card) against
``speechain_tpu/ops/pallas_layernorm.py::fused_layer_norm`` run in Pallas
interpret mode, forward and VJP, at leading shapes whose row count is and
is not a multiple of the Pallas kernel's 512-row block, at D = 128 and
256. Then the route itself: the environment switch, and the ``LayerNorm``
module's routing predicate, which must be the JAX module's gate (rows a
multiple of 8, width a multiple of 128).

Inputs are seeded numpy arrays. Tolerance: 1e-5 of each array's largest
magnitude (float32, the same rounding points, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops.pallas_layernorm import fused_layer_norm as jfln
from speechain_tpu_torch.ops import cuda_layernorm
from speechain_tpu_torch.ops.cuda_layernorm import fused_layer_norm

ENV = ("SPEECHAIN_FORCE_FUSED_LN", "SPEECHAIN_DISABLE_PALLAS")


def close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (what, err)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (3 * rng.standard_normal(shape) + 1).astype(np.float32)
    scale = (1 + 0.5 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("shape", [(2, 256, 128), (3, 100, 128),
                                   (1024, 256), (5, 37, 256)])
def test_fused_layer_norm_and_vjp_match_pallas(shape):
    """N = 512 and 1024 fill the Pallas kernel's 512-row blocks; N = 300
    and 185 do not (the kernel falls back to smaller or whole blocks)."""
    x, scale, bias, g = _inputs(shape, seed=sum(shape))
    J = jnp.asarray
    want, vjp = jax.vjp(lambda a, s, b: jfln(a, s, b, 1e-6), J(x), J(scale),
                        J(bias))
    wdx, wds, wdb = vjp(J(g))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias))
    got = fused_layer_norm(tx, ts, tb, 1e-6)
    assert got.dtype == torch.float32 and got.shape == shape
    close(got, want, "y")
    got.backward(torch.from_numpy(g))
    close(tx.grad, wdx, "dx")
    close(ts.grad, wds, "dscale")
    close(tb.grad, wdb, "dbias")


@pytest.mark.parametrize("env", [{}, {"SPEECHAIN_FORCE_FUSED_LN": "1"},
                                 {"SPEECHAIN_DISABLE_PALLAS": "1"},
                                 {"SPEECHAIN_FORCE_FUSED_LN": "1",
                                  "SPEECHAIN_DISABLE_PALLAS": "1"}])
def test_fused_ln_switch_matches_jax(env, monkeypatch):
    from speechain_tpu.ops.pallas_layernorm import fused_ln_enabled
    from speechain_tpu_torch.nn.norms import LayerNorm
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert cuda_layernorm.fused_ln_enabled() == fused_ln_enabled()
    assert LayerNorm(128).fused == fused_ln_enabled()
    assert LayerNorm(128, fused=True).fused
    assert not LayerNorm(128, fused=False).fused


ROUTING_SHAPES = [(8, 128), (7, 128), (2, 4, 256), (3, 5, 256), (8, 64),
                  (8, 192), (4, 2, 384), (1, 24, 128), (3, 199, 256)]


@pytest.mark.parametrize("shape", ROUTING_SHAPES)
def test_layernorm_routing_is_the_jax_gate(shape, monkeypatch):
    """With the route on, the port's LayerNorm calls the kernel wrapper
    exactly where the JAX module calls its Pallas kernel, and both give
    the same values either way."""
    import speechain_tpu.nn.norms as jnorms
    import speechain_tpu_torch.nn.norms as tnorms
    monkeypatch.setenv("SPEECHAIN_FORCE_FUSED_LN", "1")
    monkeypatch.delenv("SPEECHAIN_DISABLE_PALLAS", raising=False)
    calls = {"jax": 0, "port": 0}

    def spy(side, fn):
        def f(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(jnorms, "fused_layer_norm",
                        spy("jax", jnorms.fused_layer_norm))
    monkeypatch.setattr(tnorms, "fused_layer_norm",
                        spy("port", tnorms.fused_layer_norm))
    x, scale, bias, _ = _inputs(shape, seed=7)
    jmod = jnorms.LayerNorm(epsilon=1e-6)
    want = jmod.apply({"params": {"scale": jnp.asarray(scale),
                                  "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    tmod = tnorms.LayerNorm(shape[-1])
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(scale))
        tmod.bias.copy_(torch.from_numpy(bias))
    got = tmod(torch.from_numpy(x))
    n = int(np.prod(shape[:-1]))
    gate = n % 8 == 0 and shape[-1] % 128 == 0
    assert tmod.takes_kernel(torch.from_numpy(x)) == gate
    assert calls == {"jax": int(gate), "port": int(gate)}
    close(got, want)


def test_layernorm_takes_no_kernel_when_off(monkeypatch):
    from speechain_tpu_torch.nn.norms import LayerNorm
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    x = torch.zeros(8, 128)
    assert not LayerNorm(128).takes_kernel(x)
    assert LayerNorm(128, fused=True).takes_kernel(x)
