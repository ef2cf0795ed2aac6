"""The port's conformer training operators and modules against the JAX
package, on the CPU.

The rel-pos attention and conv-module kernel wrappers take their plain
PyTorch versions for a CPU tensor; their forward and gradients (autograd)
are held against the JAX kernels they replace (``flash_relpos_attention``
and ``fused_conv_glu_dw``) in Pallas interpret mode, rel-pos attention at
dropout 0 and 0.1 (the port draws the masks with the JAX kernels'
interpret-mode mixer and indexing, so they agree bit for bit). The
modules (``BatchNorm.from_moments``, ``ConvolutionModule``,
``ConformerEncoderLayer``) run in training mode at dropout 0 against the
JAX modules with their Pallas paths forced into interpret mode, weights
bridged with ``from_flax_variables``; inputs and cotangents are seeded
numpy arrays.

Tolerances: 1e-5 of the largest magnitude of each compared array
(float32, same rounding points, different summation order); for a
module's parameter gradients, 1e-5 of the largest entry of all of them
together (some, such as the key bias's, are zero up to rounding); dropout
masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops.pallas_attention import (_dropout_mask,
                                                flash_relpos_attention)
from speechain_tpu.ops.pallas_convmod import fused_conv_glu_dw
from speechain_tpu_torch.ops import dropout as tdrop
from speechain_tpu_torch.ops.cuda_attention import (cuda_relpos_attention,
                                                    relpos_smem_bytes)
from speechain_tpu_torch.ops.cuda_build import SMEM_LIMIT
from speechain_tpu_torch.ops.cuda_convmod import cuda_conv_glu_dw
from speechain_tpu_torch.utils.weights import from_flax_variables

KEY = jax.random.PRNGKey(0)
J = jnp.asarray
REL = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def close_rel(got, want, rel=REL, what="", scale=None):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() if scale is None else scale
    assert err <= rel * scale, (what, err, scale)


def randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            v = rng.standard_normal(x.shape) / np.sqrt(max(fan_in, 1))
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map(
        jnp.asarray, jax.tree_util.tree_map_with_path(leaf, variables))


def check_param_grads(tmod, jgrads):
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    got = dict(tmod.named_parameters())
    assert sorted(want) == sorted(got)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        close_rel(got[name].grad, w.numpy(), what=name, scale=scale)


def check_batch_stats(tmod, jstats):
    want = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jstats)})
    assert want
    sd = tmod.state_dict()
    for name, w in want.items():
        close_rel(sd[name], w.numpy(), what=name)


# ------------------------------------------------------ rel-pos attention

RELPOS_CASES = {
    # name: (T, key lengths or None)
    "ragged_T24": (24, [24, 17]),
    "empty_row_T13": (13, [13, 0]),
    "no_mask_T9": (9, None),
}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(RELPOS_CASES))
def test_relpos_fwd_and_vjp_match_pallas(case, rate):
    """Forward and all six cotangents (dq, dk, dv, dph, dbu, dbv)."""
    T, lens = RELPOS_CASES[case]
    B, D, H = 2, 128, 2
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((B, T, D)).astype(np.float32)
                  for _ in range(4))
    ph = rng.standard_normal((2 * T - 1, D)).astype(np.float32)
    bu, bv = (0.3 * rng.standard_normal(D)).astype(np.float32), \
        (0.3 * rng.standard_normal(D)).astype(np.float32)
    km = None if lens is None else (
        np.arange(T)[None] < np.array(lens)[:, None]).astype(np.int32)
    seed, scale = -123457, D ** -0.5

    def jf(q, k, v, ph, bu, bv):
        return flash_relpos_attention(
            q, k, v, ph, bu.reshape(1, D), bv.reshape(1, D),
            jnp.array([seed], jnp.int32), scale, H, rate,
            None if km is None else J(km))

    want, vjp = jax.vjp(jf, J(q), J(k), J(v), J(ph), J(bu), J(bv))
    wgrads = vjp(J(g))
    ins = [_t(a, True) for a in (q, k, v, ph, bu, bv)]
    got = cuda_relpos_attention(*ins, scale, H,
                                None if km is None else _t(km), rate, seed)
    assert torch.isfinite(got).all()
    close_rel(got, want, what="out")
    (got * _t(g)).sum().backward()
    for name, a, w in zip(("dq", "dk", "dv", "dph", "dbu", "dbv"), ins,
                          wgrads):
        close_rel(a.grad, np.asarray(w).reshape(a.shape), what=name)


def test_relpos_dropout_masks_are_the_kernels():
    """The port's attention mask for (b, h) is the JAX kernel's
    interpret-mode mask of stream seed + b * H + h, bit for bit."""
    B, H, T, rate, seed = 3, 4, 13, 0.1, 2 ** 31 - 5
    got = tdrop.attention_mask(B, H, T, T, rate, seed).numpy()
    for b in range(B):
        for h in range(H):
            stream = (seed + b * H + h + 2 ** 31) % 2 ** 32 - 2 ** 31
            want = _dropout_mask((T, T), rate, jnp.int32(stream))
            np.testing.assert_array_equal(got[b, h], np.asarray(want))


def test_relpos_shared_memory_does_not_grow_with_t():
    """The kernels stream their tiles: every T up to 2000 fits a block's
    shared memory, in both compute dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        sizes = {relpos_smem_bytes(T, dtype) for T in range(1, 2001)}
        assert len(sizes) == 1 and max(sizes) <= SMEM_LIMIT, sizes


# ------------------------------------------------------------- conv module

@pytest.mark.parametrize("T,K", [(24, 31), (13, 31), (20, 7)])
def test_convmod_fwd_and_vjp_match_pallas(T, K):
    """u, s, ss and the gradients of x, W1, b1, the depthwise kernel and
    bias, with cotangents on all three outputs (the statistics' enter the
    kernel's du_tot); T = 13 is not a multiple of 8, T = 13 and 24 are
    shorter than the depthwise halo."""
    B, C = 2, 128
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    x[1, T - 5:] = 0.0                              # padded frames
    w1 = (rng.standard_normal((C, 2 * C)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
    dwk = (rng.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    dwb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    gu = rng.standard_normal((B, T, C)).astype(np.float32)
    gs, gss = (0.1 * rng.standard_normal((2, C))).astype(np.float32)

    (ju, js, jss), vjp = jax.vjp(
        lambda *a: fused_conv_glu_dw(*a, K), J(x), J(w1), J(b1), J(dwk),
        J(dwb))
    jdx, jdw1, jdb1, jddwk, jddwb = vjp((J(gu), J(gs), J(gss)))
    tx, tw1, tb1 = _t(x, True), _t(w1.T, True), _t(b1, True)
    tdwk, tdwb = _t(dwk.T[:, None, :], True), _t(dwb, True)
    u, s, ss = cuda_conv_glu_dw(tx, tw1, tb1, tdwk, tdwb)
    close_rel(u, ju, what="u")
    close_rel(s, js, what="s")
    close_rel(ss, jss, what="ss")
    ((u * _t(gu)).sum() + (s * _t(gs)).sum() + (ss * _t(gss)).sum()
     ).backward()
    close_rel(tx.grad, jdx, what="dx")
    close_rel(tw1.grad, np.asarray(jdw1).T, what="dW1")
    close_rel(tb1.grad, jdb1, what="db1")
    close_rel(tdwk.grad, np.asarray(jddwk).T[:, None, :], what="ddwk")
    close_rel(tdwb.grad, jddwb, what="ddwb")


# ----------------------------------------------------------------- modules

def test_batchnorm_from_moments_matches_bnapply():
    """BatchNorm from precomputed moments (the conv module's) against the
    JAX package's ``_BNApply``: output, running statistics and the
    gradients of u, both moments and the affine parameters."""
    from speechain_tpu.nn.conformer import _BNApply
    from speechain_tpu_torch.nn.norms import BatchNorm
    rng = np.random.default_rng(9)
    C = 16
    u = (rng.standard_normal((3, 7, C)) * 2 + 0.5).astype(np.float32)
    mean = u.mean((0, 1))
    mean2 = (u * u).mean((0, 1))
    mean2[0] = mean[0] ** 2 - 1e-3               # clamped variance
    g = rng.standard_normal(u.shape).astype(np.float32)
    jmod = _BNApply(channels=C)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(u), J(mean), J(mean2)))

    def f(params, u, m, m2):
        out, mut = jmod.apply({**v, "params": params}, u, m, m2, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * J(g)), (out, mut)

    (_, (want, mut)), (gp, gu, gm, gm2) = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True)(v["params"], J(u), J(mean),
                                               J(mean2))
    tmod = BatchNorm(C)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tu, tm, tm2 = _t(u, True), _t(mean, True), _t(mean2, True)
    got = tmod.train().from_moments(tu, tm, tm2, 1)
    close_rel(got, want)
    close_rel(tmod.running_mean, mut["batch_stats"]["mean"])
    close_rel(tmod.running_var, mut["batch_stats"]["var"])
    (got * _t(g)).sum().backward()
    close_rel(tu.grad, gu, what="du")
    close_rel(tm.grad, gm, what="dmean")
    close_rel(tm2.grad, gm2, what="dmean2")
    check_param_grads(tmod, gp)


@pytest.mark.parametrize("pallas", [True, False])
def test_convolution_module_train_matches_jax(pallas, monkeypatch):
    """The JAX module's fused path (Pallas kernel in interpret mode and
    ``_BNApply``) and its XLA path (flax BatchNorm) both against the
    port's training path: output, gradients and the batch_stats update."""
    from speechain_tpu.nn.conformer import ConvolutionModule as JCM
    from speechain_tpu_torch.nn.conformer import ConvolutionModule
    if pallas:
        monkeypatch.setenv("SPEECHAIN_FORCE_FUSED_CONVMOD", "1")
    B, T, C, K = 2, 19, 128, 31
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    jmod = JCM(channels=C, depthwise_kernel_size=K)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(x)))

    def f(params, x):
        out, mut = jmod.apply({**v, "params": params}, x, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * J(g)), (out, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], J(x))
    tmod = ConvolutionModule(C, K)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx = _t(x, True)
    got = tmod.train()(tx)
    close_rel(got, want)
    check_batch_stats(tmod, mut["batch_stats"])
    (got * _t(g)).sum().backward()
    close_rel(tx.grad, gx, what="dx")
    check_param_grads(tmod, gp)


@pytest.mark.parametrize("ln_first", [True, False])
def test_conformer_layer_train_matches_jax(ln_first, monkeypatch):
    """A whole conformer layer in training mode (dropout 0) with every
    Pallas path of the JAX package forced into interpret mode: output,
    gradients of the input, the positional encoding and every parameter,
    and the conv module's batch_stats update."""
    from speechain_tpu.nn.conformer import ConformerEncoderLayer as JL
    from speechain_tpu_torch.nn.conformer import ConformerEncoderLayer
    for var in ("SPEECHAIN_FORCE_FLASH_ATT", "SPEECHAIN_FORCE_FUSED_CONVMOD",
                "SPEECHAIN_FORCE_FUSED_FFN"):
        monkeypatch.setenv(var, "1")
    B, T, D, H, F, K = 2, 24, 128, 2, 256, 31
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pos = rng.standard_normal((1, 2 * T - 1, D)).astype(np.float32)
    mask = (np.arange(T)[None, None] < np.array([24, 15])[:, None, None])
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    kw = dict(d_model=D, num_heads=H, att_dropout=0.0,
              depthwise_kernel_size=K, fdfwd_dim=F, fdfwd_activation="GELU",
              fdfwd_dropout=0.0, res_dropout=0.0, layernorm_first=ln_first)
    jmod = JL(**kw)
    v = randomize(jax.eval_shape(
        lambda: jmod.init(KEY, J(x), J(mask), J(pos), return_attmat=False)))

    def f(params, x, pos):
        (out, _), mut = jmod.apply(
            {**v, "params": params}, x, J(mask), pos, train=True,
            return_attmat=False, mutable=["batch_stats"])
        return jnp.sum(out * J(g)), (out, mut)

    (_, (want, mut)), (gp, gx, gpos) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(v["params"], J(x), J(pos))
    tmod = ConformerEncoderLayer(**kw)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx, tpos = _t(x, True), _t(pos, True)
    got = tmod.train()(tx, _t(mask), tpos)
    close_rel(got, want)
    check_batch_stats(tmod, mut["batch_stats"])
    (got * _t(g)).sum().backward()
    close_rel(tx.grad, gx, what="dx")
    close_rel(tpos.grad, gpos, what="dpos")
    check_param_grads(tmod, gp)


def _next_draw(gen: torch.Generator) -> int:
    return int(torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen))


def _draw_after(gen_seed: int, n: int) -> int:
    """The draw that follows n draws of a fresh generator."""
    g = torch.Generator().manual_seed(gen_seed)
    for _ in range(n):
        _next_draw(g)
    return _next_draw(g)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_conformer_encoder_draws_every_dropout_seed(rate):
    """In training the encoder draws one seed per dropout site from the
    step's generator: 2 for the positional encoding (x and pos_emb), and
    per layer 2 + 2 for the macaron FFNs (inner and residual), 1 for the
    attention kernel and 2 for the residual dropouts of attention and
    conv module; none at rate 0 or in evaluation."""
    from speechain_tpu_torch.nn.conformer import ConformerEncoder
    B, T, D, layers = 2, 10, 128, 2
    enc = ConformerEncoder(
        d_model=D, num_heads=2, num_layers=layers, fdfwd_dim=256,
        depthwise_kernel_size=7, fdfwd_activation="GELU", att_dropout=rate,
        posenc_dropout=rate, fdfwd_dropout=rate, res_dropout=rate)
    x = torch.randn(B, T, D)
    mask = torch.ones(B, 1, T, dtype=torch.bool)
    gen = torch.Generator().manual_seed(5)
    with tdrop.step_rng(gen):
        out, _ = enc.train()(x, mask)
    n = (2 + 7 * layers) if rate > 0 else 0
    assert _next_draw(gen) == _draw_after(5, n)
    assert torch.isfinite(out).all()
    with torch.no_grad():                  # no step_rng: a draw would raise
        ev, _ = enc.eval()(x, mask)
    if rate > 0:
        assert not torch.allclose(out, ev)
