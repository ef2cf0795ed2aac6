"""The port's fused Conv2d-prenet routes against the JAX package's, on the
CPU.

Rows 14-15 of the kernel table: ``fused_prenet_core`` (its plain version,
which the port's CUDA kernels are held to on the card) against
``speechain_tpu/ops/pallas_prenet.py::fused_prenet_core`` run in Pallas
interpret mode, forward and the four parameter cotangents, and the
mel's cotangent, which is zero by design on both sides; the XLA core
with its input gradient; ``Conv2dPrenet`` on each route (unfused, "xla",
"fused") in training and evaluation mode against the JAX module with the
reference's environment switch set: values, every parameter gradient, the
input gradient and the BatchNorm running statistics; the gate's refusals;
and the weight bridge for variables initialised under the fused routes.

At (B, T, F) = (3, 37, 21) and C = 128, the reference's test shape
(``tests/test_pallas_prenet.py``). Inputs and weights are seeded numpy
arrays. Tolerance: 1e-5 of each array's largest magnitude (float32, the
same rounding points, sums in another order); parameter gradients of a
module against the largest gradient entry of the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops import pallas_prenet as pk
from speechain_tpu_torch.ops import cuda_prenet
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

B, T, F, C = 3, 37, 21, 128
J = jnp.asarray
KEY = jax.random.PRNGKey(0)
ENV = ("SPEECHAIN_FORCE_FUSED_PRENET", "SPEECHAIN_DISABLE_FUSED_PRENET",
       "SPEECHAIN_DISABLE_PALLAS")
JAX_ENV = {None: {"SPEECHAIN_DISABLE_FUSED_PRENET": "1"},
           "xla": {"SPEECHAIN_FORCE_FUSED_PRENET": "xla"},
           "fused": {"SPEECHAIN_FORCE_FUSED_PRENET": "pallas"}}


def close(got, want, what="", scale=None):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max()) if scale is None else scale
    assert err <= 1e-5 * scale, (what, err, scale)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def _set_env(monkeypatch, env):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)


def _core_inputs(seed=0):
    rng = np.random.default_rng(seed)
    U1, F1, T2, F2 = cuda_prenet.geom(T, F)
    mel = rng.standard_normal((B, T, F)).astype(np.float32)
    w1 = (rng.standard_normal((9, C)) / 3).astype(np.float32)
    g1 = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w2 = (rng.standard_normal((9, C, C)) / np.sqrt(9 * C)).astype(np.float32)
    g = rng.standard_normal((B, T2, F2, C)).astype(np.float32)
    return mel, w1, g1, b1, w2, g


@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
def test_fused_core_and_cotangents_match_pallas(act):
    mel, w1, g1, b1, w2, g = _core_inputs()
    _, _, T2, F2 = cuda_prenet.geom(T, F)
    Vp = F2 + 1

    def jcore(M, w1p, g1_, b1_, w2_):
        out = pk.fused_prenet_core(M, w1p, g1_, b1_, w2_, T2, F2, act)
        return out.reshape(B, T2, Vp, C)[:, :, :F2, :]     # prenets.py:381

    M = pk.build_patches(J(mel), jnp.float32)
    w1p = jnp.pad(J(w1), ((0, 7), (0, 0)))
    want, vjp = jax.vjp(jcore, M, w1p, J(g1), J(b1), J(w2))
    dM, dw1, dg1, db1, dw2 = vjp(J(g))
    assert float(jnp.abs(dM).max()) == 0.0
    tin = [_t(a, True) for a in (mel, w1, g1, b1, w2)]
    got = cuda_prenet.fused_prenet_core(*tin, act)
    assert got.shape == (B, T2, F2, C) and got.dtype == torch.float32
    close(got, want, "out")
    got.backward(_t(g))
    assert torch.count_nonzero(tin[0].grad) == 0
    for t, w, name in zip(tin[1:], (dw1[:9], dg1, db1, dw2),
                          ("dw1", "dg1", "db1", "dw2")):
        close(t.grad, w, name)
    # the plain version itself, without the zero-mel-gradient wrapper
    plain = cuda_prenet.prenet_core_plain(*(t.detach() for t in tin), act)
    close(plain, want, "plain")


def test_xla_core_and_input_gradient_match_jax():
    mel, w1, g1, b1, w2, g = _core_inputs(seed=1)

    def jcore(M, w1_, g1_, b1_, w2_):
        return pk.xla_prenet_core(M, w1_, g1_, b1_,
                                  w2_.reshape(3, 3, C, C), "LeakyReLU")

    M = pk.build_patches_std(J(mel), jnp.float32)
    want, vjp = jax.vjp(jcore, M, J(w1), J(g1), J(b1), J(w2))
    tM = cuda_prenet.build_patches_std(_t(mel)).requires_grad_()
    close(tM, M, "patches")
    tin = [tM] + [_t(a, True) for a in (w1, g1, b1, w2)]
    got = cuda_prenet.xla_prenet_core(*tin, "LeakyReLU")
    close(got, want, "out")
    got.backward(_t(g))
    for t, w, name in zip(tin, vjp(J(g)), ("dM", "dw1", "dg1", "db1",
                                           "dw2")):
        close(t.grad, w, name)
    S, G = cuda_prenet.patch_stats_std(tM.detach())
    jS, jG = pk.patch_stats_std(M)
    close(S, jS, "S")
    close(G, jG, "G")


def _prenet_kw(**over):
    kw = dict(conv_dims=[C, C], conv_kernel=3, conv_stride=2,
              conv_padding=0, conv_batchnorm=True,
              conv_activation="LeakyReLU", lnr_dims=C)
    kw.update(over)
    return kw


def _randomize(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name == "kernel":
            v = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map(
        J, jax.tree_util.tree_map_with_path(leaf, variables))


def _jax_prenet(kw, route, feat, flen, train, monkeypatch):
    """The JAX module's output, running statistics and (in training) the
    gradients of sum(out * g) in its parameters and the input."""
    from speechain_tpu.nn.prenets import Conv2dPrenet as JC2
    _set_env(monkeypatch, JAX_ENV[route])
    jmod = JC2(dtype=jnp.float32, **kw)
    v = _randomize(jax.eval_shape(jmod.init, KEY, J(feat), J(flen)), seed=9)
    rng = np.random.default_rng(10)
    out_shape = jax.eval_shape(lambda: jmod.apply(v, J(feat), J(flen)))[0]
    g = rng.standard_normal(out_shape.shape).astype(np.float32)

    def f(params, x):
        (out, _), mut = jmod.apply({**v, "params": params}, x, J(flen),
                                   train=train, mutable=["batch_stats"])
        return jnp.sum(out * J(g)), (out, mut)

    (_, (out, mut)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], J(feat))
    return v, g, out, mut, gp, gx


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("route", [None, "xla", "fused"])
def test_conv2d_prenet_routes_match_jax(route, train, monkeypatch):
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((B, T, F)).astype(np.float32)
    flen = np.array([T, T - 6, T - 11], np.int32)
    kw = _prenet_kw()
    v, g, want, mut, gp, gx = _jax_prenet(kw, route, feat, flen, train,
                                          monkeypatch)
    _set_env(monkeypatch, {})
    tmod = Conv2dPrenet(F, core=route, **kw)
    assert tmod.fused_route(T, F) == route
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx = _t(feat, True)
    got, glen = tmod.train(train)(tx, _t(flen))
    close(got, want, "out")
    (got * _t(g)).sum().backward()
    if route == "fused":          # zero by design on both sides
        assert float(jnp.abs(gx).max()) == 0.0
        assert torch.count_nonzero(tx.grad) == 0
    else:
        close(tx.grad, gx, "input gradient")
    wgrads = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, gp)})
    named = dict(tmod.named_parameters())
    assert sorted(wgrads) == sorted(named)
    scale = max(float(w.abs().max()) for w in wgrads.values())
    for name, w in wgrads.items():
        close(named[name].grad, w, name, scale=scale)
    stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])})
    for name, w in stats.items():
        close(tmod.state_dict()[name], w, name)
    if train:                      # the statistics moved
        assert not np.allclose(stats["batchnorm_0.running_mean"],
                               np.asarray(v["batch_stats"]["batchnorm_0"]
                                          ["mean"]))


def test_xla_route_input_gradient_matches_unfused():
    """The XLA core's input gradient is exact: it matches the unfused
    route's (the reference's own check, ``tests/test_pallas_prenet.py::
    test_input_grad_equivalence_xla``, with its tolerance, 5e-4 of the
    largest entry: the two routes sum the BatchNorm-1 moments differently)."""
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet
    from speechain_tpu_torch.utils.weights import random_state_dict
    rng = np.random.default_rng(12)
    feat = rng.standard_normal((B, T, F)).astype(np.float32)
    g = None
    grads = {}
    sd = None
    for route in (None, "xla"):
        tmod = Conv2dPrenet(F, core=route, **_prenet_kw())
        sd = random_state_dict(tmod, seed=2) if sd is None else sd
        tmod.load_state_dict(sd)
        tx = _t(feat, True)
        out, _ = tmod.train()(tx, _t(np.full(B, T, np.int32)))
        if g is None:
            g = torch.from_numpy(rng.standard_normal(out.shape).astype(
                np.float32))
        (out * g).sum().backward()
        grads[route] = tx.grad
    err = float((grads["xla"] - grads[None]).abs().max())
    assert err <= 5e-4 * float(grads[None].abs().max()), err


@pytest.mark.parametrize("refusal", [
    dict(conv_dims=[64, 64], lnr_dims=64), dict(conv_dropout=0.1),
    dict(conv_padding=1), dict(T=9)])
def test_gate_refusals_take_the_unfused_route(refusal, monkeypatch):
    """C not a multiple of 128, conv dropout, padding and T2 < 2 keep the
    unfused route in both packages (``_prenet_fused_impl``); evaluation
    values agree."""
    from speechain_tpu.nn.prenets import _prenet_fused_impl
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet
    refusal = dict(refusal)
    Tq = refusal.pop("T", T)
    kw = _prenet_kw(**refusal)
    pad = kw["conv_padding"]
    drops = ([kw["conv_dropout"]] * 2 if kw.get("conv_dropout")
             else [None, None])
    _set_env(monkeypatch, {"SPEECHAIN_FORCE_FUSED_PRENET": "pallas"})
    assert _prenet_fused_impl(kw["conv_dims"], (3, 3), (2, 2), (pad, pad),
                              True, drops, "LeakyReLU", Tq, F) is None
    tmod = Conv2dPrenet(F, **kw)
    assert tmod.core == "fused" and tmod.fused_route(Tq, F) is None
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((B, Tq, F)).astype(np.float32)
    flen = np.full(B, Tq, np.int32)
    v, _, want, _, _, _ = _jax_prenet(kw, "fused", feat, flen, False,
                                      monkeypatch)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    with torch.no_grad():
        got, _ = tmod.eval()(_t(feat), _t(flen))
    close(got, want)


@pytest.mark.parametrize("env,route", [
    ({}, None), ({"SPEECHAIN_FORCE_FUSED_PRENET": "xla"}, "xla"),
    ({"SPEECHAIN_FORCE_FUSED_PRENET": "1"}, "fused"),
    ({"SPEECHAIN_FORCE_FUSED_PRENET": "true"}, "fused"),
    ({"SPEECHAIN_FORCE_FUSED_PRENET": "pallas"}, "fused"),
    ({"SPEECHAIN_FORCE_FUSED_PRENET": "pallas",
      "SPEECHAIN_DISABLE_PALLAS": "1"}, "xla"),
    ({"SPEECHAIN_FORCE_FUSED_PRENET": "xla",
      "SPEECHAIN_DISABLE_FUSED_PRENET": "1"}, None)])
def test_prenet_switch_matches_jax(env, route, monkeypatch):
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet
    _set_env(monkeypatch, env)
    jroute = pk.prenet_core_impl()
    assert {"pallas": "fused"}.get(jroute, jroute) == route
    assert cuda_prenet.prenet_core_impl() == route
    assert Conv2dPrenet(F, **_prenet_kw()).core == route
    assert Conv2dPrenet(F, core=None, **_prenet_kw()).core is None


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_weight_bridge_loads_fused_route_variables(route, monkeypatch):
    """Variables initialised under a fused route have the unfused tree
    (``_Conv2dParams`` and ``_BNAffine`` keep flax's names), so the
    bridge loads them into the port's prenet, strictly, and back."""
    from speechain_tpu.nn.prenets import Conv2dPrenet as JC2
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet
    feat, flen = J(np.zeros((B, T, F), np.float32)), J(np.full(B, T))
    trees = {}
    for r in (None, route):
        _set_env(monkeypatch, JAX_ENV[r])
        trees[r] = JC2(**_prenet_kw()).init(KEY, feat, flen)
    shape = jax.tree_util.tree_map(lambda a: a.shape, trees[route])
    assert shape == jax.tree_util.tree_map(lambda a: a.shape, trees[None])
    v = jax.tree_util.tree_map(np.asarray, trees[route])
    sd = from_flax_variables(v)
    tmod = Conv2dPrenet(F, core=route, **_prenet_kw())
    tmod.load_state_dict(sd, strict=True)
    back = to_flax_variables(tmod.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(v):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
