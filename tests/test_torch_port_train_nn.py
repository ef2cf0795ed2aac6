"""The PyTorch port's modules in training mode against the JAX package's,
on the CPU: outputs, gradients of every parameter and input, and the
updated running statistics.

Flax variable shapes come from ``jax.eval_shape``; seeded numpy values
fill them and are bridged into the port (``from_flax_variables``). Both
run in float32 at dropout 0 (so the flax and port dropout realizations do
not enter). Attention modules are also held against the JAX package's
flash-attention kernel (forced into Pallas interpret mode), whose
gradient the port's kernel follows. The gradient cotangent is a seeded
numpy array; JAX parameter gradients are bridged with the same layout
map as the weights.

Tolerances: 1e-4 relative to the largest magnitude of each compared
output, input gradient or running statistic, and of all the module's
parameter gradients together (float32 summation order over a few
layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu_torch.utils.weights import from_flax_variables

KEY = jax.random.PRNGKey(0)
J = jnp.asarray


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name in ("kernel", "embedding"):
            fan_in = int(np.prod(x.shape[:-1])) if name == "kernel" else 1
            v = rng.standard_normal(x.shape) / np.sqrt(max(fan_in, 1))
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map(
        jnp.asarray, jax.tree_util.tree_map_with_path(leaf, variables))


def close_rel(got, want, rel=1e-4, what="", scale=None):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() if scale is None else scale
    assert err <= rel * scale, (what, err, scale)


def check_param_grads(tmod, jgrads):
    """Every parameter gradient of the port against JAX's, bridged, within
    1e-4 of the largest gradient entry of the module (some gradients, such
    as the key bias's, are zero up to rounding)."""
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    got = dict(tmod.named_parameters())
    assert sorted(want) == sorted(got)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        close_rel(got[name].grad, w.numpy(), what=name, scale=scale)


# -------------------------------------------------------------- attention

@pytest.mark.parametrize("mode", ["causal_self", "cross"])
def test_mha_flash_path_train_matches_jax(mode, monkeypatch):
    from speechain_tpu.nn.attention import MultiHeadedAttention as JM
    from speechain_tpu_torch.nn.attention import MultiHeadedAttention
    monkeypatch.setenv("SPEECHAIN_FORCE_FLASH_ATT", "1")
    B, Tq, D, H = 2, 6, 32, 4
    Tk = Tq if mode == "causal_self" else 9
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Tq, D)).astype(np.float32)
    kv = q if mode == "causal_self" else rng.standard_normal(
        (B, Tk, D)).astype(np.float32)
    mask = np.ones((B, 1, Tk), bool)
    mask[1, 0, (0 if mode == "causal_self" else 5):] = False
    g = rng.standard_normal((B, Tq, D)).astype(np.float32)
    causal = mode == "causal_self"
    jmod = JM(d_model=D, num_heads=H, dropout=0.0)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(q), J(kv), J(kv),
                                 J(mask)))

    def f(params, q, kv):
        out, _ = jmod.apply({"params": params}, q, kv, kv, J(mask),
                            train=True, return_attmat=False, causal=causal)
        return jnp.sum(out * J(g)), out

    (_, want), (gp, gq, gkv) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(v["params"], J(q), J(kv))
    tmod = MultiHeadedAttention(D, H, dropout=0.0)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tq = _t(q, True)
    tkv = tq if causal else _t(kv, True)
    got, att = tmod.train()(tq, tkv, tkv, _t(mask), causal=causal,
                            return_attmat=False)
    assert att is None
    close_rel(got, want)
    (got * _t(g)).sum().backward()
    if causal:
        close_rel(tq.grad, np.asarray(gq) + np.asarray(gkv))
    else:
        close_rel(tq.grad, gq)
        close_rel(tkv.grad, gkv)
    check_param_grads(tmod, gp)


# ----------------------------------------------------------------- stacks

def _stack_grads(jmod, v, args, g, apply_kw):
    def f(params, x):
        out = jmod.apply({**v, "params": params}, x, *args, **apply_kw)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * J(g)), out

    return jax.jit(lambda p, x: jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(p, x))


@pytest.mark.parametrize("ln_first", [True, False])
def test_transformer_encoder_train_matches_jax(ln_first):
    from speechain_tpu.nn.transformer import TransformerEncoder as JE
    from speechain_tpu_torch.nn.transformer import TransformerEncoder
    B, T, D = 2, 13, 32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, 1, T), bool)
    mask[1, 0, 8:] = False
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    kw = dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
              fdfwd_activation="GELU", att_dropout=0.0, posenc_dropout=0.0,
              fdfwd_dropout=0.0, res_dropout=0.0, layernorm_first=ln_first)
    jmod = JE(**kw)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(x), J(mask)))
    (_, want), (gp, gx) = _stack_grads(jmod, v, [J(mask)], g,
                                       dict(train=True))(v["params"], J(x))
    tmod = TransformerEncoder(**kw)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx = _t(x, True)
    got, _ = tmod.train()(tx, _t(mask))
    close_rel(got, want)
    (got * _t(g)).sum().backward()
    close_rel(tx.grad, gx)
    check_param_grads(tmod, gp)


def test_decoder_teacher_forcing_train_matches_jax(monkeypatch):
    from speechain_tpu.nn.transformer import TransformerDecoder as JD
    from speechain_tpu_torch.nn.transformer import TransformerDecoder
    monkeypatch.setenv("SPEECHAIN_FORCE_FLASH_ATT", "1")
    B, L, Te, D = 3, 7, 9, 32
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((B, L, D)).astype(np.float32)
    enc = rng.standard_normal((B, Te, D)).astype(np.float32)
    tmask = np.arange(L)[None, None] < np.array([7, 4, 0])[:, None, None]
    smask = np.arange(Te)[None, None] < np.array([9, 6, 3])[:, None, None]
    g = rng.standard_normal((B, L, D)).astype(np.float32)
    kw = dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
              fdfwd_activation="GELU", att_dropout=0.0, posenc_dropout=0.0,
              fdfwd_dropout=0.0, res_dropout=0.0, emb_layernorm=True,
              emb_scale=False)
    jmod = JD(**kw)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(emb), J(enc), J(tmask),
                                 J(smask)))
    (_, want), (gp, gx) = _stack_grads(
        jmod, v, [J(enc), J(tmask), J(smask)], g, dict(train=True))(
        v["params"], J(emb))
    tmod = TransformerDecoder(**kw)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx = _t(emb, True)
    got = tmod.train()(tx, _t(enc), _t(tmask), _t(smask))
    close_rel(got, want)
    (got * _t(g)).sum().backward()
    close_rel(tx.grad, gx)
    check_param_grads(tmod, gp)


# ---------------------------------------------------- BatchNorm and prenet

def test_fast_batchnorm_train_matches_flax():
    from speechain_tpu.nn.norms import FastBatchNorm
    from speechain_tpu_torch.nn.norms import BatchNorm
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 8)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal((3, 5, 8)).astype(np.float32)
    jmod = FastBatchNorm(use_running_average=False)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(x)))

    def f(params, x):
        out, mut = jmod.apply({**v, "params": params}, x,
                              mutable=["batch_stats"])
        return jnp.sum(out * J(g)), (out, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], J(x))
    tmod = BatchNorm(8)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx = _t(x, True)
    got = tmod.train()(tx)
    close_rel(got, want)
    close_rel(tmod.running_mean, mut["batch_stats"]["mean"])
    close_rel(tmod.running_var, mut["batch_stats"]["var"])
    (got * _t(g)).sum().backward()
    close_rel(tx.grad, gx)
    check_param_grads(tmod, gp)


def test_conv2d_prenet_train_matches_jax():
    from speechain_tpu.nn.prenets import Conv2dPrenet as JC2
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet
    kw = dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
              conv_batchnorm=True, conv_activation="LeakyReLU", lnr_dims=32)
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 23, 16)).astype(np.float32)
    flen = np.array([23, 15], np.int32)
    jmod = JC2(**kw)
    v = randomize(jax.eval_shape(jmod.init, KEY, J(feat), J(flen)))
    g = rng.standard_normal((2, 5, 32)).astype(np.float32)

    def f(params, x):
        (out, olen), mut = jmod.apply({**v, "params": params}, x, J(flen),
                                      train=True, mutable=["batch_stats"])
        return jnp.sum(out * J(g)), (out, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], J(feat))
    tmod = Conv2dPrenet(16, **kw)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    tx = _t(feat, True)
    got, glen = tmod.train()(tx, _t(flen))
    close_rel(got, want)
    (got * _t(g)).sum().backward()
    close_rel(tx.grad, gx)
    check_param_grads(tmod, gp)
    stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])})
    for name, w in stats.items():
        close_rel(tmod.state_dict()[name], w.numpy(), what=name)
