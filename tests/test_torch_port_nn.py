"""The PyTorch port's modules against the JAX package's, on the CPU.

Each flax module's variable shapes come from ``jax.eval_shape`` of its
init; seeded numpy values fill them and are bridged with
``from_flax_variables`` into the port's module
(``load_state_dict(strict=True)``), and both run on the same numpy inputs
in float32, evaluation mode. Modules whose JAX side has a Pallas kernel
are also compared with that kernel in interpret mode (forced through the
JAX package's own switches).

Tolerances: 1e-5 absolute for single layers (LayerNorm, FFN, attention,
conv module, prenets, one conformer layer); 1e-4 relative to max|x| for
stacks (the encoder, the decoder's steps), where float32 rounding
accumulates over layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu_torch.utils.weights import from_flax_variables

KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def randomize(variables, seed=0):
    """Seeded numpy values for every leaf of a variables tree (arrays or
    shapes from ``jax.eval_shape``): kernels ~ N(0, 1/fan_in), scales
    near 1, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key) if hasattr(path[-1], "key") else str(
            path[-1])
        shape = x.shape
        if name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("kernel", "embedding"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else 1
            v = rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))
        else:
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def bridge(tmod, variables):
    tmod.load_state_dict(from_flax_variables(variables), strict=True)
    return tmod.eval()


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def close_rel(got, want, rel=1e-4):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ----------------------------------------------------------- small pieces

def test_masks_match_jax():
    from speechain_tpu.utils import masks as jm
    from speechain_tpu_torch.utils import masks as tm
    lens = np.array([3, 0, 5], np.int32)
    np.testing.assert_array_equal(
        tm.make_mask_from_len(_t(lens), 6).numpy(),
        np.asarray(jm.make_mask_from_len(jnp.asarray(lens), 6)))
    np.testing.assert_array_equal(tm.subsequent_mask(4).numpy(),
                                  np.asarray(jm.subsequent_mask(4)))
    a = tm.make_mask_from_len(_t(lens), 4)
    np.testing.assert_array_equal(
        tm.combine_masks(a, None, tm.subsequent_mask(4)).numpy(),
        np.asarray(jm.combine_masks(jnp.asarray(a.numpy()), None,
                                    jm.subsequent_mask(4))))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tm.mask_to_bias(a, dt).float().numpy(),
            np.asarray(jm.mask_to_bias(jnp.asarray(a.numpy()), jdt),
                       np.float32))


def test_layernorm_matches_jax():
    from speechain_tpu.nn.norms import LayerNorm as JLN
    from speechain_tpu_torch.nn.norms import LayerNorm
    x = np.random.default_rng(0).standard_normal((3, 5, 48)).astype(
        np.float32) * 3 + 1
    v = randomize(jax.eval_shape(JLN().init, KEY, jnp.asarray(x)))
    close(bridge(LayerNorm(48), v)(_t(x)), JLN().apply(v, jnp.asarray(x)))


def test_posenc_matches_jax():
    from speechain_tpu.nn.posenc import (PositionalEncoding as JPE,
                                         RelPositionalEncoding as JRPE)
    from speechain_tpu_torch.nn.posenc import (PositionalEncoding,
                                               RelPositionalEncoding)
    x = np.random.default_rng(1).standard_normal((2, 7, 16)).astype(
        np.float32)
    jpe = JPE(d_model=16)
    for offset in (0, 5):
        want = jpe.apply({}, jnp.asarray(x),
                         offset=offset if offset == 0 else jnp.asarray(offset))
        got = PositionalEncoding(16)(_t(x), offset=0 if offset == 0
                                     else torch.tensor(offset))
        close(got, want)
    # per-row decode offsets, embedding LayerNorm and a learned PE scale
    kw = dict(d_model=16, emb_layernorm=True, posenc_scale=True,
              init_alpha=0.7)
    jpe = JPE(**kw)
    offs = np.array([2, 5], np.int32)
    v = randomize(jax.eval_shape(jpe.init, KEY, jnp.asarray(x),
                                 offset=jnp.asarray(offs)))
    want = jpe.apply(v, jnp.asarray(x), offset=jnp.asarray(offs))
    got = bridge(PositionalEncoding(**kw), v)(_t(x), offset=_t(offs))
    close(got, want)
    jx, jp = JRPE(d_model=16).apply({}, jnp.asarray(x))
    tx, tp = RelPositionalEncoding(16)(_t(x))
    close(tx, jx)
    close(tp, jp)


def test_prenets_match_jax():
    from speechain_tpu.nn.prenets import (Conv2dPrenet as JC2,
                                          EmbedPrenet as JEmb)
    from speechain_tpu_torch.nn.prenets import Conv2dPrenet, EmbedPrenet
    kw = dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
              conv_batchnorm=True, conv_activation="LeakyReLU", lnr_dims=32)
    feat = np.random.default_rng(2).standard_normal((2, 23, 16)).astype(
        np.float32)
    feat_len = np.array([23, 15], np.int32)
    jmod = JC2(**kw)
    v = randomize(jax.eval_shape(
        jmod.init, KEY, jnp.asarray(feat), jnp.asarray(feat_len)))
    want, wlen = jmod.apply(v, jnp.asarray(feat), jnp.asarray(feat_len))
    got, glen = bridge(Conv2dPrenet(16, **kw), v)(_t(feat), _t(feat_len))
    close(got, want)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))

    text = np.array([[3, 0, 5], [1, 2, 0]], np.int32)
    jemb = JEmb(vocab_size=7, embedding_dim=8, scale=True)
    v = randomize(jax.eval_shape(jemb.init, KEY, jnp.asarray(text)))
    close(bridge(EmbedPrenet(7, 8, scale=True), v)(_t(text)),
          jemb.apply(v, jnp.asarray(text)))


# -------------------------------------------------- kernel-bearing modules

@pytest.mark.parametrize("pallas", [False, True])
def test_ffn_module_matches_jax(pallas, monkeypatch):
    from speechain_tpu.nn.feed_forward import PositionwiseFeedForward as JFF
    from speechain_tpu_torch.nn.feed_forward import PositionwiseFeedForward
    if pallas:
        monkeypatch.setenv("SPEECHAIN_FORCE_FUSED_FFN", "1")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    res = rng.standard_normal((2, 8, 128)).astype(np.float32)
    jmod = JFF(d_model=128, fdfwd_dim=256, fdfwd_activation="GELU",
               dropout=0.0)
    v = randomize(jax.eval_shape(jmod.init, KEY, jnp.asarray(x)))
    want = jmod.apply(v, jnp.asarray(x), residual=jnp.asarray(res),
                      res_scale=0.5)
    tmod = bridge(PositionwiseFeedForward(128, 256,
                                          fdfwd_activation="GELU"), v)
    close(tmod(_t(x), residual=_t(res), res_scale=0.5), want)


@pytest.mark.parametrize("pallas", [False, True])
def test_relpos_mha_module_matches_jax(pallas, monkeypatch):
    from speechain_tpu.nn.attention import RelPosMultiHeadedAttention as JR
    from speechain_tpu_torch.nn.attention import RelPosMultiHeadedAttention
    if pallas:
        monkeypatch.setenv("SPEECHAIN_FORCE_FLASH_ATT", "1")
    B, T, D, H = 2, 11, 128, 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pe = rng.standard_normal((1, 2 * T - 1, D)).astype(np.float32)
    mask = np.ones((B, 1, T), bool)
    mask[1, 0, 6:] = False
    jmod = JR(d_model=D, num_heads=H, dropout=0.0)
    J = jnp.asarray
    v = randomize(jax.eval_shape(
        jmod.init, KEY, J(x), J(x), J(x), J(mask), J(pe)))
    want, _ = jmod.apply(v, J(x), J(x), J(x), J(mask), J(pe),
                         return_attmat=False)
    got = bridge(RelPosMultiHeadedAttention(D, H), v)(_t(x), _t(mask),
                                                       _t(pe))
    close(got, want)


def test_mha_plain_causal_and_fully_masked_row():
    from speechain_tpu.nn.attention import MultiHeadedAttention as JM
    from speechain_tpu_torch.nn.attention import MultiHeadedAttention
    B, Tq, Tk, D = 2, 3, 6, 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Tq, D)).astype(np.float32)
    kv = rng.standard_normal((B, Tk, D)).astype(np.float32)
    mask = np.ones((B, 1, Tk), bool)
    mask[1] = False                                  # zero-length row
    jmod = JM(d_model=D, num_heads=4, dropout=0.0)
    J = jnp.asarray
    v = randomize(jax.eval_shape(jmod.init, KEY, J(q), J(kv), J(kv), J(mask)))
    want, wat = jmod.apply(v, J(q), J(kv), J(kv), J(mask))
    got, gat = bridge(MultiHeadedAttention(D, 4), v)(_t(q), _t(kv), _t(kv),
                                                      _t(mask))
    assert torch.isfinite(got).all()
    close(got, want)
    close(gat, wat)
    # causal self-attention over a length mask
    smask = np.ones((B, 1, Tk), bool)
    smask[0, 0, 4:] = False
    want, _ = jmod.apply(v, J(kv), J(kv), J(kv), J(smask), causal=True)
    got, _ = bridge(MultiHeadedAttention(D, 4), v)(
        _t(kv), _t(kv), _t(kv), _t(smask), causal=True)
    close(got, want)


@pytest.mark.parametrize("pallas", [False, True])
def test_conv_module_matches_jax(pallas, monkeypatch):
    from speechain_tpu.nn.conformer import ConvolutionModule as JCM
    from speechain_tpu_torch.nn.conformer import ConvolutionModule
    if pallas:
        monkeypatch.setenv("SPEECHAIN_FORCE_FUSED_CONVMOD", "1")
    B, T, C, K = 2, 17, 128, 7
    x = np.random.default_rng(6).standard_normal((B, T, C)).astype(
        np.float32)
    x[1, 11:] = 0.0
    jmod = JCM(channels=C, depthwise_kernel_size=K)
    v = randomize(jax.eval_shape(jmod.init, KEY, jnp.asarray(x)))
    want = jmod.apply(v, jnp.asarray(x), train=False)
    close(bridge(ConvolutionModule(C, K), v)(_t(x)), want)


# ------------------------------------------------------------------ stacks

@pytest.mark.parametrize("ln_first", [True, False])
def test_conformer_layer_matches_jax(ln_first):
    from speechain_tpu.nn.conformer import ConformerEncoderLayer as JL
    from speechain_tpu_torch.nn.conformer import ConformerEncoderLayer
    B, T, D, H, K, FF = 2, 13, 32, 4, 5, 64
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pe = rng.standard_normal((1, 2 * T - 1, D)).astype(np.float32)
    mask = np.ones((B, 1, T), bool)
    mask[1, 0, 9:] = False
    kw = dict(d_model=D, num_heads=H, depthwise_kernel_size=K, fdfwd_dim=FF,
              fdfwd_activation="GELU", layernorm_first=ln_first)
    jmod = JL(att_dropout=0.0, fdfwd_dropout=0.0, res_dropout=0.0, **kw)
    J = jnp.asarray
    v = randomize(jax.eval_shape(jmod.init, KEY, J(x), J(mask), J(pe)))
    want, _ = jax.jit(lambda *a: jmod.apply(*a, return_attmat=False))(
        v, J(x), J(mask), J(pe))
    got = bridge(ConformerEncoderLayer(**kw), v)(_t(x), _t(mask), _t(pe))
    close(got, want)


def test_conformer_encoder_matches_jax():
    from speechain_tpu.nn.conformer import ConformerEncoder as JE
    from speechain_tpu_torch.nn.conformer import ConformerEncoder
    B, T, D = 2, 19, 32
    x = np.random.default_rng(8).standard_normal((B, T, D)).astype(
        np.float32)
    mask = np.ones((B, 1, T), bool)
    mask[0, 0, 12:] = False
    kw = dict(d_model=D, num_heads=4, num_layers=2, depthwise_kernel_size=7,
              fdfwd_dim=64, fdfwd_activation="GELU")
    jmod = JE(att_dropout=0.0, posenc_dropout=0.0, fdfwd_dropout=0.0,
              res_dropout=0.0, **kw)
    v = randomize(jax.eval_shape(
        jmod.init, KEY, jnp.asarray(x), jnp.asarray(mask)))
    want = jax.jit(lambda *a: jmod.apply(*a)[0])(v, jnp.asarray(x),
                                                 jnp.asarray(mask))
    got, _ = bridge(ConformerEncoder(**kw), v)(_t(x), _t(mask))
    close_rel(got, want)


def test_decoder_prime_and_steps_match_jax():
    from speechain_tpu.nn.transformer import TransformerDecoder as JD
    from speechain_tpu_torch.nn.transformer import TransformerDecoder
    B, Te, D, cap = 3, 9, 32, 6
    rng = np.random.default_rng(9)
    enc = rng.standard_normal((B, Te, D)).astype(np.float32)
    mask = np.ones((B, 1, Te), bool)
    mask[2, 0, 4:] = False
    embs = rng.standard_normal((cap - 1, B, 1, D)).astype(np.float32)
    kw = dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
              fdfwd_activation="GELU")
    jmod = JD(att_dropout=0.0, posenc_dropout=0.0, fdfwd_dropout=0.0,
              res_dropout=0.0, **kw)
    J = jnp.asarray
    v = randomize(jax.eval_shape(
        jmod.init, KEY, J(embs[0]), J(enc), None, J(mask)))
    _, primed = jax.jit(lambda e: jmod.apply(
        v, e, J(enc), None, J(mask), decode=True, prime=True,
        cache_capacity=cap, mutable=["cache"]))(J(embs[0]))
    jcache = primed["cache"]
    tmod = bridge(TransformerDecoder(**kw), v)
    tcache = tmod.prime(_t(enc), cap)
    jstep = jax.jit(lambda c, e: jmod.apply(
        {**v, "cache": c}, e, J(enc), None, J(mask), decode=True,
        mutable=["cache"]))
    for step in range(cap - 1):
        (want, *_), upd = jstep(jcache, J(embs[step]))
        jcache = upd["cache"]
        got = tmod.decode_step(_t(embs[step]), tcache, _t(mask))
        close_rel(got, want)
    assert tcache.position == cap - 1
