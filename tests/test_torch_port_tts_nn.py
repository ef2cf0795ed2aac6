"""The PyTorch port's TTS modules against the JAX package's, on the CPU.

Each flax module's variables come from ``jax.eval_shape`` of its init,
filled with seeded numpy values and bridged with ``from_flax_variables``
into the port's module (``load_state_dict(strict=True)``); both run on the
same numpy inputs in float32, evaluation mode. No module here has a
Pallas kernel of its own: the convolutions are XLA's in the reference
and plain ``F.conv1d`` in the port.

Tolerances: 1e-5 absolute for single layers (a conv, a predictor, the
postnet, a ResBlock); 1e-4 relative to max|x| for stacks (the TTS
encoder, HiFi-GAN), where float32 rounding accumulates over layers;
exact equality for integer results (durations, frame indices). The
bf16 cases run both sides at dtype bfloat16 (the weights float32, cast
at use) and hold the port to 2^-6 x max(1, max|ref|), a few bf16 ulps of
the output's scale: the two sides round at the same points, but sum in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def randomize(variables, seed=0):
    """Seeded numpy values for every leaf of a variables tree: kernels ~
    N(0, 1/fan_in), scales near 1, variances in [0.5, 1.5], others small."""
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


def init_vars(module, *args, seed=0, **kw):
    return randomize(jax.eval_shape(
        lambda *a: module.init({"params": KEY, "dropout": KEY}, *a, **kw),
        *args), seed)


def bridge(tmod, variables):
    tmod.load_state_dict(from_flax_variables(variables), strict=True)
    return tmod.eval()


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def close_rel(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (err,
                                                       np.abs(want).max())


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------- convolutions

@pytest.mark.parametrize("mode,k,d", [("same", 3, 1), ("same", 4, 1),
                                      ("same", 5, 2), ("same", 4, 2),
                                      ("valid", 3, 1), ("full", 3, 2),
                                      ("causal", 5, 1)])
def test_conv1dev_matches_jax(mode, k, d):
    """Every padding mode, odd and even kernels, dilation 1 and 2."""
    from speechain_tpu.nn.prenets import Conv1dEv as J
    from speechain_tpu_torch.nn.prenets import Conv1dEv
    x = rnd(2, 11, 6, seed=k + d)
    jm = J(out_channels=7, kernel_size=k, dilation=d, padding_mode=mode)
    v = init_vars(jm, jnp.asarray(x))
    got = bridge(Conv1dEv(6, 7, k, dilation=d, padding_mode=mode),
                 v)(_t(x))
    close(got, jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("residual", [False, True])
def test_conv_ffn_matches_jax(residual):
    """The 'conv' FFN type (feed_forward.py:181-201), the FastSpeech2
    recipes' kernel 9, with and without the residual epilogue."""
    from speechain_tpu.nn.feed_forward import PositionwiseFeedForward as J
    from speechain_tpu_torch.nn.feed_forward import PositionwiseFeedForward
    x, res = rnd(2, 13, 24, seed=1), rnd(2, 13, 24, seed=2)
    kw = dict(fdfwd_type="conv", fdfwd_args={"kernel_size": 9},
              fdfwd_activation="ReLU")
    jm = J(d_model=24, fdfwd_dim=40, **kw)
    rkw = dict(residual=jnp.asarray(res)) if residual else {}
    v = init_vars(jm, jnp.asarray(x), **rkw)
    tmod = bridge(PositionwiseFeedForward(24, 40, **kw), v)
    got = tmod(_t(x), residual=_t(res) if residual else None)
    close(got, jm.apply(v, jnp.asarray(x), **rkw))


# ----------------------------------------------------------------- prenets

def test_conv1d_prenet_matches_jax():
    """BatchNorm from running statistics, ReLU, and linear layers whose
    -1 entries inherit the width."""
    from speechain_tpu.nn.prenets import Conv1dPrenet as J
    from speechain_tpu_torch.nn.prenets import Conv1dPrenet
    x = rnd(2, 9, 16, seed=3)
    kw = dict(conv_dims=[12, 12], conv_kernel=5, lnr_dims=[-1, 20],
              lnr_activation="ReLU")
    jm = J(**kw)
    v = init_vars(jm, jnp.asarray(x))
    got, _ = bridge(Conv1dPrenet(16, **kw), v)(_t(x))
    close(got, jm.apply(v, jnp.asarray(x))[0])


@pytest.mark.parametrize("comb", ["concat", "add"])
def test_speaker_embed_prenet_matches_jax(comb):
    """A lookup table and external speaker features, combined by
    concatenation + projection or by addition."""
    from speechain_tpu.nn.prenets import SpeakerEmbedPrenet as J
    from speechain_tpu_torch.nn.prenets import SpeakerEmbedPrenet
    feat, spk_feat = rnd(3, 5, 16, seed=4), rnd(3, 10, seed=5)
    ids = np.array([0, 3, 1], np.int32)
    kw = dict(d_model=16, spk_num=4, spk_emb_dim_lookup=8,
              spk_emb_dim_pretrained=10, spk_emb_comb=comb)
    jm = J(**kw)
    args = (jnp.asarray(feat), jnp.asarray(ids), jnp.asarray(spk_feat))
    v = init_vars(jm, *args)
    got = bridge(SpeakerEmbedPrenet(**kw), v)(_t(feat), _t(ids),
                                              _t(spk_feat))
    close(got, jm.apply(v, *args))


@pytest.mark.parametrize("use_gate", [False, True])
def test_var_predictor_and_scalar_embed_match_jax(use_gate):
    from speechain_tpu.nn.prenets import (Conv1dVarPredictor as JV,
                                          ScalarEmbedConv as JS)
    from speechain_tpu_torch.nn.prenets import (Conv1dVarPredictor,
                                                ScalarEmbedConv)
    x = rnd(2, 12, 24, seed=6, scale=2.0)
    jm = JV(conv_dims=[16, 16], use_gate=use_gate)
    v = init_vars(jm, jnp.asarray(x))
    s, g = bridge(Conv1dVarPredictor(24, conv_dims=[16, 16],
                                     use_gate=use_gate), v)(_t(x))
    js, jg, _ = jm.apply(v, jnp.asarray(x))
    close(s, js)
    assert (g is None) == (jg is None)
    if use_gate:
        close(g, jg)
    scal = rnd(2, 12, seed=7)
    jse = JS(out_dim=24)
    v = init_vars(jse, jnp.asarray(scal))
    close(bridge(ScalarEmbedConv(24), v)(_t(scal)),
          jse.apply(v, jnp.asarray(scal)))


def test_conv1d_postnet_matches_jax():
    """Eval BatchNorm from the running statistics, Tanh between layers."""
    from speechain_tpu.nn.postnets import Conv1dPostnet as J
    from speechain_tpu_torch.nn.postnets import Conv1dPostnet
    x = rnd(2, 14, 8, seed=8)
    jm = J(feat_dim=8, conv_dims=[12, 12, 12])
    v = init_vars(jm, jnp.asarray(x))
    assert "batch_stats" in v
    got = bridge(Conv1dPostnet(8, conv_dims=[12, 12, 12]), v)(_t(x))
    close(got, jm.apply(v, jnp.asarray(x)))


def test_tts_encoder_matches_jax():
    """Embedding -> Conv1d prenet -> 2-layer transformer encoder, with a
    padded row."""
    from speechain_tpu.models.ar_tts import TTSEncoder as J
    from speechain_tpu_torch.models.ar_tts import TTSEncoder
    text = np.random.default_rng(9).integers(1, 30, (2, 11)).astype(np.int32)
    text_len = np.array([11, 7], np.int32)
    text[1, 7:] = 0
    kw = dict(vocab_size=30, emb=dict(embedding_dim=32),
              prenet=dict(conv_dims=[32, 32], conv_kernel=3),
              encoder=dict(d_model=32, num_heads=4, num_layers=2,
                           fdfwd_dim=64))
    jm = J(**kw)
    v = init_vars(jm, jnp.asarray(text), jnp.asarray(text_len))
    out, out_len, mask = bridge(TTSEncoder(**kw), v)(_t(text), _t(text_len))
    jout, jlen, jmask, _ = jm.apply(v, jnp.asarray(text),
                                    jnp.asarray(text_len))
    close_rel(out, jout)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))


BF16_TOL = 2 ** -6


@pytest.mark.parametrize("module", ["encoder", "postnet", "var_predictor"])
def test_bf16_modules_match_jax(module):
    """The TTS encoder (embedding, Conv1d prenet with BatchNorm, 2-layer
    transformer encoder), the postnet (Conv1d, eval BatchNorm, Tanh) and
    the variance predictor (Conv1d, ReLU, its plain LayerNorm, the
    scalar head) at dtype bfloat16 on both sides."""
    from speechain_tpu.models.ar_tts import TTSEncoder as JE
    from speechain_tpu.nn.postnets import Conv1dPostnet as JP
    from speechain_tpu.nn.prenets import Conv1dVarPredictor as JV
    from speechain_tpu_torch.models.ar_tts import TTSEncoder
    from speechain_tpu_torch.nn.postnets import Conv1dPostnet
    from speechain_tpu_torch.nn.prenets import Conv1dVarPredictor
    jb, tb = jnp.bfloat16, torch.bfloat16
    if module == "encoder":
        text = np.random.default_rng(21).integers(1, 30, (2, 11)).astype(
            np.int32)
        text_len = np.array([11, 7], np.int32)
        text[1, 7:] = 0
        kw = dict(vocab_size=30, emb=dict(embedding_dim=32),
                  prenet=dict(conv_dims=[32, 32], conv_kernel=3),
                  encoder=dict(d_model=32, num_heads=4, num_layers=2,
                               fdfwd_dim=64))
        jm = JE(dtype=jb, **kw)
        args = (jnp.asarray(text), jnp.asarray(text_len))
        v = init_vars(jm, *args, seed=21)
        got = bridge(TTSEncoder(dtype=tb, **kw), v)(_t(text), _t(text_len))
        want = jm.apply(v, *args)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        got, want = got[0], want[0]
    elif module == "postnet":
        x = rnd(2, 14, 8, seed=22)
        jm = JP(feat_dim=8, conv_dims=[12, 12, 12], dtype=jb)
        v = init_vars(jm, jnp.asarray(x, jb), seed=22)
        got = bridge(Conv1dPostnet(8, conv_dims=[12, 12, 12], dtype=tb),
                     v)(_t(x).to(tb))
        want = jm.apply(v, jnp.asarray(x, jb))
    else:
        x = rnd(2, 12, 24, seed=23, scale=2.0)
        jm = JV(conv_dims=[16, 16], dtype=jb)
        v = init_vars(jm, jnp.asarray(x, jb), seed=23)
        got = bridge(Conv1dVarPredictor(24, conv_dims=[16, 16], dtype=tb),
                     v)(_t(x).to(tb))[0]
        want = jm.apply(v, jnp.asarray(x, jb))[0]
    assert got.dtype == tb and want.dtype == jb
    close_rel(got, np.asarray(want, np.float32), rel=BF16_TOL)


# ------------------------------------------------- FastSpeech2 functions

def test_duration_functions_match_jax():
    """proc_duration (rounding half to even, zeros kept, clamps, alpha),
    length_regulate (frames, lengths, the cap) and
    average_scalar_by_duration, exactly."""
    from speechain_tpu.models import nar_tts as J
    from speechain_tpu_torch.models import nar_tts as T
    rng = np.random.default_rng(10)
    raw = rng.uniform(-0.5, 6.0, (3, 9)).astype(np.float32)
    raw[0, :3] = [0.5, 1.5, 2.5]                   # ties round to even
    raw[1, 2] = 0.0
    alpha = rng.uniform(0.8, 1.2, (3, 9)).astype(np.float32)
    for kw in (dict(), dict(min_frame_num=2, max_frame_num=4),
               dict(reduction_factor=2, min_frame_num=3)):
        for a in (None, alpha):
            want = J.proc_duration(jnp.asarray(raw), train=False,
                                   duration_alpha=None if a is None
                                   else jnp.asarray(a), **kw)
            got = T.proc_duration(_t(raw), train=False,
                                  duration_alpha=None if a is None
                                  else _t(a), **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dur = np.asarray(J.proc_duration(jnp.asarray(raw), train=False))
    enc = rnd(3, 9, 5, seed=11)
    for F in (64, 20):                              # 20 cuts the longest
        jf, jl = J.length_regulate(jnp.asarray(enc), jnp.asarray(dur), F)
        tf, tl = T.length_regulate(_t(enc), _t(dur), F)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    frame = rnd(3, 40, seed=12)
    close(T.average_scalar_by_duration(_t(frame), _t(dur)),
          J.average_scalar_by_duration(jnp.asarray(frame), jnp.asarray(dur)))


def test_length_regulate_sums_bf16_durations_exactly():
    """Durations in bf16, as a bf16 network predicts them, 600 frames in
    all: the port sums them exactly, so its frames are the reference's
    for the same durations in float32 (the reference's own bf16 sums
    round past 256 frames in XLA's scan order; models/nar_tts.py)."""
    from speechain_tpu.models import nar_tts as J
    from speechain_tpu_torch.models import nar_tts as T
    dur = np.full((2, 100), 6.0, np.float32)
    dur[1, ::7] = 5.0
    enc = rnd(2, 100, 4, seed=13)
    jf, jl = J.length_regulate(jnp.asarray(enc), jnp.asarray(dur), 640)
    tf, tl = T.length_regulate(_t(enc), _t(dur).to(torch.bfloat16), 640)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.tolist() == [600, 585]


def test_generate_ctrl_alpha():
    """A fixed alpha equals the reference's; random draws (a torch
    generator in place of a JAX key: the bits differ) lie in the range,
    one per utterance or per token."""
    from speechain_tpu.models.nar_tts import generate_ctrl_alpha as J
    from speechain_tpu_torch.models.nar_tts import generate_ctrl_alpha
    np.testing.assert_array_equal(
        generate_ctrl_alpha(None, 3, 5, alpha=1.1).numpy(),
        np.asarray(J(None, 3, 5, alpha=1.1)))
    gen = torch.Generator().manual_seed(0)
    utt = generate_ctrl_alpha(gen, 4, 6, alpha_min=0.5, alpha_max=2.0)
    tok = generate_ctrl_alpha(gen, 4, 6, granularity="token")
    assert utt.shape == tok.shape == (4, 6)
    assert ((utt >= 0.5) & (utt < 2.0)).all()
    assert ((tok >= 0.8) & (tok < 1.2)).all()
    assert (utt == utt[:, :1]).all() and len(set(utt[:, 0].tolist())) == 4
    assert len(set(tok[0].tolist())) == 6
    with pytest.raises(ValueError):
        generate_ctrl_alpha(gen, 2, 2, granularity="phone")


def test_recover_feat_norm_matches_jax():
    """Global statistics with a seen and an unseen group (the unseen one
    falls back to the all-group averages)."""
    from speechain_tpu.ops import feat_norm as J
    from speechain_tpu_torch.ops import feat_norm as T
    rng = np.random.default_rng(14)
    cfg = dict(norm_type="group", num_groups=3, feat_dim=6)
    stats = J.init_stats(J.FeatNormConfig(**cfg))._replace(
        mean=jnp.asarray(rng.standard_normal((3, 6)), jnp.float32),
        std=jnp.asarray(rng.uniform(0.5, 2, (3, 6)), jnp.float32),
        seen=jnp.asarray([True, False, True]),
        aver_mean=jnp.asarray(rng.standard_normal(6), jnp.float32),
        aver_std=jnp.asarray(rng.uniform(0.5, 2, 6), jnp.float32))
    feat = rnd(3, 4, 6, seed=15)
    gid = np.array([0, 1, 2], np.int32)
    want = J.recover_feat_norm(stats, jnp.asarray(feat),
                               J.FeatNormConfig(**cfg), jnp.asarray(gid))
    tstats = T.NormStats(*(_t(np.asarray(x)) for x in stats))
    got = T.recover_feat_norm(tstats, _t(feat), T.FeatNormConfig(**cfg),
                              _t(gid))
    close(got, want)
    with pytest.raises(ValueError):
        T.recover_feat_norm(tstats, _t(feat),
                            T.FeatNormConfig(norm_type="utterance"))


# ----------------------------------------------------------------- HiFi-GAN

SMALL_HIFIGAN = dict(in_channels=12, upsample_initial_channel=16)


@pytest.mark.parametrize("kind", ["1", "2"])
def test_resblocks_match_jax(kind):
    from speechain_tpu.nn import vocoder_hifigan as J
    from speechain_tpu_torch.nn import vocoder_hifigan as T
    x = rnd(2, 23, 8, seed=16)
    jcls, tcls = ((J.ResBlock1, T.ResBlock1) if kind == "1"
                  else (J.ResBlock2, T.ResBlock2))
    jm = jcls(channels=8, kernel_size=5)
    v = init_vars(jm, jnp.asarray(x))
    got = bridge(tcls(8, 5), v)(_t(x).transpose(1, 2)).transpose(1, 2)
    close(got, jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["1", "2"])
def test_hifigan_matches_jax(kind):
    """The whole generator at 16 initial channels (V1's up-sampling
    8 8 2 2, kernels 16 16 4 4; V1 or V2 ResBlocks): T frames give
    256 T samples."""
    from speechain_tpu.nn.vocoder_hifigan import HiFiGAN as J
    from speechain_tpu_torch.nn.vocoder_hifigan import HiFiGAN
    kw = dict(SMALL_HIFIGAN, resblock_type=kind)
    if kind == "2":
        kw["resblock_dilation_sizes"] = ((1, 3),) * 3
    mel = rnd(2, 9, 12, seed=17)
    jm = J(**kw)
    v = init_vars(jm, jnp.asarray(mel))
    tmod = bridge(HiFiGAN(**kw), v)
    got = tmod(_t(mel))
    assert got.shape == (2, 9 * 256) and tmod.hop == 256
    close_rel(got, jm.apply(v, jnp.asarray(mel)))


def test_load_torch_hifigan_matches_jax():
    """A SpeechBrain-layout state dict with weight-normed kernels, loaded
    by both packages' ``load_torch_hifigan``, gives the same waveform;
    ``_fold_weight_norm`` equals the reference's."""
    from speechain_tpu.nn import vocoder_hifigan as J
    from speechain_tpu_torch.nn import vocoder_hifigan as T
    cfg = dict(SMALL_HIFIGAN)
    rng = np.random.default_rng(18)
    port = T.HiFiGAN(**cfg)
    sd = {}
    for name, p in port.state_dict().items():
        prefix = name.rsplit(".", 1)[0]
        for a, b in (("resblocks_", "resblocks."), ("ups_", "ups.")):
            prefix = prefix.replace(a, b)
        for w in ("convs1_", "convs2_"):
            prefix = prefix.replace(w, w[:-1] + ".")
        if name.endswith(".bias"):
            sd[prefix + ".bias"] = 0.1 * rng.standard_normal(p.shape)
        elif prefix.startswith("conv_pre"):         # one without weight norm
            sd[prefix + ".weight"] = rng.standard_normal(p.shape) * 0.2
        else:
            sd[prefix + ".weight_v"] = rng.standard_normal(p.shape)
            sd[prefix + ".weight_g"] = rng.uniform(
                0.2, 1.0, (p.shape[0],) + (1,) * (len(p.shape) - 1))
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    np.testing.assert_allclose(
        T._fold_weight_norm(sd, "ups.0").numpy(),
        J._fold_weight_norm(sd, "ups.0"), rtol=1e-6, atol=1e-7)
    port.load_state_dict(T.load_torch_hifigan(sd, cfg), strict=True)
    mel = rnd(2, 7, 12, seed=19)
    want = J.HiFiGAN(**cfg).apply(J.load_torch_hifigan(sd, cfg),
                                  jnp.asarray(mel))
    close_rel(port.eval()(_t(mel)), want)


def test_weight_bridge_round_trips_tts_trees():
    """from_flax_variables then to_flax_variables returns the flax tree
    (params and batch statistics) of a FastSpeech2 network with a
    speaker table, a Conv1d prenet and 'conv' FFNs, and of a HiFi-GAN."""
    from speechain_tpu.models.nar_tts import (FastSpeech2Config as JC,
                                              FastSpeech2Net as JN)
    from speechain_tpu.nn.vocoder_hifigan import HiFiGAN as JH
    text = jnp.ones((1, 6), jnp.int32)
    d = 16
    layer = dict(d_model=d, num_heads=2, num_layers=1, fdfwd_dim=24,
                 fdfwd_type="conv", fdfwd_args={"kernel_size": 3})
    jn = JN(cfg=JC(vocab_size=9, enc_emb=dict(embedding_dim=d),
                   enc_prenet=dict(conv_dims=[d], conv_kernel=3),
                   encoder=layer, decoder=layer,
                   duration_predictor=dict(conv_dims=[8]),
                   pitch_predictor=dict(conv_dims=[8]),
                   energy_predictor=dict(conv_dims=[8]),
                   postnet=dict(conv_dims=[8]),
                   spk_emb=dict(spk_num=3), max_frame_len=12))
    trees = [init_vars(jn, text, jnp.full((1,), 6, jnp.int32),
                       spk_ids=jnp.zeros((1,), jnp.int32)),
             init_vars(JH(**SMALL_HIFIGAN), jnp.zeros((1, 4, 12)))]
    for tree in trees:
        back = to_flax_variables(from_flax_variables(tree))
        flat = jax.tree_util.tree_leaves_with_path(tree)
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(flat_back)
        for path, leaf in flat:
            np.testing.assert_array_equal(flat_back[path], leaf)
