"""The port's TTS synthesis against the JAX package's, on the CPU.

``make_fastspeech2_synthesizer(net, vocoder, device="cpu")`` (the plain
versions of the FFN and flash-attention kernels) against
``FastSpeech2Net.apply(..., train=False)`` followed by ``recover_feat``
and ``HiFiGAN.apply``, as the reference's chain synthesizes
(``speechain_tpu/chain.py:108-140``), with the same seeded weights bridged
from flax and the same texts: 2 + 2 layers 64 wide, 20 tokens, 64 frames,
a HiFi-GAN with 16 initial channels, float32. The cases cover 4 heads of
16 with the 'linear' FFN and the recipes' 2 heads with the 'conv' FFN,
with and without the controllable-TTS alphas, and with and without a
speaker table; one case normalizes its features globally, so
``recover_feat`` denormalizes before the vocoder.

The duration predictor's output bias is log(4), so that the tokens take
frames (random weights otherwise predict almost none); one utterance is
padded. Tolerances: durations and frame counts
exactly; mel features 1e-4 and the waveform 1e-4 relative to
max(1, max|ref|), float32 rounding over the stacks.

The bf16 cases run FastSpeech2 at dtype bfloat16 on both sides, as the
benchmark synthesizes, with the vocoder in float32 over each side's
features. Their duration head is pinned (weight zero, bias log(5), four
frames a token before the alphas) so that both sides regulate to the
same frames whatever bf16 does to the predictor's sums; the mel
features are then held to 2^-6 x max(1, max|ref|), a few bf16 ulps of
their scale, and so is the waveform the float32 vocoder makes of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu_torch.utils.weights import from_flax_variables

KEY = jax.random.PRNGKey(0)
V, D, TOKENS, FRAMES = 40, 64, 20, 64
SMALL_HIFIGAN = dict(in_channels=80, upsample_initial_channel=16)


def randomize(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key) if hasattr(path[-1], "key") else str(
            path[-1])
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

    return jax.tree_util.tree_map_with_path(leaf, variables)


def configs(heads: int, ffn: str, spk: bool, norm: bool, bf16=False):
    """The JAX and port FastSpeech2Config of one case."""
    from speechain_tpu.models.nar_tts import FastSpeech2Config as JC
    from speechain_tpu.ops.feat_norm import FeatNormConfig as JF
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config as TC
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig as TF
    layer = dict(d_model=D, num_heads=heads, num_layers=2, fdfwd_dim=2 * D,
                 fdfwd_type=ffn)
    if ffn == "conv":
        layer["fdfwd_args"] = {"kernel_size": 9}
    kw = dict(vocab_size=V, enc_emb=dict(embedding_dim=D), encoder=layer,
              decoder=layer, duration_predictor=dict(conv_dims=[32, 32]),
              pitch_predictor=dict(conv_dims=[32, 32]),
              energy_predictor=dict(conv_dims=[32, 32]),
              postnet=dict(conv_dims=[32, 32, 32]),
              spk_emb=dict(spk_num=3) if spk else None,
              max_frame_len=FRAMES)
    fn = dict(norm_type="global", feat_dim=80)
    return (JC(feat_norm=JF(**fn) if norm else None,
               dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw),
            TC(feat_norm=TF(**fn) if norm else None,
               dtype=torch.bfloat16 if bf16 else torch.float32, **kw))


def variables(jnet, text, text_len, spk_ids, norm: bool, seed: int,
              pin: bool = False):
    from speechain_tpu.ops.feat_norm import FeatNormConfig, init_stats
    kw = {} if spk_ids is None else dict(spk_ids=jnp.asarray(spk_ids))
    v = randomize(jax.eval_shape(
        lambda t, tl: jnet.init({"params": KEY, "dropout": KEY}, t, tl,
                                train=False, **kw),
        jnp.asarray(text), jnp.asarray(text_len)), seed)
    v = jax.tree_util.tree_map(np.array, v)
    head = v["params"]["duration_predictor"]["pred_head"]
    head["bias"][:] = np.log(5.0 if pin else 4.0)
    if pin:
        head["kernel"][:] = 0.0
    if norm:                  # inference never builds the statistics
        rng = np.random.default_rng(seed + 1)
        stats = init_stats(FeatNormConfig(norm_type="global", feat_dim=80))
        v["norm_stats"] = {"feat_norm": {"stats": stats._replace(
            mean=rng.standard_normal((1, 80)).astype(np.float32),
            std=rng.uniform(0.5, 2.0, (1, 80)).astype(np.float32),
            seen=np.ones((1,), bool))}}
    return v


CASES = [
    # heads, ffn, alphas, speaker table, feature norm
    (4, "linear", False, False, False),
    (2, "conv", True, True, True),
    (4, "linear", True, False, True),
    (2, "conv", False, True, False),
]


@pytest.fixture(scope="module")
def jax_vocoder():
    """Every case's JAX HiFi-GAN, traced and compiled once: its seeded
    variables and its jitted ``apply``."""
    from speechain_tpu.nn.vocoder_hifigan import HiFiGAN as JH
    jvoc = JH(**SMALL_HIFIGAN)
    vv = randomize(jax.eval_shape(jvoc.init, KEY, jnp.zeros((1, 4, 80))),
                   seed=7)
    return vv, jax.jit(jvoc.apply)


def synthesize_both(heads, ffn, alphas, spk, norm, vocoder, bf16=False):
    """The reference's synthesis and the port's of one case, ``vocoder``
    the :func:`jax_vocoder` fixture: (the JAX outputs, the JAX waveform,
    the port's synthesizer outputs)."""
    from speechain_tpu.models.nar_tts import FastSpeech2Net as JN
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.nn.vocoder_hifigan import HiFiGAN
    rng = np.random.default_rng(heads * 10 + len(ffn))
    text = rng.integers(2, V, (2, TOKENS)).astype(np.int32)
    text_len = np.array([TOKENS, 14], np.int32)
    text[1, 14:] = 0
    spk_ids = np.array([2, 0], np.int32) if spk else None
    jcfg, tcfg = configs(heads, ffn, spk, norm, bf16)
    jnet = JN(cfg=jcfg)
    v = variables(jnet, text, text_len, spk_ids, norm, seed=heads, pin=bf16)
    vv, jvoc_apply = vocoder
    controls = {}
    if alphas:
        for kind in ("duration", "pitch", "energy"):
            controls[f"{kind}_alpha"] = rng.uniform(
                0.8, 1.2, (2, TOKENS)).astype(np.float32)

    jkw = {} if spk_ids is None else dict(spk_ids=jnp.asarray(spk_ids))
    out = jnet.apply(v, jnp.asarray(text), jnp.asarray(text_len),
                     train=False, max_frames=FRAMES, **jkw,
                     **{k: jnp.asarray(a) for k, a in controls.items()})
    jfeat = jnet.apply(v, out["pred_after"], None,
                       method=jnet.recover_feat)
    jwave = jvoc_apply(vv, jfeat.astype(jnp.float32))

    net = FastSpeech2Net(tcfg)
    net.load_state_dict(from_flax_variables(v), strict=True)
    voc = HiFiGAN(**SMALL_HIFIGAN)
    voc.load_state_dict(from_flax_variables(vv), strict=True)
    synth = make_fastspeech2_synthesizer(net, voc, device="cpu")
    got = synth(torch.from_numpy(text), torch.from_numpy(text_len),
                spk_ids=None if spk_ids is None
                else torch.from_numpy(spk_ids),
                **{k: torch.from_numpy(a) for k, a in controls.items()})
    return out, jwave, got


@pytest.mark.parametrize("heads,ffn,alphas,spk,norm", CASES)
def test_synthesizer_matches_jax(heads, ffn, alphas, spk, norm,
                                 jax_vocoder):
    out, jwave, got = synthesize_both(heads, ffn, alphas, spk, norm,
                                      jax_vocoder)
    np.testing.assert_array_equal(got["used_duration"].numpy(),
                                  np.asarray(out["used_duration"]))
    np.testing.assert_array_equal(got["hypo_feat_len"].numpy(),
                                  np.asarray(out["pred_feat_len"]))
    lens = got["hypo_feat_len"].tolist()
    assert min(lens) >= 14 and max(lens) <= FRAMES, lens   # real work
    for name, want, g in (("mel", out["pred_after"], got["hypo_feat"]),
                          ("wave", jwave, got["wave"])):
        want = np.asarray(want, np.float32)
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), (name, err)
    assert got["wave"].shape == (2, FRAMES * 256)
    np.testing.assert_array_equal(got["wave_len"].numpy(),
                                  got["hypo_feat_len"].numpy() * 256)


@pytest.mark.parametrize("heads,ffn,alphas,spk,norm", CASES[:2])
def test_bf16_synthesizer_matches_jax(heads, ffn, alphas, spk, norm,
                                      jax_vocoder):
    out, jwave, got = synthesize_both(heads, ffn, alphas, spk, norm,
                                      jax_vocoder, bf16=True)
    assert got["hypo_feat"].dtype == torch.bfloat16
    assert out["pred_after"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(got["used_duration"].float().numpy(),
                                  np.asarray(out["used_duration"],
                                             np.float32))
    np.testing.assert_array_equal(got["hypo_feat_len"].numpy(),
                                  np.asarray(out["pred_feat_len"]))
    lens = got["hypo_feat_len"].tolist()
    assert min(lens) >= 14 * 3 and max(lens) <= FRAMES, lens
    for name, want, g in (("mel", out["pred_after"], got["hypo_feat"]),
                          ("wave", jwave, got["wave"])):
        want = np.asarray(want, np.float32)
        err = np.abs(g.float().numpy() - want).max()
        assert err <= 2 ** -6 * max(1.0, np.abs(want).max()), (name, err)


def test_synthesizer_needs_a_card_unless_cpu_is_asked():
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    _, tcfg = configs(4, "linear", False, False)
    net = FastSpeech2Net(tcfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_fastspeech2_synthesizer(net)
    net.train()          # training needs the waveform and pitch targets
    with pytest.raises(ValueError):
        net(torch.ones(1, 3, dtype=torch.long), torch.tensor([3]))
