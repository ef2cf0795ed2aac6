"""The port's Griffin-Lim vocoder against the JAX package's, on the CPU.

``speechain_tpu_torch/ops/griffin_lim.py`` part by part against
``speechain_tpu/ops/griffin_lim.py`` at the LJSpeech recipe's frontend
(22.05 kHz, n_fft 1102, which is not a power of two, hop 275, 80 mels,
fmin 125, fmax 7600), float32, on log-Mel features of a few frames of
seeded tones and noise; Griffin-Lim itself starts from the initial phases
JAX draws (``jax.random.uniform(key, (B, T, F))``), handed to the port as
``phases``. The synthesizer's ``vocoder="gl"`` is held against the chain's
gl branch composed in JAX (``FastSpeech2Net.apply(..., train=False)``,
``recover_feat``, ``logmel_to_wave``) with JAX's default phases.

Tolerances, each relative to the reference's largest magnitude: the
pseudo-inverse 1e-5 (one 80-term product a bin); the NNLS inversion 1e-4
(30 multiplicative updates of 80- and 552-term products, whose float32
rounding compounds); the STFT 1e-5 and the inverse STFT 1e-5 (pocketfft
on both sides, the overlap-add summed in another order); inverse
pre-emphasis 1e-5 (a doubling scan against a sequential one, whose
partial sums round differently); Griffin-Lim's waveform and the
synthesizer's 1e-4 (each of its iterations renormalizes phases, which
float32 FFT rounding moves most at the quietest bins). That drift grows
with the iterations and the frames: ``python -m
tests.test_torch_port_griffin_lim`` prints it at 2 x 640 frames after 8
and 32 iterations, and the waveform's change when the log-Mel moves by
1e-5, the size of a float32 card-vs-CPU difference (a minute on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops import griffin_lim as jgl
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu_torch.ops import griffin_lim as tgl
from speechain_tpu_torch.ops.frontend import FrontendConfig as TFE
from test_torch_port_tts_train import quick_jit

FE = dict(sr=22050, n_mels=80, win_length=0.05, hop_length=0.0125,
          fmin=125.0, fmax=7600.0)
JCFG, TCFG = JFE(**FE), TFE(**FE)
B, T = 2, 24


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def within(got, want, rel, name=""):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (name, err,
                                                    float(np.abs(want).max()))


@pytest.fixture(scope="module")
def logmel():
    """log10-Mel of two utterances of tones and noise, (B, T, 80)."""
    from speechain_tpu_torch.ops.frontend import frontend_impl
    rng = np.random.default_rng(0)
    n = (T - 1) * 275
    t = np.arange(n) / 22050.0
    wave = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.2 * np.sin(2 * np.pi * 1375.0 * t),
                     0.1 * rng.standard_normal(n)]).astype(np.float32)
    feat, _, _, _ = frontend_impl(_t(wave), torch.tensor([n, n]),
                                  TFE(**FE, return_energy=True))
    assert feat.shape == (B, T, 80)
    return feat.numpy()


def test_mel_pinv_equals_jax():
    p = tgl.mel_pinv(TCFG)
    assert p.shape == (80, 552)
    np.testing.assert_array_equal(p, jgl.mel_pinv(JCFG))


@pytest.mark.parametrize("nnls_iters,rel", [(0, 1e-5), (30, 1e-4)])
def test_logmel_to_linear_matches_jax(logmel, nnls_iters, rel):
    want = quick_jit(lambda m: jgl.logmel_to_linear(m, JCFG,
                                                  nnls_iters=nnls_iters))(
        jnp.asarray(logmel))
    got = tgl.logmel_to_linear(_t(logmel), TCFG, nnls_iters=nnls_iters)
    assert got.shape == (B, T, 552) and float(got.min()) >= 1e-10
    within(got, want, rel, f"linear, {nnls_iters} NNLS steps")


def test_stft_and_istft_match_jax_at_n_fft_1102():
    rng = np.random.default_rng(1)
    n_fft, hop = TCFG.fft, TCFG.hop
    assert (n_fft, hop) == (1102, 275)
    win = tgl.padded_window(TCFG, "cpu")
    x = rng.standard_normal((B, (T - 1) * hop)).astype(np.float32)
    want = quick_jit(lambda x, w: jgl._stft(x, w, n_fft, hop))(
        jnp.asarray(x), jnp.asarray(win.numpy()))
    got = tgl.stft(_t(x), win, n_fft, hop)
    assert got.shape == (B, T, 552)
    within(torch.view_as_real(got), np.stack(
        [np.real(want), np.imag(want)], -1), 1e-5, "stft")
    want_x = quick_jit(lambda s: jgl._istft(
        s, jnp.asarray(win.numpy()), n_fft, hop, x.shape[1]))(want)
    got_x = tgl.istft(got, win, n_fft, hop, x.shape[1])
    within(got_x, want_x, 1e-5, "istft")
    within(got_x, x, 1e-5, "round trip")


def test_inverse_preemphasis_matches_jax():
    x = np.random.default_rng(2).standard_normal((B, 5000)).astype(
        np.float32)
    want = jgl.inverse_preemphasis(jnp.asarray(x), 0.97)
    got = tgl.inverse_preemphasis(_t(x), 0.97)
    within(got, want, 1e-5, "inverse pre-emphasis")


def test_griffin_lim_matches_jax_from_its_phases(logmel):
    """8 iterations from the phases JAX draws for key 3."""
    linear = np.asarray(quick_jit(lambda m: jgl.logmel_to_linear(m, JCFG))(
        jnp.asarray(logmel)))
    key = jax.random.PRNGKey(3)
    want = quick_jit(lambda a, k: jgl.griffin_lim(a, JCFG, n_iter=8, key=k))(
        jnp.asarray(linear), key)
    phases = np.asarray(jax.random.uniform(key, linear.shape))
    got = tgl.griffin_lim(_t(linear), TCFG, n_iter=8, phases=_t(phases))
    assert got.shape == (B, (T - 1) * 275)
    within(got, want, 1e-4, "griffin-lim")
    # the phases matter: another draw gives another waveform
    other = tgl.griffin_lim(_t(linear), TCFG, n_iter=8, phases=torch.rand(
        linear.shape, generator=torch.Generator().manual_seed(1)))
    assert float((other - got).abs().max()) > 1e-2 * float(got.abs().max())


def test_logmel_to_wave_matches_jax(logmel):
    """The whole recovery with pre-emphasis, and its wave_len =
    min(feat_len x hop, L)."""
    cfg_j, cfg_t = JFE(**FE, preemphasis=0.97), TFE(**FE, preemphasis=0.97)
    feat_len = np.array([T, 17], np.int32)
    key = jax.random.PRNGKey(0)
    want, want_len = quick_jit(lambda m, n, k: jgl.logmel_to_wave(
        m, n, cfg_j, n_iter=4, key=k))(jnp.asarray(logmel),
                                       jnp.asarray(feat_len), key)
    phases = np.asarray(jax.random.uniform(key, (B, T, 552)))
    got, got_len = tgl.logmel_to_wave(_t(logmel), _t(feat_len), cfg_t,
                                      n_iter=4, phases=_t(phases))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.tolist() == [(T - 1) * 275, 17 * 275]
    within(got, want, 1e-4, "wave")


def test_gl_synthesizer_matches_the_chains_gl_branch():
    """make_fastspeech2_synthesizer(net, "gl") against FastSpeech2Net.apply
    (train=False) + recover_feat + logmel_to_wave in JAX, 32 iterations
    from JAX's default phases (PRNGKey(0)); float32, 1 + 1 layers, 24
    frames, a global feature norm."""
    from speechain_tpu.models.nar_tts import FastSpeech2Config as JC
    from speechain_tpu.models.nar_tts import FastSpeech2Net as JN
    from speechain_tpu.ops.feat_norm import FeatNormConfig as JF
    from speechain_tpu.ops.feat_norm import init_stats
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config as TC
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig as TF
    from speechain_tpu_torch.utils.weights import from_flax_variables
    from test_torch_port_tts_train import randomize
    layer = dict(d_model=32, num_heads=2, num_layers=1, fdfwd_dim=64,
                 fdfwd_type="conv", fdfwd_args={"kernel_size": 9})
    kw = dict(vocab_size=20, enc_emb=dict(embedding_dim=32), encoder=layer,
              decoder=layer, duration_predictor=dict(conv_dims=[16, 16]),
              pitch_predictor=dict(conv_dims=[16, 16]),
              energy_predictor=dict(conv_dims=[16, 16]),
              postnet=dict(conv_dims=[16, 16]), max_frame_len=T)
    jnet = JN(cfg=JC(frontend=JFE(**FE, return_energy=True),
                     feat_norm=JF(feat_dim=80), **kw))
    net = FastSpeech2Net(TC(frontend=TFE(**FE, return_energy=True),
                            feat_norm=TF(feat_dim=80), **kw))
    rng = np.random.default_rng(4)
    text = rng.integers(1, 20, (B, 8)).astype(np.int32)
    text_len = np.array([8, 5], np.int32)
    v = jax.tree_util.tree_map(np.array, randomize(jax.eval_shape(
        lambda a, b: jnet.init({"params": jax.random.PRNGKey(0)}, a, b),
        jnp.asarray(text), jnp.asarray(text_len)), seed=5))
    v["params"]["duration_predictor"]["pred_head"]["bias"][:] = np.log(4.0)
    stats = init_stats(JF(feat_dim=80))
    v["norm_stats"] = {"feat_norm": {"stats": stats._replace(
        mean=(-2.0 + rng.standard_normal((1, 80))).astype(np.float32),
        std=rng.uniform(0.5, 1.0, (1, 80)).astype(np.float32),
        seen=np.ones((1,), bool))}}

    @quick_jit
    def chain(v, text, text_len):
        out = jnet.apply(v, text, text_len, train=False, max_frames=T)
        feat = jnet.apply(v, out["pred_after"], None,
                          method=jnet.recover_feat)
        return out["pred_feat_len"], feat, *jgl.logmel_to_wave(
            feat, out["pred_feat_len"], jnet.cfg.frontend, n_iter=32)

    jlen, jfeat, jwave, jwave_len = chain(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(text),
        jnp.asarray(text_len))
    net.load_state_dict(from_flax_variables(v), strict=True)
    synth = make_fastspeech2_synthesizer(net, "gl", device="cpu",
                                         max_frames=T)
    phases = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                           (B, T, 552)))
    got = synth(_t(text), _t(text_len), gl_phases=_t(phases))
    np.testing.assert_array_equal(got["hypo_feat_len"].numpy(),
                                  np.asarray(jlen))
    assert min(got["hypo_feat_len"].tolist()) >= 10
    within(net.recover_feat(got["hypo_feat"]), jfeat, 1e-4, "mel")
    np.testing.assert_array_equal(got["wave_len"].numpy(),
                                  np.asarray(jwave_len))
    assert got["wave"].shape == (B, (T - 1) * 275)
    within(got["wave"], jwave, 1e-4, "wave")
    with pytest.raises(ValueError):
        make_fastspeech2_synthesizer(net, "griffin", device="cpu")


def drift(frames: int = 640, seed: int = 0):
    """Griffin-Lim's JAX-vs-port difference, relative to max|wave|, at 2
    utterances of ``frames`` frames after 8 and 32 iterations from the
    same phases, and the port's change when the log-Mel moves by
    1e-5 N(0, 1)."""
    from speechain_tpu_torch.ops.frontend import frontend_impl
    rng = np.random.default_rng(seed)
    n = (frames - 1) * 275
    t = np.arange(n) / 22050.0
    wave = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(n)
                     for f in (150.0, 230.0)]).astype(np.float32)
    feat = frontend_impl(_t(wave), torch.tensor([n, n]), TCFG)[0].numpy()
    linear = np.asarray(jgl.logmel_to_linear(jnp.asarray(feat), JCFG))
    key = jax.random.PRNGKey(0)
    phases = _t(np.asarray(jax.random.uniform(key, linear.shape)))
    out = {}
    for iters in (8, 32):
        want = np.asarray(jgl.griffin_lim(jnp.asarray(linear), JCFG,
                                          n_iter=iters, key=key))
        got = tgl.griffin_lim(_t(linear), TCFG, n_iter=iters,
                              phases=phases).numpy()
        out[f"jax_vs_port_{iters}"] = float(
            np.abs(got - want).max() / np.abs(want).max())
    moved = feat + 1e-5 * rng.standard_normal(feat.shape).astype(np.float32)
    lens = torch.tensor([frames, frames])
    a = tgl.logmel_to_wave(_t(feat), lens, TCFG, phases=phases)[0]
    b = tgl.logmel_to_wave(_t(moved), lens, TCFG, phases=phases)[0]
    out["mel_1e-5_moves_wave_32"] = float((a - b).abs().max()
                                          / a.abs().max())
    return out


if __name__ == "__main__":
    print(drift())
