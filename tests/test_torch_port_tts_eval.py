"""The port's objective TTS evaluation and its entry points against the
JAX package's, on the CPU.

- ``utils/world_pitch.py``: bit-equal to the JAX package's copy.
- ``utils/tts_eval.py``: ``dtw_path`` (the port fills the cost matrix by
  anti-diagonals) bit-equal to the reference's cell-by-cell loop, ties
  included; ``mcd`` / ``msd`` / ``log_f0_rmse`` bit-equal when both sides
  are handed the same features; the whole metrics, each side on its own
  log-Mel, within 1e-4 relative on tones with seeded noise (features that
  differ by float32 rounding and leave no DTW ties).
- Host I/O: ``utils/fileio.py``, ``reports.py`` and ``native_audio.py``
  against the JAX package's (.wav, .npy and a .flac decoded by the
  library built from ``native/flac_decoder.cpp``), equal.
- The three entry points (``speechain_tpu_torch/pyscripts``, ``--device
  cpu``) against the JAX package's on the same files: the same ``idx2*``
  keys; embeddings within 1e-5; scores written at four decimals, so
  within 1e-4 relative plus one unit of the last place.
- One slice: reference waveforms -> ECAPA embeddings -> a 1 + 1-layer
  multi-speaker FastSpeech2 (``spk_emb`` 192 concatenated, d 32) ->
  Griffin-Lim from given phases -> speaker similarity, MCD, MSD and
  log-F0 RMSE, port against JAX in float32 at dropout 0: embeddings 1e-5,
  mel and waveform 1e-4 of their largest magnitude (the tolerance of
  ``test_torch_port_griffin_lim.py``), scores 1e-3 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.utils import tts_eval as jte
from speechain_tpu.utils import world_pitch as jwp
from speechain_tpu_torch.utils import tts_eval as tte
from speechain_tpu_torch.utils import world_pitch as twp
from speechain_tpu_torch.utils.fileio import (read_idx2data_file,
                                              write_idx2data_file, write_wav)

SR = 16000


def tone_wave(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """Two harmonics of a gliding F0 with seeded noise under them and a
    silent gap (unvoiced frames)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(110.0, 220.0) * (1.0 + 0.1 * t / max(seconds, 1e-9))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    w = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) \
        + 0.02 * rng.standard_normal(n)
    w[n // 3: n // 3 + sr // 10] = 0.001 * rng.standard_normal(sr // 10)
    return w.astype(np.float32)


@pytest.mark.parametrize("continuous", [False, True])
def test_world_pitch_bit_equal_to_jax(continuous):
    wave = tone_wave(0.8, seed=1)
    np.testing.assert_array_equal(
        twp.convert_wav_to_pitch(wave, hop_length=256, sr=SR,
                                 do_continuous_f0=continuous),
        jwp.convert_wav_to_pitch(wave, hop_length=256, sr=SR,
                                 do_continuous_f0=continuous))


def _dtw_cases():
    rng = np.random.default_rng(2)
    feats = (rng.standard_normal((31, 13)), rng.standard_normal((40, 13)))
    # pitch tracks whose zeros (unvoiced) tie many moves
    tracks = tuple(np.where(rng.random(n) < 0.4, 0.0,
                            rng.uniform(100, 200, n)).astype(np.float32)
                   for n in (45, 38))
    same = np.repeat(rng.standard_normal((6, 3)), 3, axis=0)
    return {"features": feats, "tracks": tracks, "repeated": (same, same),
            "one frame": (feats[0][:1], feats[1])}


@pytest.mark.parametrize("case", sorted(_dtw_cases()))
def test_dtw_path_bit_equal_to_jax(case):
    a, b = _dtw_cases()[case]
    got, want = tte.dtw_path(a, b), jte.dtw_path(a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def pair():
    """A hypothesis and a reference of tones with noise, 0.7 and 0.9 s."""
    return tone_wave(0.7, seed=3), tone_wave(0.9, seed=4)


def test_metrics_bit_equal_on_the_same_features(pair, monkeypatch):
    """Both packages' mcd / msd handed the JAX package's log-Mel, and
    log_f0_rmse (host only): equal bit for bit."""
    feats = {len(w): jte.wav_to_logmel(w, SR) for w in pair}

    def same_logmel(wave, sr, *args, **kwargs):
        return feats[len(wave)]

    monkeypatch.setattr(jte, "wav_to_logmel", same_logmel)
    monkeypatch.setattr(tte, "wav_to_logmel", same_logmel)
    for name, kw in (("mcd", dict(device="cpu")), ("msd", dict(device="cpu")),
                     ("log_f0_rmse", {})):
        got = getattr(tte, name)(*pair, SR, **kw)
        want = getattr(jte, name)(*pair, SR)
        assert got is not None and got == want, (name, got, want)


@pytest.mark.parametrize("sr", [16000, 22050])
def test_metrics_match_jax(sr):
    """Each side on its own log-Mel (the port's plain version on the
    CPU): within 1e-4 relative; a wave shorter than one window scores
    None on both."""
    h, r = tone_wave(0.6, seed=5, sr=sr), tone_wave(0.5, seed=6, sr=sr)
    for name, kw in (("mcd", dict(device="cpu")), ("msd", dict(device="cpu")),
                     ("log_f0_rmse", {})):
        got = getattr(tte, name)(h, r, sr, **kw)
        want = getattr(jte, name)(h, r, sr)
        assert got is not None and abs(got - want) <= 1e-4 * abs(want), (
            name, got, want)
        assert getattr(tte, name)(h[: int(0.05 * sr) - 1], r, sr,
                                  **kw) is None
    np.testing.assert_allclose(tte.wav_to_mfcc(h, sr, device="cpu"),
                               jte.wav_to_mfcc(h, sr), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tte.wav_to_pitch(h, sr),
                                  jte.wav_to_pitch(h, sr))


# --------------------------------------------------------------- host I/O

def test_host_io_matches_jax(tmp_path, monkeypatch):
    """utils/fileio.py, reports.py and native_audio.py against the JAX
    package's: .wav, .npy and .flac (the native decoder built from
    native/flac_decoder.cpp) read equal with their sample rates; idx2
    files, markdown tables, top-N and resampling equal."""
    import subprocess

    from speechain_tpu.pyscripts.wave_downsampler import resample as jres
    from speechain_tpu.utils import fileio as jio
    from speechain_tpu.utils import native_audio as jnat
    from speechain_tpu.utils import reports as jrep
    from speechain_tpu_torch.utils import fileio as tio
    from speechain_tpu_torch.utils import native_audio as tnat
    from speechain_tpu_torch.utils import reports as trep
    from test_native_audio import write_flac
    lib = tmp_path / "libspeechain_native.so"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "flac_decoder.cpp")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
                    str(lib), src], check=True)
    monkeypatch.setenv("SPEECHAIN_NATIVE_LIB", str(lib))
    monkeypatch.setattr(tnat, "_LIB", None)
    monkeypatch.setattr(jnat, "_LIB", None)
    wave = tone_wave(0.3, seed=60)
    pcm = (wave * 20000).astype(np.int16)
    write_flac(str(tmp_path / "a.flac"), np.stack([pcm, pcm // 2], 1))
    write_wav(str(tmp_path / "a.wav"), wave, SR)
    np.save(tmp_path / "a.npy", wave)
    for name in ("a.flac", "a.wav", "a.npy"):
        got, got_sr = tio.read_data_by_path(str(tmp_path / name),
                                            return_sample_rate=True)
        want, want_sr = jio.read_data_by_path(str(tmp_path / name),
                                              return_sample_rate=True)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and got_sr == want_sr, name
    assert len(tio.read_data_by_path(str(tmp_path / "a.flac"))) == len(pcm)
    data = {"u1": "a b c", "u2": 3}
    write_idx2data_file(data, str(tmp_path / "idx2x"))
    assert read_idx2data_file(str(tmp_path / "idx2x")) == \
        jio.read_idx2data_file(str(tmp_path / "idx2x")) == \
        {"u1": "a b c", "u2": "3"}
    trep.write_idx2_file(data, str(tmp_path / "idx2y"))
    assert (tmp_path / "idx2y").read_text() == \
        (tmp_path / "idx2x").read_text()
    rows = [["x", 1, "0.5"], ["y", 2, "n/a"]]
    assert trep.md_table(["a", "b", "c"], rows) == \
        jrep.md_table(["a", "b", "c"], rows)
    scores = {"a": 0.3, "b": 0.1, "c": 0.7, "d": 0.1}
    for mode in ("max", "min"):
        assert trep.topn_bad_cases(scores, 3, mode) == \
            jrep.topn_bad_cases(scores, 3, mode)
    np.testing.assert_array_equal(tio.resample(wave, 22050, SR),
                                  jres(wave, 22050, SR))


# ------------------------------------------------------------ entry points

def _idx2wav(tmp_path, name, waves, sr=SR):
    d = tmp_path / name
    paths = {}
    for i, w in enumerate(waves):
        paths[f"utt{i}"] = str(d / f"utt{i}.wav")
        write_wav(paths[f"utt{i}"], w, sr)
    write_idx2data_file(paths, str(d / "idx2wav"))
    return str(d / "idx2wav")


def _scores(path):
    return {k: float(v) for k, v in read_idx2data_file(path).items()}


def _same_scores(got, want, rel):
    """Values written at four decimals: within ``rel`` relative plus one
    unit of the last place."""
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= rel * abs(want[k]) + 1.01e-4, (
            k, got[k], want[k])


@pytest.fixture(scope="module")
def ecapa_ckpt(tmp_path_factory):
    from speechain_tpu_torch.nn.speaker import EncoderClassifier
    from speechain_tpu_torch.utils.weights import random_state_dict
    path = tmp_path_factory.mktemp("spk") / "encoder.pth"
    torch.save(random_state_dict(EncoderClassifier("ecapa"), 11), path)
    return str(path)


def test_speaker_clis_match_jax(tmp_path, ecapa_ckpt):
    """spk_feat_extractor and spk_sim_evaluation, port (--device cpu)
    against JAX, on three reference and three synthesized-like waves."""
    from speechain_tpu.pyscripts import spk_feat_extractor as jext
    from speechain_tpu.pyscripts import spk_sim_evaluation as jsim
    from speechain_tpu_torch.pyscripts import spk_feat_extractor as text_
    from speechain_tpu_torch.pyscripts import spk_sim_evaluation as tsim
    refer = _idx2wav(tmp_path, "refer",
                     [tone_wave(s, seed=20 + i) for i, s in
                      enumerate((0.5, 0.8, 0.65))])
    hypo = _idx2wav(tmp_path, "hypo",
                    [tone_wave(s, seed=30 + i) for i, s in
                     enumerate((0.55, 0.7, 0.6))])
    for name, main in (("port", text_.main), ("jax", jext.main)):
        extra = ["--device", "cpu"] if name == "port" else []
        main(["--wav_path", refer, "--save_path", str(tmp_path / name),
              "--checkpoint", ecapa_ckpt] + extra)
    got = read_idx2data_file(str(tmp_path / "port" / "idx2spk_feat"))
    want = read_idx2data_file(str(tmp_path / "jax" / "idx2spk_feat"))
    assert list(got) == list(want) == ["utt0", "utt1", "utt2"]
    for k in want:
        g, w = np.load(got[k]), np.load(want[k])
        assert g.shape == (192,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        assert abs(float(np.linalg.norm(g)) - 1.0) <= 1e-5

    results = {}
    for name, main in (("port", tsim.main), ("jax", jsim.main)):
        out = tmp_path / f"sim_{name}"
        extra = ["--device", "cpu"] if name == "port" else []
        main(["--hypo_path", hypo, "--refer_path", refer, "--checkpoint",
              ecapa_ckpt, "--result_path", str(out)] + extra)
        results[name] = _scores(str(out / "idx2ecapa_spk_sim"))
        assert (out / "overall_results.md").exists()
    _same_scores(results["port"], results["jax"], 1e-3)
    # pre-extracted embeddings on the reference side
    out = tmp_path / "sim_feat"
    sims = tsim.main(["--hypo_path", refer, "--refer_path",
                      str(tmp_path / "port" / "idx2spk_feat"),
                      "--refer_is_feat", "--checkpoint", ecapa_ckpt,
                      "--result_path", str(out), "--device", "cpu"])
    assert all(abs(v - 1.0) <= 1e-5 for v in sims.values()), sims


def test_tts_evaluation_cli_matches_jax(tmp_path):
    """tts_evaluation, port (--device cpu) against JAX: idx2mcd, idx2msd,
    idx2log_f0_rmse; one hypothesis at 22.05 kHz is resampled to the
    reference's 16 kHz on both sides."""
    from speechain_tpu.pyscripts import tts_evaluation as jeval
    from speechain_tpu_torch.pyscripts import tts_evaluation as teval
    refer = _idx2wav(tmp_path, "refer", [tone_wave(0.6, seed=40),
                                         tone_wave(0.7, seed=41)])
    hypo = _idx2wav(tmp_path, "hypo", [tone_wave(0.55, seed=42)])
    extra = tmp_path / "hypo" / "utt1.wav"
    write_wav(str(extra), tone_wave(0.65, seed=43, sr=22050), 22050)
    with open(hypo, "a") as f:
        f.write(f"utt1 {extra}\n")
    results = {}
    for name, main in (("port", teval.main), ("jax", jeval.main)):
        out = tmp_path / f"eval_{name}"
        argv = ["--hypo_path", hypo, "--refer_path", refer,
                "--result_path", str(out)]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        results[name] = {m: _scores(str(out / f"idx2{m}"))
                         for m in ("mcd", "msd", "log_f0_rmse")}
        assert (out / "overall_results.md").exists()
    for m in ("mcd", "msd", "log_f0_rmse"):
        assert list(results["port"][m]) == ["utt0", "utt1"], m
        _same_scores(results["port"][m], results["jax"][m], 1e-4)


# ------------------------------------------------------------------ slice

def test_multispeaker_slice_matches_jax():
    """Reference waves -> ECAPA -> multi-speaker FastSpeech2 (concat) ->
    Griffin-Lim (8 iterations from given phases) -> scores, port against
    JAX; every utterance is scored."""
    from speechain_tpu.models.nar_tts import FastSpeech2Config as JC
    from speechain_tpu.models.nar_tts import FastSpeech2Net as JN
    from speechain_tpu.nn import speaker as jspk
    from speechain_tpu.ops import griffin_lim as jgl
    from speechain_tpu.ops.feat_norm import FeatNormConfig as JF
    from speechain_tpu.ops.feat_norm import init_stats
    from speechain_tpu.ops.frontend import FrontendConfig as JFE
    from speechain_tpu.ops.frontend import LogMelFrontend as JLogMel
    from speechain_tpu_torch.infer.tts import make_fastspeech2_synthesizer
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config as TC
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.nn import speaker as tspk
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig as TF
    from speechain_tpu_torch.ops.frontend import FrontendConfig as TFE
    from speechain_tpu_torch.ops.frontend import LogMelFrontend as TLogMel
    from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                                   random_state_dict)
    from test_torch_port_tts_train import quick_jit, randomize

    B, T, L = 2, 48, 12000
    refs = [tone_wave(0.75, seed=50), tone_wave(0.6, seed=51)]
    wave = np.zeros((B, L), np.float32)
    lens = np.array([len(w) for w in refs], np.int32)
    for i, w in enumerate(refs):
        wave[i, : len(w)] = w

    # 1. ECAPA embeddings of the references
    enc = tspk.EncoderClassifier("ecapa")
    enc.load_state_dict(random_state_dict(enc, 12), strict=True)
    jvars = jspk.load_torch_speaker(
        {k: v.numpy() for k, v in enc.state_dict().items()}, "ecapa")

    def embed_t(w, n):
        f, fl = TLogMel(TFE(sr=SR, n_mels=80))(torch.from_numpy(w),
                                                torch.from_numpy(n))
        with torch.no_grad():
            return enc(f, fl)

    def embed_j(w, n):
        f, fl = JLogMel(JFE(sr=SR, n_mels=80))(jnp.asarray(w),
                                               jnp.asarray(n))
        return np.asarray(jspk.EncoderClassifier().apply(jvars, f, fl))

    emb_t, emb_j = embed_t(wave, lens), embed_j(wave, lens)
    np.testing.assert_allclose(emb_t.numpy(), emb_j, atol=1e-5, rtol=0)

    # 2. the LibriTTS recipe's structure at d 32, 1 + 1 layers
    fe = dict(sr=SR, n_mels=80, win_length=0.05, hop_length=0.0125,
              fmin=125.0, fmax=7600.0, return_energy=True)
    layer = dict(d_model=32, num_heads=2, num_layers=1, fdfwd_dim=64,
                 fdfwd_type="conv", fdfwd_activation="ReLU",
                 fdfwd_args={"kernel_size": 9})
    kw = dict(vocab_size=20, enc_emb=dict(embedding_dim=32), encoder=layer,
              decoder=layer, duration_predictor=dict(conv_dims=[16, 16]),
              pitch_predictor=dict(conv_dims=[16, 16]),
              energy_predictor=dict(conv_dims=[16, 16]),
              postnet=dict(conv_dims=[16, 16], conv_kernel=5),
              spk_emb=dict(spk_emb_dim_pretrained=192,
                           spk_emb_comb="concat"), max_frame_len=T)
    jnet = JN(cfg=JC(frontend=JFE(**fe), feat_norm=JF(feat_dim=80), **kw))
    net = FastSpeech2Net(TC(frontend=TFE(**fe), feat_norm=TF(feat_dim=80),
                            **kw))
    rng = np.random.default_rng(13)
    text = rng.integers(1, 20, (B, 8)).astype(np.int32)
    text_len = np.array([8, 6], np.int32)
    v = jax.tree_util.tree_map(np.array, randomize(jax.eval_shape(
        lambda a, b, s: jnet.init({"params": jax.random.PRNGKey(0)}, a, b,
                                  spk_feat=s),
        jnp.asarray(text), jnp.asarray(text_len), jnp.asarray(emb_j)),
        seed=14))
    v["params"]["duration_predictor"]["pred_head"]["bias"][:] = np.log(5.0)
    # the reference's log-Mel statistics, as a trained model's norm
    ref_feat = np.asarray(JLogMel(JFE(**fe))(jnp.asarray(wave),
                                             jnp.asarray(lens))[0])
    valid = ref_feat[0, : int(lens[0]) // 200]
    v["norm_stats"] = {"feat_norm": {"stats": init_stats(
        JF(feat_dim=80))._replace(
            mean=valid.mean(0, keepdims=True).astype(np.float32),
            std=valid.std(0, keepdims=True).astype(np.float32),
            seen=np.ones((1,), bool))}}
    key = jax.random.PRNGKey(1)
    phases = np.array(jax.random.uniform(key, (B, T, 401)))

    @quick_jit
    def chain(v, text, text_len, spk, key):
        out = jnet.apply(v, text, text_len, spk_feat=spk, train=False,
                         max_frames=T)
        feat = jnet.apply(v, out["pred_after"], None,
                          method=jnet.recover_feat)
        return out["pred_feat_len"], feat, *jgl.logmel_to_wave(
            feat, out["pred_feat_len"], jnet.cfg.frontend, n_iter=8,
            key=key)

    jlen, jfeat, jwave, jwave_len = chain(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(text),
        jnp.asarray(text_len), jnp.asarray(emb_j), key)
    net.load_state_dict(from_flax_variables(v), strict=True)
    got = make_fastspeech2_synthesizer(net, "gl", device="cpu",
                                       max_frames=T, gl_iters=8)(
        torch.from_numpy(text), torch.from_numpy(text_len), spk_feat=emb_t,
        gl_phases=torch.from_numpy(phases))
    np.testing.assert_array_equal(got["hypo_feat_len"].numpy(),
                                  np.asarray(jlen))
    assert min(got["hypo_feat_len"].tolist()) >= 20
    feat_t = net.recover_feat(got["hypo_feat"]).numpy()
    np.testing.assert_allclose(feat_t, jfeat, rtol=0,
                               atol=1e-4 * float(np.abs(jfeat).max()))
    np.testing.assert_array_equal(got["wave_len"].numpy(),
                                  np.asarray(jwave_len))
    jwave = np.asarray(jwave)
    np.testing.assert_allclose(got["wave"].numpy(), jwave, rtol=0,
                               atol=1e-4 * float(np.abs(jwave).max()))

    # 3. scores of each side's synthesis against the references
    n = got["wave_len"].numpy()
    hyp_t = [got["wave"][i, : n[i]].numpy() for i in range(B)]
    hyp_j = [jwave[i, : n[i]] for i in range(B)]
    sim_t = tspk.speaker_cosine_similarity(
        torch.stack([embed_t(h[None], np.array([len(h)], np.int32))[0]
                     for h in hyp_t]), emb_t).numpy()
    sim_j = np.asarray(jspk.speaker_cosine_similarity(
        np.concatenate([embed_j(h[None], np.array([len(h)], np.int32))
                        for h in hyp_j]), emb_j))
    np.testing.assert_allclose(sim_t, sim_j, rtol=1e-3)
    for i in range(B):
        for name, kw in (("mcd", dict(device="cpu")),
                         ("msd", dict(device="cpu")), ("log_f0_rmse", {})):
            got_s = getattr(tte, name)(hyp_t[i], refs[i], SR, **kw)
            want_s = getattr(jte, name)(hyp_j[i], refs[i], SR)
            assert got_s is not None and want_s is not None, (i, name)
            assert abs(got_s - want_s) <= 1e-3 * abs(want_s), (
                i, name, got_s, want_s)

