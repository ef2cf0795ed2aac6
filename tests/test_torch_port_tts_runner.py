"""The port's runner on the TTS families (``--platform cpu``), on data made
by the port's data-preparation CLIs, against the JAX package.

A tiny FastSpeech2 and a tiny Transformer-TTS (float32, dropout 0) read
the LJSpeech recipes' relative data paths under a temporary root, where
``chip_smoke.tts_corpus`` writes a raw LJSpeech layout and runs the
port's ``meta_generator``, ``lab_file_generator``, ``duration_calculator``
(on TextGrids in MFA's format), ``pitch_extractor``,
``data_len_generator``, ``wave_downsampler``, ``text_dumper`` and
``vocab_generator``:

- ``build_data`` batches (keys, arrays, ``pitch_len``, ``duration_len``,
  ``n_real``) equal JAX's over two epochs and the valid set;
- the runner's first step equals a direct ``make_fastspeech2_step`` /
  ``make_artts_step`` bit for bit; FastSpeech2's 2 epochs equal 1 +
  ``--resume`` 1 bit for bit;
- ``--test``: the features equal JAX's ``net.apply`` (+ ``recover_feat``)
  on the bridged weights and the waves JAX's ``logmel_to_wave`` from
  JAX's phases (1e-4 of max(1, max|ref|)); a fixed alpha and dict alphas
  (JAX's draws passed in) change the features as JAX's do;
  ``idx2mcd`` / ``idx2log_f0_rmse`` equal ``utils/tts_eval`` on the
  synthesized waves, and the written waves are those waves in 16-bit PCM;
- Transformer-TTS's ``--test`` against JAX's KV-cached synthesizer, and
  its ``weight_quant: int8`` run against a direct
  ``make_artts_synthesizer`` on the dequantized weights (bit for bit) and
  JAX's synthesizer on ``dequantize_variables(quantize_variables(...))``.

As in ``chip_smoke.py``'s phase 34, the saved models' duration-head bias
is log(7) and the stop head's -1e4 before the tests, so every utterance
has frames to score.
"""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from speechain_tpu import runner as jrunner
from speechain_tpu.builders import build_model as jbuild_model
from speechain_tpu.builders import build_tokenizer as jbuild_tokenizer
from speechain_tpu.infer.quantize import (dequantize_variables,
                                          quantize_variables)
from speechain_tpu.infer.tts_decoding import tts_auto_regression
from speechain_tpu.models.nar_tts import \
    generate_ctrl_alpha as jgenerate_ctrl_alpha
from speechain_tpu.ops import griffin_lim as jgl
from speechain_tpu_torch import runner
from speechain_tpu_torch.builders import build_model
from speechain_tpu_torch.models import nar_tts
from speechain_tpu_torch.ops import griffin_lim as tgl
from speechain_tpu_torch.train import state as tstate
from speechain_tpu_torch.utils.fileio import read_idx2data_file, read_wav
from speechain_tpu_torch.utils.weights import (init_state_dict,
                                               to_flax_variables)
from tests.test_torch_port_runner import Spy, quick_jit

SETS = (("train", 6, 0), ("dev", 4, 1))
SECS = (0.7, 1.0)
TOL = 1e-4                  # x max(1, max|ref|)

DATA_CFG = """
data_cfg:
  train:
    type: block
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
{train}
      data_len: !ref <data_root>/{train_dir}idx2wav_len
      shuffle: True
      is_descending: True
      batch_len: 50000
  valid:
    type: abs
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
{valid}
      shuffle: False
      batch_size: 4
"""
DROPOUT0 = ("posenc_dropout: 0.0, fdfwd_dropout: 0.0, att_dropout: 0.0, "
            "res_dropout: 0.0")
OPTIM = """
  optim_sches:
    type: noam
    conf:
      optim_type: Adam
      optim_conf: {lr: 0.001, betas: [0.9, 0.98], eps: 1.0e-9}
      warmup_steps: 6000
"""
FS2_YAML = ("""
data_root: datasets/ljspeech/data/wav22050
token_path: datasets/ljspeech/data/mfa/no-punc
num_epochs: 2
seed: 5
visual_snapshot_number: 0
""" + DATA_CFG.format(
    train="""          wav: !ref <data_root>/idx2wav
          text: !ref <token_path>/idx2mfa_text
          duration: !ref <token_path>/idx2duration
          pitch: !ref <data_root>/idx2pitch""", train_dir="",
    valid="""          wav: !ref <data_root>/dev/idx2wav
          text: !ref <token_path>/dev/idx2mfa_text
          duration: !ref <token_path>/dev/idx2duration
          pitch: !ref <data_root>/dev/idx2pitch""") + """
train_cfg:
  model:
    model_type: nar_tts.FastSpeech2
    model_conf:
      customize_conf: {token_type: g2p, token_path: !ref <token_path>}
    module_conf:
      frontend:
        conf: {sr: 22050, hop_length: 0.0125, win_length: 0.05, n_mels: 20,
               fmin: 125, fmax: 7600, return_energy: true}
      normalize: True
      pitch_normalize: True
      energy_normalize: True
      enc_emb: {conf: {embedding_dim: 32}}
      encoder:
        conf: {d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               fdfwd_type: conv, fdfwd_args: {kernel_size: 3}, %(d)s}
      duration_predictor: {conf: {conv_dims: [16, 16], conv_dropout: 0.0}}
      pitch_predictor: {conf: {conv_dims: [16, 16], conv_dropout: 0.0}}
      energy_predictor: {conf: {conv_dims: [16, 16], conv_dropout: 0.0}}
      decoder:
        conf: {d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               fdfwd_type: conv, fdfwd_args: {kernel_size: 3}, %(d)s}
      postnet: {conf: {conv_dims: [16, 16], conv_kernel: 5}}
""" % dict(d=DROPOUT0) + OPTIM + """
infer_cfg: {vocoder: gl, min_frame_num: 0, max_frame_num: 50, gl_iters: 4,
            max_frames: 256%(extra)s}
""")
AR_YAML = ("""
data_root: datasets/ljspeech/data/wav16000
token_path: datasets/ljspeech/data/char/punc
num_epochs: 1
seed: 6
visual_snapshot_number: 0
""" + DATA_CFG.format(
    train="""          wav: !ref <data_root>/train/idx2wav
          text: !ref <data_root>/train/idx2punc_text""",
    train_dir="train/",
    valid="""          wav: !ref <data_root>/valid/idx2wav
          text: !ref <data_root>/valid/idx2punc_text""") + """
train_cfg:
  model:
    model_type: ar_tts.ARTTS
    model_conf:
      customize_conf: {token_type: char, token_path: !ref <token_path>,
                       reduction_factor: 2, att_guid_sigma: 0.2}
    module_conf:
      frontend:
        conf: {sr: 16000, hop_length: 0.0125, win_length: 0.05, n_mels: 20,
               fmin: 125, fmax: 7600}
      normalize: True
      enc_emb: {conf: {embedding_dim: 32}}
      enc_prenet: {conf: {conv_dims: [32, 32], conv_kernel: 3,
                          lnr_dims: -1}}
      encoder:
        conf: {d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               %(d)s}
      dec_prenet: {conf: {lnr_dims: [16, 16], lnr_dropout: 0.0}}
      decoder:
        conf: {d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               %(d)s}
      postnet: {conf: {conv_dims: [16, 16], conv_kernel: 5}}
""" % dict(d=DROPOUT0) + OPTIM + """
infer_cfg: {stop_threshold: 0.5, maxlen_ratio: 10.0, vocoder: gl,
            gl_iters: 4, max_frames: 24%(extra)s}
""")


def run(cfg_path, result, *flags):
    return runner.main(["--config", str(cfg_path), "--result_path",
                        str(result), "--platform", "cpu", *flags])


def jax_phases(shape):
    """The initial phases JAX's Griffin-Lim draws by default."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(0), tuple(shape))))


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    try:
        chip_smoke.tts_corpus(root, SETS, SECS)
        cfgs = {}
        for name, text in (("fs2", FS2_YAML), ("ar", AR_YAML)):
            cfgs[name] = root / f"{name}.yaml"
            cfgs[name].write_text(text % dict(extra=""))
        # as on the card: no matplotlib and no tensorboardX
        mp.setitem(sys.modules, "matplotlib", None)
        mp.setitem(sys.modules, "tensorboardX", None)
        first = {}
        for name, factory in (("fs2", "make_fastspeech2_step"),
                              ("ar", "make_artts_step")):
            spy = Spy(mp, factory)
            run(cfgs[name], root / f"exp_{name}", "--train")
            first[name] = spy.first
        run(cfgs["fs2"], root / "exp_fs2_resumed", "--train",
            "--num_epochs", "1")
        run(cfgs["fs2"], root / "exp_fs2_resumed", "--train", "--resume")
        chip_smoke.set_saved_bias(root / "exp_fs2",
                                  "duration_predictor.pred_head.bias",
                                  float(np.log(7.0)))
        chip_smoke.set_saved_bias(root / "exp_ar", "stop_pred.bias", -1e4)
        yield dict(root=root, cfgs=cfgs, first=first, mp=mp)
    finally:
        mp.undo()


def _cfg(path):
    return runner.merge_config(runner.parse_args(["--config", str(path)]))


def _tokenizers(cfg):
    c = cfg["train_cfg"]["model"]["model_conf"]["customize_conf"]
    return (runner._tokenizer_of(c),
            jbuild_tokenizer(c.get("token_type", "char"), c["token_path"]))


def test_corpus_through_the_clis(tts):
    root = tts["root"]
    fs2 = root / chip_smoke.FS2_DATA
    tokens = root / chip_smoke.FS2_TOKEN_DIR
    durations = read_idx2data_file(str(tokens / "idx2duration"))
    texts = read_idx2data_file(str(tokens / "idx2mfa_text"))
    lens = read_idx2data_file(str(fs2 / "idx2wav_len"), int)
    assert len(durations) == len(lens) == SETS[0][1]
    for idx, d in durations.items():
        frames = [int(x) for x in d.split()]
        phones = texts[idx].strip("[]").split(", ")
        assert len(frames) == len(phones) and phones[0] == "'<space>'"
        # cumulative rounding at the hop: the frames add up to the wave's
        assert sum(frames) == round(lens[idx] / 22050 / 0.0125)
        assert np.load(str(fs2 / f"{idx}.npy")).shape[0] > 0
    ar = read_idx2data_file(str(root / chip_smoke.ARTTS_DATA / "valid" /
                                "idx2wav_len"), int)
    assert len(ar) == SETS[1][1]
    assert (root / chip_smoke.ARTTS_TOKEN_DIR / "vocab").exists()
    assert len(list((root / "mfa_corpus" / "train").glob("*.lab"))) == 6


@pytest.mark.parametrize("name", ["fs2", "ar"])
def test_build_data_batches_equal_jax(tts, name):
    cfg = _cfg(tts["cfgs"][name])
    tok, jtok = _tokenizers(cfg)
    n = 0
    for split, epochs in (("train", (1, 2)), ("valid", (0,))):
        tl = runner.build_data(cfg["data_cfg"], split, tok, num_workers=2)
        jl = jrunner.build_data(cfg["data_cfg"], split, jtok, num_workers=2)
        assert len(tl) == len(jl)
        for epoch in epochs:
            tb, jb = list(tl.epoch(epoch)), list(jl.epoch(epoch))
            assert len(tb) == len(jb) >= (2 if split == "train" else 1)
            for a, b in zip(tb, jb):
                assert sorted(a) == sorted(b)
                if name == "fs2":
                    assert {"pitch", "pitch_len", "duration",
                            "duration_len"} <= set(a)
                for k in a:
                    if isinstance(a[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype, k
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    else:
                        assert a[k] == b[k], k
                n += 1
    assert n >= 5


@pytest.mark.parametrize("name,factory", [
    ("fs2", "make_fastspeech2_step"), ("ar", "make_artts_step")])
def test_first_step_equals_a_direct_step(tts, name, factory):
    first = tts["first"][name]
    cfg = _cfg(tts["cfgs"][name])
    tok, _ = _tokenizers(cfg)
    net, net_cfg, _ = build_model(cfg["train_cfg"]["model"],
                                  tok.vocab_size)
    net.load_state_dict(init_state_dict(net, cfg["seed"]), strict=True)
    from speechain_tpu_torch.train.optim import build_optimizers
    loader = runner.build_data(cfg["data_cfg"], "train", tok)
    tx = build_optimizers(cfg["train_cfg"]["optim_sches"],
                          steps_per_epoch=len(loader),
                          grad_clip=cfg["grad_clip"])
    state = tstate.init_train_state(net, tx, device="cpu")
    step = getattr(tstate, factory)(net, net_cfg, tx, device="cpu")
    state, m = step(state, first["batch"],
                    runner.epoch_generator(cfg["seed"], 1))
    assert float(m["loss"]) == first["loss"]
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, first["net"][k]), k
    assert torch.equal(state.opt_state["mu"], first["mu"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_two_epochs_equal_one_and_a_resumed_one(tts):
    from tests.test_torch_port_runner import _checkpoint
    (a, meta_a), (b, meta_b) = (_checkpoint(tts["root"] / r) for r in (
        "exp_fs2", "exp_fs2_resumed"))
    assert meta_a["epoch"] == meta_b["epoch"] == 2
    # exp_fs2's duration bias was set after training
    a["net"]["duration_predictor.pred_head.bias"] = \
        b["net"]["duration_predictor.pred_head.bias"]
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys() and len(la) > 100
    for k, v in la.items():
        if torch.is_tensor(v):
            assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k
    assert meta_a["tracker"] == meta_b["tracker"]


def _test_run(tts, name, result, extra="", monkeypatch=None):
    """``--test`` of ``name`` (a config with ``extra`` in its infer_cfg) on
    ``result``'s latest model, JAX's Griffin-Lim phases patched in; the
    runner's Griffin-Lim calls (recovered features, waves)."""
    root = tts["root"]
    path = tts["cfgs"][name]
    if extra:
        path = root / f"{name}_{abs(hash(extra))}.yaml"
        path.write_text((FS2_YAML if name == "fs2" else AR_YAML)
                        % dict(extra=extra))
    waves = chip_smoke.WaveSpy()
    monkeypatch.setattr(tgl, "draw_phases", jax_phases)
    with waves.watching():
        res = run(path, result, "--test")
    return res, waves.calls, _cfg(path)


JAX_FS2 = {}                # one compiled forward for the FastSpeech2 tests


def _jax_fs2(cfg, sd, batches, alphas_for=None):
    """JAX's FastSpeech2 forward (the runner's, runner.py:1117-1151) and
    ``recover_feat`` on the bridged weights, then ``logmel_to_wave`` from
    its default phases, for each batch; absent alphas are ones (an exact
    product)."""
    jnet, jcfg, _ = jbuild_model(cfg["train_cfg"]["model"], batches[1])
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(sd))
    infer = runner.expand_infer_cfg(cfg["infer_cfg"])[""]
    if "f" in JAX_FS2:
        return [JAX_FS2["f"](variables, *args) for args in _fs2_args(
            batches[0], alphas_for)]

    def fwd(v, text, text_len, da, pa, ea):
        out = jnet.apply(v, text, text_len, train=False,
                         max_frames=infer["max_frames"],
                         min_frame_num=infer["min_frame_num"],
                         max_frame_num=infer["max_frame_num"],
                         duration_alpha=da, pitch_alpha=pa,
                         energy_alpha=ea,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        feat = jnet.apply(v, out["pred_after"], method=jnet.recover_feat)
        wave, wave_len = jgl.logmel_to_wave(feat, out["pred_feat_len"],
                                            jcfg.frontend,
                                            n_iter=infer["gl_iters"])
        return feat, out["pred_feat_len"], wave, wave_len

    JAX_FS2["f"] = quick_jit(fwd)
    return _jax_fs2(cfg, sd, batches, alphas_for)


def _fs2_args(batches, alphas_for):
    for b in batches:
        text = jnp.asarray(b["text"])
        ones = jnp.ones(text.shape)
        al = alphas_for(text.shape) if alphas_for else {}
        yield (text, jnp.asarray(b["text_len"]),
               al.get("duration_alpha", ones), al.get("pitch_alpha", ones),
               al.get("energy_alpha", ones))


def _within(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _held_against(calls, jouts):
    assert len(calls) == len(jouts)
    for call, (feat, feat_len, wave, wave_len) in zip(calls, jouts):
        np.testing.assert_array_equal(call["feat_len"].numpy(),
                                      np.asarray(feat_len))
        _within(call["feat"].numpy(), feat, "features")
        _within(call["wave"].numpy(), wave, "waves")
        np.testing.assert_array_equal(call["wave_len"].numpy(),
                                      np.asarray(wave_len))


def test_fastspeech2_test_matches_jax(tts, monkeypatch):
    root = tts["root"]
    res, calls, cfg = _test_run(tts, "fs2", root / "exp_fs2",
                                monkeypatch=monkeypatch)
    tok, _ = _tokenizers(cfg)
    batches = list(runner.build_data(cfg["data_cfg"], "valid", tok)
                   .epoch(0))
    sd = chip_smoke.saved_net(root / "exp_fs2")
    _held_against(calls, _jax_fs2(cfg, sd, (batches, tok.vocab_size)))
    # every frame count is the durations' (about 6 a token)
    assert min(int(x) for c in calls for x in c["feat_len"][:4]) > 20

    # the scores: utils/tts_eval on the synthesized waves, the written
    # waves those waves in 16-bit PCM
    from speechain_tpu_torch.utils import tts_eval
    out = root / "exp_fs2" / "latest" / "valid"
    wavs = read_idx2data_file(str(out / "idx2wav"))
    mcd = read_idx2data_file(str(out / "idx2mcd"))
    f0 = read_idx2data_file(str(out / "idx2log_f0_rmse"))
    assert len(wavs) == SETS[1][1] and set(res) == {"valid"}
    refs = read_idx2data_file(str(root / chip_smoke.FS2_DATA / "dev" /
                                  "idx2wav"))
    n = 0
    for b, call in zip(batches, calls):
        for i in range(b["n_real"]):
            idx = b["indices"][i]
            hyp = call["wave"][i][:int(call["wave_len"][i])].numpy()
            written, sr = read_wav(wavs[idx])
            assert sr == 22050 and written.shape == hyp.shape
            # one step of 16-bit PCM
            assert float(np.abs(written - np.clip(hyp, -1, 1)).max()) \
                <= 1.001 / 32768
            # the set's reference audio as the dataset reads it (the
            # recipe's dataset_conf keeps the default sample_rate of 16
            # kHz, so the dataset resamples the 22.05 kHz files, in the JAX
            # package too)
            ref = b["feat"][i, :int(b["feat_len"][i]), 0]
            assert len(ref) < len(read_wav(refs[idx])[0])
            m = tts_eval.mcd(hyp, ref, 22050, device="cpu")
            r = tts_eval.log_f0_rmse(hyp, ref, 22050)
            assert mcd[idx] == f"{m:.3f}" and f0[idx] == f"{r:.3f}"
            n += 1
    assert n == SETS[1][1]
    assert res["valid"]["mcd"] == pytest.approx(
        np.mean([float(v) for v in mcd.values()]), abs=1e-3)
    text = (out / "overall_results.md").read_text()
    assert "mcd" in text and "log_f0_rmse" in text
    assert len(list((out / "wav").glob("*.wav"))) == SETS[1][1]


def test_controllable_alphas_match_jax(tts, monkeypatch):
    """A fixed duration alpha, a per-utterance pitch alpha and a per-token
    energy alpha (seeded dicts): the runner's features against JAX's with
    the same multipliers, the dicts' draws JAX's (passed in through
    ``generate_ctrl_alpha``, keyed by the generator's seed); the port's
    own draws are in range, per utterance or per token, and seeded."""
    root = tts["root"]
    real = nar_tts.generate_ctrl_alpha

    def jax_draws(gen, B, L, **kw):
        if kw.get("alpha") is not None:
            return real(gen, B, L, **kw)
        kw.pop("device", None)
        return torch.from_numpy(np.array(jgenerate_ctrl_alpha(
            jax.random.PRNGKey(gen.initial_seed()), B, L, **kw)))

    pitch = dict(alpha_min=0.7, alpha_max=1.3, granularity="utterance",
                 seed=4)
    energy = dict(alpha_min=0.5, alpha_max=1.5, granularity="token", seed=5)
    extra = (", duration_alpha: 1.3, pitch_alpha: {alpha_min: 0.7, "
             "alpha_max: 1.3, granularity: utterance, seed: 4}, "
             "energy_alpha: {alpha_min: 0.5, alpha_max: 1.5, granularity: "
             "token, seed: 5}")
    monkeypatch.setattr(nar_tts, "generate_ctrl_alpha", jax_draws)
    _, calls, cfg = _test_run(tts, "fs2", root / "exp_fs2", extra,
                              monkeypatch=monkeypatch)
    tok, _ = _tokenizers(cfg)
    batches = list(runner.build_data(cfg["data_cfg"], "valid", tok)
                   .epoch(0))
    sd = chip_smoke.saved_net(root / "exp_fs2")

    def alphas_for(shape):
        B, L = shape
        return dict(
            duration_alpha=jgenerate_ctrl_alpha(None, B, L, alpha=1.3),
            pitch_alpha=jgenerate_ctrl_alpha(jax.random.PRNGKey(4), B, L,
                                             **{k: v for k, v in
                                                pitch.items()
                                                if k != "seed"}),
            energy_alpha=jgenerate_ctrl_alpha(jax.random.PRNGKey(5), B, L,
                                              **{k: v for k, v in
                                                 energy.items()
                                                 if k != "seed"}))

    jouts = _jax_fs2(cfg, sd, (batches, tok.vocab_size), alphas_for)
    _held_against(calls, jouts)
    plain = _jax_fs2(cfg, sd, (batches, tok.vocab_size))
    # the duration alpha lengthens the utterances (up to max_frames)
    longer = [int(a[1][i]) - int(p[1][i]) for a, p in zip(jouts, plain)
              for i in range(a[1].shape[0])]
    assert min(longer) >= 0 and max(longer) > 0

    # the port's own draws
    monkeypatch.setattr(nar_tts, "generate_ctrl_alpha", real)
    got = runner.tts_alphas(dict(pitch_alpha=pitch, energy_alpha=energy,
                                 duration_alpha=0.9), 3, 7, "cpu")
    assert torch.equal(got["duration_alpha"], torch.full((3, 7), 0.9))
    p, e = got["pitch_alpha"], got["energy_alpha"]
    assert bool((p == p[:, :1]).all()) and p[:, 0].unique().numel() == 3
    assert e.unique().numel() == 21
    assert 0.7 <= float(p.min()) and float(p.max()) < 1.3
    assert 0.5 <= float(e.min()) and float(e.max()) < 1.5
    again = runner.tts_alphas(dict(pitch_alpha=pitch), 3, 7, "cpu")
    assert torch.equal(again["pitch_alpha"], p)


def test_artts_test_and_weight_quant(tts, monkeypatch):
    """The Transformer-TTS ``--test`` against JAX's KV-cached synthesizer
    (``stop_threshold`` 0.5, ``maxlen_ratio`` 10, ``max_frames`` 24: every
    row runs to 24 steps); the ``weight_quant: int8`` run on a copy of the
    checkpoint against a direct ``make_artts_synthesizer`` on the
    dequantized weights and JAX's synthesizer on JAX's quantized
    weights."""
    from speechain_tpu_torch.infer.quantize import (dequantize_state_dict,
                                                    quantize_state_dict)
    from speechain_tpu_torch.infer.tts import make_artts_synthesizer
    root = tts["root"]
    res, calls, cfg = _test_run(tts, "ar", root / "exp_ar",
                                monkeypatch=monkeypatch)
    shutil.copytree(root / "exp_ar" / "checkpoint",
                    root / "exp_ar_int8" / "checkpoint")
    res_q, calls_q, cfg_q = _test_run(tts, "ar", root / "exp_ar_int8",
                                      ", weight_quant: int8, "
                                      "weight_quant_min_elems: 2048",
                                      monkeypatch=monkeypatch)
    assert set(res) == set(res_q) == {"valid"}
    log = (root / "exp_ar_int8" / "test.log").read_text()
    assert "weight_quant=int8: resident variables" in log
    tok, _ = _tokenizers(cfg)
    batches = list(runner.build_data(cfg["data_cfg"], "valid", tok)
                   .epoch(0))
    sd = chip_smoke.saved_net(root / "exp_ar")
    jnet, _, _ = jbuild_model(cfg["train_cfg"]["model"], tok.vocab_size)
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(sd))
    qvars = dequantize_variables(quantize_variables(variables,
                                                    min_elems=2048))

    def synth(v, text, text_len):
        out = tts_auto_regression(jnet, v, text, text_len,
                                  stop_threshold=0.5, maxlen_ratio=10.0,
                                  max_frames=24)
        feat = jnet.apply(v, out["hypo_feat"], method=jnet.recover_feat)
        return feat, out["hypo_feat_len"]

    # the features (Griffin-Lim is held in the FastSpeech2 tests and by
    # the direct call below)
    f = quick_jit(synth)
    for v, got in ((variables, calls), (qvars, calls_q)):
        for b, call in zip(batches, got):
            feat, feat_len = f(v, jnp.asarray(b["text"]),
                               jnp.asarray(b["text_len"]))
            np.testing.assert_array_equal(call["feat_len"].numpy(),
                                          np.asarray(feat_len))
            _within(call["feat"].numpy(), feat, "features")
    # the int8 features move off the float ones, and a direct call on the
    # dequantized weights gives them bit for bit
    assert max(float((a["feat"] - b["feat"]).abs().max())
               for a, b in zip(calls, calls_q)) > 0
    net, _, _ = build_model(cfg["train_cfg"]["model"], tok.vocab_size)
    net.load_state_dict(dequantize_state_dict(quantize_state_dict(
        sd, 2048, params={n for n, _ in net.named_parameters()})))
    monkeypatch.setattr(tgl, "draw_phases", jax_phases)
    direct = make_artts_synthesizer(net, "gl", device="cpu",
                                    stop_threshold=0.5, maxlen_ratio=10.0,
                                    max_frames=24, gl_iters=4)
    for b, call in zip(batches, calls_q):
        d = direct(torch.from_numpy(b["text"]),
                   torch.from_numpy(b["text_len"]))
        assert d["steps"] == 24
        assert torch.equal(net.recover_feat(d["hypo_feat"]), call["feat"])
        assert torch.equal(d["wave"], call["wave"])
    for r in ("exp_ar", "exp_ar_int8"):
        out = root / r / "latest" / "valid"
        for f_ in ("idx2wav", "idx2mcd", "idx2log_f0_rmse",
                   "overall_results.md"):
            assert (out / f_).exists(), (r, f_)
