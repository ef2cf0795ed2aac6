"""The port's speaker encoders, LogMelFrontend and delta features against
the JAX package's, on the CPU.

``speechain_tpu_torch/nn/speaker.py`` against ``speechain_tpu/nn/speaker.py``
(ECAPA and x-vector, with and without lengths; the SE gate and the
Res2Block alone), the weight bridge ``utils/weights.py::speaker_from_flax``
and its round trip through the JAX package's ``load_torch_speaker``, a
``.pt`` in the reference's layout through ``load_speaker_encoder``;
``ops/frontend.py::LogMelFrontend`` at the ASR frontend and the two
evaluation frontends (``utils/tts_eval.py``: 50 ms / 12.5 ms at 16 and
22.05 kHz); ``ops/delta.py``. Seeded numpy inputs, float32.

Tolerances: the encoders' embeddings and the SE / Res2Block outputs 1e-5
absolute (unit-norm embeddings; sums of at most 560 products a
convolution); log-Mel 1e-4 absolute (the frontend's contract) and the
linear spectrogram 1e-5 of its largest power; the deltas 1e-6 (five-tap
filters of unit-scale features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.nn import speaker as jspk
from speechain_tpu.ops import delta as jdelta
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu.ops.frontend import LogMelFrontend as JLogMel
from speechain_tpu_torch.nn import speaker as tspk
from speechain_tpu_torch.ops import delta as tdelta
from speechain_tpu_torch.ops.frontend import FrontendConfig as TFE
from speechain_tpu_torch.ops.frontend import LogMelFrontend as TLogMel
from speechain_tpu_torch.utils.weights import (random_state_dict,
                                               speaker_from_flax)

EMB_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, name=""):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol, (name, err, tol)


def _port_encoder(model_type, seed):
    net = tspk.EncoderClassifier(model_type)
    net.load_state_dict(random_state_dict(net, seed), strict=True)
    return net


@pytest.mark.parametrize("model_type", ["ecapa", "xvector"])
@pytest.mark.parametrize("with_len", [False, True])
def test_encoder_matches_jax(model_type, with_len):
    """(3, 61, 80) features; with lengths, one row masked to 40 frames and
    one to 0 (its mean over max(0, 1) frames)."""
    net = _port_encoder(model_type, seed=1)
    variables = jspk.load_torch_speaker(
        {k: v.numpy() for k, v in net.state_dict().items()}, model_type)
    feat = np.random.default_rng(0).normal(size=(3, 61, 80)).astype(
        np.float32)
    lens = np.array([61, 40, 0], np.int32) if with_len else None
    want = jspk.EncoderClassifier(model_type=model_type).apply(
        variables, jnp.asarray(feat),
        None if lens is None else jnp.asarray(lens))
    with torch.no_grad():
        got = net(_t(feat), None if lens is None else _t(lens))
    assert got.shape == (3, 192)
    _close(got, want, EMB_TOL, model_type)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    ext = tspk.extract_spk_feat(model_type, net.state_dict(), _t(feat),
                                None if lens is None else _t(lens))
    np.testing.assert_array_equal(ext.numpy(), got.numpy())


def test_se_and_res2block_match_jax():
    """The SE gate and the Res2Block alone at 64 channels (scale 8, so
    8-wide splits), channels last on the JAX side."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 23, 64)).astype(np.float32)
    se_j = jspk.SEModule(channels=64, bottleneck=16)
    v = _np_tree(se_j.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    se_t = tspk.SEModule(64, bottleneck=16)
    conv = lambda p: dict(weight=_t(p["kernel"].transpose(2, 1, 0)),  # noqa
                          bias=_t(p["bias"]))
    se_t.se[1].load_state_dict(conv(v["params"]["se_fc1"]))
    se_t.se[3].load_state_dict(conv(v["params"]["se_fc2"]))
    with torch.no_grad():
        got = se_t(_t(x).transpose(1, 2)).transpose(1, 2)
    _close(got, se_j.apply(v, jnp.asarray(x)), EMB_TOL, "se")

    rb_j = jspk.Res2Block(channels=64)
    v = _np_tree(rb_j.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    rb_t = tspk.Res2Block(64)
    for i, c in enumerate(rb_t.convs):
        c.load_state_dict(conv(v["params"][f"conv_{i}"]))
    with torch.no_grad():
        got = rb_t(_t(x).transpose(1, 2)).transpose(1, 2)
    _close(got, rb_j.apply(v, jnp.asarray(x)), EMB_TOL, "res2block")


@pytest.mark.parametrize("model_type", ["ecapa", "xvector"])
def test_speaker_weight_bridge_round_trip(model_type):
    """flax variables (random, with non-trivial BatchNorm statistics) ->
    speaker_from_flax -> the port's module (strict) -> its state dict ->
    JAX's load_torch_speaker gives the same variables back, and both
    encoders give the same embeddings."""
    model = jspk.EncoderClassifier(model_type=model_type)
    feat = np.random.default_rng(3).normal(size=(2, 30, 80)).astype(
        np.float32)
    v = _np_tree(model.init(jax.random.PRNGKey(2), jnp.asarray(feat)))
    rng = np.random.default_rng(4)
    for stats in v["batch_stats"].values():
        stats["mean"] = 0.3 * rng.standard_normal(stats["mean"].shape
                                                  ).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape
                                   ).astype(np.float32)
    net = tspk.EncoderClassifier(model_type)
    net.load_state_dict(speaker_from_flax(v, model_type), strict=True)
    back = _np_tree(jspk.load_torch_speaker(
        {k: t.numpy() for k, t in net.state_dict().items()}, model_type))
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))
    with torch.no_grad():
        got = net(_t(feat))
    _close(got, model.apply(v, jnp.asarray(feat)), EMB_TOL, "bridged")


def test_load_speaker_encoder_reads_the_reference_layout(tmp_path):
    """A .pt saved from the reference's torch nn.Sequential (with its
    num_batches_tracked) loads strictly; the port's embeddings equal the
    reference module's and the JAX package's restore of the same file.
    An orbax directory is refused."""
    from test_speaker_interop import _torch_model
    holder = _torch_model("ecapa")
    ckpt = tmp_path / "encoder.pth"
    torch.save(holder.state_dict(), ckpt)
    net, sd = tspk.load_speaker_encoder(str(ckpt), "ecapa")
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    feat = np.random.default_rng(5).normal(size=(2, 50, 80)).astype(
        np.float32)
    with torch.no_grad():
        got = net(_t(feat))
        ref = torch.nn.functional.normalize(
            holder.model(_t(feat).transpose(1, 2)), dim=1)
    _close(got, ref, EMB_TOL, "reference module")
    v = jspk.restore_speaker_variables(str(ckpt), "ecapa")
    _close(got, jspk.EncoderClassifier().apply(v, jnp.asarray(feat)),
           EMB_TOL, "jax restore")
    np.testing.assert_array_equal(
        tspk.restore_speaker_variables(str(ckpt))["model.0.weight"].numpy(),
        sd["model.0.weight"].numpy())
    with pytest.raises(NotImplementedError, match="A6"):
        tspk.restore_speaker_variables(str(tmp_path))


FRONTENDS = {
    "asr": dict(n_mels=80, preemphasis=0.97),
    "eval16k": dict(n_mels=80, sr=16000, win_length=0.05,
                    hop_length=0.0125),
    "eval22k": dict(n_mels=80, sr=22050, win_length=0.05,
                    hop_length=0.0125),
}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_logmel_frontend_matches_jax(name):
    """__call__, linear_spectrogram, num_frames and output_size on two
    utterances of tones and noise, one 1,234 samples short; the energy
    config returns the four outputs."""
    kw = FRONTENDS[name]
    jfe, tfe = JLogMel(JFE(**kw)), TLogMel(TFE(**kw))
    sr = tfe.cfg.sr
    L = int(0.6 * sr) + 1
    t = np.arange(L) / sr
    rng = np.random.default_rng(6)
    # a tone with noise under it: a pure tone leaves bins within float32
    # rounding of the 1e-10 clamp, where either side's DFT moves the log
    # by ~1e-3
    wave = np.stack([0.3 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.01 * rng.standard_normal(L),
                     0.1 * rng.standard_normal(L)]).astype(np.float32)
    lens = np.array([L, L - 1234], np.int32)
    feat, feat_len = tfe(_t(wave), _t(lens))
    jfeat, jlen = jfe(jnp.asarray(wave), jnp.asarray(lens))
    np.testing.assert_array_equal(feat_len.numpy(), np.asarray(jlen))
    _close(feat, jfeat, 1e-4, "logmel")
    np.testing.assert_array_equal(tfe.num_frames(_t(lens)).numpy(),
                                  np.asarray(jfe.num_frames(
                                      jnp.asarray(lens))))
    assert tfe.output_size == jfe.output_size == 80
    lin, lin_len = tfe.linear_spectrogram(_t(wave), _t(lens))
    jlin, _ = jfe.linear_spectrogram(jnp.asarray(wave), jnp.asarray(lens))
    assert lin.shape[-1] == tfe.cfg.n_freqs
    _close(lin, jlin, 1e-5 * float(np.abs(np.asarray(jlin)).max()), "linear")
    efe = TLogMel(TFE(**kw, return_energy=True))
    out = efe(_t(wave), _t(lens))
    jout = JLogMel(JFE(**kw, return_energy=True))(jnp.asarray(wave),
                                                  jnp.asarray(lens))
    assert len(out) == len(jout) == 4
    _close(out[2], jout[2], 1e-4 * float(np.abs(np.asarray(jout[2])).max()),
           "energy")


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_add_delta_features_matches_jax(order, n):
    feat = np.random.default_rng(7).normal(size=(2, 17, 5)).astype(
        np.float32)
    lens = np.array([17, 9], np.int32)
    np.testing.assert_array_equal(tdelta.delta_filter(n),
                                  jdelta.delta_filter(n))
    got, got_len = tdelta.add_delta_features(_t(feat), _t(lens),
                                             delta_order=order, delta_N=n)
    want, _ = jdelta.add_delta_features(jnp.asarray(feat), jnp.asarray(lens),
                                        delta_order=order, delta_N=n)
    assert got.shape == (2, 17, 5 * (1 + order))
    assert got_len is not None and got_len.tolist() == [17, 9]
    _close(got, want, 1e-6, f"delta {order} N {n}")
