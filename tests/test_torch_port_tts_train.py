"""The port's FastSpeech2 training against the JAX package's, on the CPU.

Every flax module's variables come from ``jax.eval_shape`` of its init,
filled with seeded numpy values and bridged with ``from_flax_variables``;
both sides run on the same numpy inputs in float32 at dropout 0 (the two
packages draw dropout masks from different generators). The JAX side runs
its XLA paths: on the CPU neither its FFN nor its attention takes a Pallas
kernel, and the port's kernels take their plain versions on CPU tensors.

Sizes: d 32, 1 + 1 layers, vocabulary 20, 3 utterances of 10, 8 and 6
tokens, waveforms at the LJSpeech recipe's frontend (22.05 kHz, n_fft
1102, hop 275, 80 mels, energy) of 40, 33 and 26 frames, teacher
durations with zeros among them.

Tolerances: single modules 1e-5 absolute on outputs and 1e-4 of each
gradient's largest magnitude (float32 rounding of the convolutions'
sums); the targets 1e-4 of each array's largest magnitude (the frontend's
DFT and mel products sum 1102 and 552 terms in a different order);
integer durations exactly; losses 1e-4 relative and, after three steps,
parameters and running statistics within 1e-4 of each array's largest
magnitude, as the ASR step's test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

KEY = jax.random.PRNGKey(0)
V, D, B = 20, 32, 3
TOKENS = (10, 8, 6)
SAMPLES = (39 * 275, 9000, 7000)          # 40, 33 and 26 frames
OPT = dict(optim_conf=dict(lr=1e-3, betas=(0.9, 0.98), eps=1e-9),
           warmup_steps=6000)             # the recipe's Noam / Adam


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def quick_jit(f):
    """``jax.jit(f)``, compiled at its first call at XLA's backend
    optimization level 0 and reused: each function here runs a few times
    at a tiny size, where the optimizing passes are most of the cost (the
    JAX step compiles in ~4 s instead of ~6), and its results stay within
    float32 rounding of the default level's."""
    jf, compiled = jax.jit(f), []

    def run(*args):
        if not compiled:
            compiled.append(jf.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)

    return run


def randomize(variables, seed):
    """Seeded numpy values for a variables tree: kernels ~ N(0, 1/fan_in),
    scales near 1, BatchNorm variances in [0.5, 1.5], feature norms
    unseen (zero means, unit stds), others small."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", getattr(path[-1], "name", "")))
        if x.dtype == bool:
            return np.zeros(x.shape, bool)
        if name == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("std", "aver_std"):
            v = np.ones(x.shape)
        elif name in ("batch", "mean", "aver_mean") and len(path) > 2 and \
                str(getattr(path[0], "key", "")) == "norm_stats":
            v = np.zeros(x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name in ("kernel", "embedding"):
            fan_in = int(np.prod(x.shape[:-1])) if name == "kernel" else 1
            v = rng.standard_normal(x.shape) / np.sqrt(max(fan_in, 1))
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def init_vars(module, *args, seed=0, **kw):
    return randomize(jax.eval_shape(
        lambda *a: module.init({"params": KEY, "dropout": KEY}, *a, **kw),
        *args), seed)


def bridge(tmod, variables):
    tmod.load_state_dict(from_flax_variables(variables), strict=True)
    return tmod.train()


def within(got, want, rel, name=""):
    """max |got - want| <= rel x max(max |want|, 1e-6)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-6), (
        name, err, float(np.abs(want).max()))


def jax_vjp(jmod, v, args, ct_seed, mutable=(), ct_mask=None, **kw):
    """One jitted training-mode forward and VJP of a flax module at
    variables ``v``: (output, parameter gradients bridged to the port's
    names, gradients of the float ``args``, updated collections bridged,
    cotangent)."""
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    rest = {k: w for k, w in jv.items() if k != "params"}
    muts = [m for m in mutable if m in v]
    fl = [i for i, a in enumerate(args) if np.issubdtype(a.dtype,
                                                         np.floating)]

    def f(params, *xs):
        full = list(map(jnp.asarray, args))
        for i, x in zip(fl, xs):
            full[i] = x
        out, new = jmod.apply({"params": params, **rest}, *full, train=True,
                              mutable=muts, **kw)
        return (out[0] if isinstance(out, tuple) else out), new

    out_shape = jax.eval_shape(f, jv["params"], *[args[i] for i in fl])[0]
    ct = np.random.default_rng(ct_seed).standard_normal(
        out_shape.shape).astype(np.float32)
    if ct_mask is not None:
        ct = ct * ct_mask

    @quick_jit
    def run(params, ctj, *xs):
        out, pull, new = jax.vjp(f, params, *xs, has_aux=True)
        return out, pull(ctj), new

    out, (gp, *gx), new = run(jv["params"], jnp.asarray(ct),
                              *[jnp.asarray(args[i]) for i in fl])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (np.asarray(out), from_flax_variables({"params": to_np(gp)}),
            [np.asarray(g) for g in gx], from_flax_variables(to_np(new)), ct)


def assert_module_matches(jmod, tmod, args, seed, mutable=("batch_stats",),
                          out_mask=None, **kw):
    """The port's module in training mode against the flax module: output
    (1e-5 absolute), float inputs' and every parameter's gradient (1e-4 of
    the gradient's largest magnitude, or of a thousandth of the module's
    largest gradient where the gradient is zero up to rounding) and the
    updated running statistics (1e-5 relative). Returns the bridged
    statistics."""
    v = jax.tree_util.tree_map(np.asarray, init_vars(
        jmod, *map(jnp.asarray, args), seed=seed, train=False, **kw))
    jout, jgrads, jgx, jstate, ct = jax_vjp(jmod, v, args, seed + 7,
                                            mutable, out_mask, **kw)
    tmod = bridge(tmod, v)
    targs = [_t(a).requires_grad_(np.issubdtype(a.dtype, np.floating))
             for a in args]
    tout = tmod(*targs, **kw) if kw else tmod(*targs)
    tout = tout[0] if isinstance(tout, tuple) else tout
    tout.backward(_t(ct))
    m = np.ones(jout.shape, bool) if out_mask is None else out_mask
    np.testing.assert_allclose(tout.detach().numpy() * m, jout * m,
                               atol=1e-5, rtol=0)
    for g, w in zip([a.grad for a in targs if a.requires_grad], jgx):
        within(g, w, 1e-4, "input gradient")
    tgrads = dict(tmod.named_parameters())
    assert sorted(jgrads) == sorted(tgrads)
    gscale = max(float(g.abs().max()) for g in jgrads.values())
    for n, g in jgrads.items():
        tg = tgrads[n].grad            # None: the output does not read it
        err = float(((tg if tg is not None else 0.0) - g).abs().max())
        assert err <= 1e-4 * max(float(g.abs().max()), 1e-3 * gscale), (
            n, err)
    for n, st in jstate.items():
        within(tmod.state_dict()[n], st.numpy(), 1e-5, n)
    return jstate


# ------------------------------------------------------------- criteria

@pytest.mark.parametrize("loss_type,normalized,ndim", [
    ("L1", True, 3), ("L2", True, 2), ("L1+L2", True, 3), ("L2", False, 3)])
def test_least_error_matches_jax(loss_type, normalized, ndim):
    from speechain_tpu.train.criteria import least_error as jle
    from speechain_tpu_torch.train.criteria import least_error
    rng = np.random.default_rng(1)
    shape = (3, 11, 5)[:ndim]
    p, t = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    n = np.array([11, 4, 0], np.int32)
    want = jle(jnp.asarray(p), jnp.asarray(t), jnp.asarray(n),
               loss_type=loss_type, is_normalized=normalized)
    got = least_error(_t(p), _t(t), _t(n), loss_type=loss_type,
                      is_normalized=normalized)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("pos_weight", [1.0, 5.0])
def test_bce_logits_and_fbeta_match_jax(pos_weight):
    from speechain_tpu.train.criteria import bce_logits as jbce
    from speechain_tpu.train.criteria import fbeta_score as jfb
    from speechain_tpu_torch.train.criteria import bce_logits, fbeta_score
    rng = np.random.default_rng(2)
    x = 3 * rng.standard_normal((3, 9)).astype(np.float32)
    y = (rng.random((3, 9)) < 0.3).astype(np.float32)
    pred = (rng.random((3, 9)) < 0.4).astype(np.int32)
    n = np.array([9, 5, 0], np.int32)
    want = jbce(jnp.asarray(x), jnp.asarray(y), jnp.asarray(n),
                pos_weight=pos_weight)
    got = bce_logits(_t(x), _t(y), _t(n), pos_weight=pos_weight)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for beta in (1.0, 2.0):
        want = jfb(jnp.asarray(pred), jnp.asarray(y.astype(np.int32)),
                   jnp.asarray(n), beta=beta)
        got = fbeta_score(_t(pred), _t(y.astype(np.int32)), _t(n), beta=beta)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------- modules in training

def _module_pair(name):
    """(JAX module, port module, input) of one TTS module at small size."""
    import speechain_tpu.nn.feed_forward as jff
    import speechain_tpu.nn.postnets as jpo
    import speechain_tpu.nn.prenets as jpr
    import speechain_tpu_torch.nn.feed_forward as tff
    import speechain_tpu_torch.nn.postnets as tpo
    import speechain_tpu_torch.nn.prenets as tpr
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 13, 16)).astype(np.float32)
    if name == "postnet":
        kw = dict(conv_dims=[12, 12], conv_kernel=5, conv_dropout=0.0)
        return jpo.Conv1dPostnet(feat_dim=16, **kw), \
            tpo.Conv1dPostnet(16, **kw), x
    if name == "prenet":
        kw = dict(conv_dims=[12, 12], conv_kernel=3, conv_dropout=0.0)
        return jpr.Conv1dPrenet(**kw), tpr.Conv1dPrenet(16, **kw), x
    if name == "var_predictor":
        kw = dict(conv_dims=[12, 12], conv_kernel=3, conv_dropout=0.0,
                  use_gate=True)
        return jpr.Conv1dVarPredictor(**kw), \
            tpr.Conv1dVarPredictor(16, **kw), x
    if name == "conv_ffn":
        kw = dict(fdfwd_dim=24, fdfwd_type="conv", dropout=0.0,
                  fdfwd_args=dict(kernel_size=9))
        return jff.PositionwiseFeedForward(d_model=16, **kw), \
            tff.PositionwiseFeedForward(16, **kw), x
    if name == "scalar_embed":
        return _NoTrain(jpr.ScalarEmbedConv(out_dim=16)), \
            tpr.ScalarEmbedConv(16), x[..., 0]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["postnet", "prenet", "var_predictor",
                                  "conv_ffn", "scalar_embed"])
def test_tts_module_in_training_matches_jax(name):
    """Forward, input and parameter gradients, and (postnet, prenet) the
    BatchNorm running statistics after one training-mode call."""
    jmod, tmod, x = _module_pair(name)
    state = assert_module_matches(jmod, tmod, [x], seed=4)
    assert bool(state) == (name in ("postnet", "prenet"))


def test_embedding_and_speaker_prenets_in_training_match_jax():
    """EmbedPrenet (scaled) and SpeakerEmbedPrenet (lookup and external
    embeddings, concatenated): outputs and gradients."""
    from speechain_tpu.nn.prenets import EmbedPrenet as JE
    from speechain_tpu.nn.prenets import SpeakerEmbedPrenet as JS
    from speechain_tpu_torch.nn.prenets import EmbedPrenet, SpeakerEmbedPrenet
    rng = np.random.default_rng(5)
    text = rng.integers(0, V, (3, 7)).astype(np.int32)
    assert_module_matches(_NoTrain(JE(vocab_size=V, embedding_dim=D,
                                      scale=True)),
                          EmbedPrenet(V, D, scale=True), [text], seed=5)
    kw = dict(d_model=D, spk_num=3, spk_emb_dim_pretrained=6)
    args = [rng.standard_normal((3, 7, D)).astype(np.float32),
            np.array([2, 0, 1], np.int32),
            rng.standard_normal((3, 6)).astype(np.float32)]
    assert_module_matches(_NoTrain(JS(**kw)), SpeakerEmbedPrenet(**kw), args,
                          seed=6)


class _NoTrain:
    """A flax module whose ``__call__`` takes no ``train`` flag, seen
    through the interface ``assert_module_matches`` calls."""

    def __init__(self, mod):
        self.mod = mod

    def init(self, rngs, *a, train=False, **kw):
        return self.mod.init(rngs, *a, **kw)

    def apply(self, v, *a, train=False, mutable=(), **kw):
        return self.mod.apply(v, *a, **kw), {}


def test_tts_encoder_in_training_matches_jax():
    """TTSEncoder (embedding, BatchNorm Conv1d prenet, one transformer
    layer with the 'conv' FFN) with ``train=True``: the encoding at the
    valid positions, parameter gradients and the prenet's running
    statistics."""
    from speechain_tpu.models.ar_tts import TTSEncoder as JT
    from speechain_tpu_torch.models.ar_tts import TTSEncoder
    rng = np.random.default_rng(6)
    text = rng.integers(1, V, (3, 9)).astype(np.int32)
    text_len = np.array([9, 7, 4], np.int32)
    enc = dict(d_model=D, num_heads=2, num_layers=1, fdfwd_dim=48,
               fdfwd_type="conv", fdfwd_args=dict(kernel_size=9),
               att_dropout=0.0, fdfwd_dropout=0.0, res_dropout=0.0,
               posenc_dropout=0.0)
    kw = dict(vocab_size=V, emb=dict(embedding_dim=D),
              prenet=dict(conv_dims=[D, D], conv_kernel=3), encoder=enc)
    mask = (np.arange(9)[None] < text_len[:, None])[..., None]
    state = assert_module_matches(
        JT(**kw), TTSEncoder(V, kw["emb"], kw["prenet"], enc),
        [text, text_len], seed=7, out_mask=mask)
    assert len(state) == 4


# ------------------------------------------------------------ the network

def configs(enc_ffn=("conv", 2), dec_ffn=("conv", 2), spk=False, gate=False,
            prenet=False, r=1):
    """The JAX and port FastSpeech2Config of one case (dropout 0); the
    encoder's and decoder's FFN type and head count are given apart."""
    from speechain_tpu.models.nar_tts import FastSpeech2Config as JC
    from speechain_tpu.ops.feat_norm import FeatNormConfig as JF
    from speechain_tpu.ops.frontend import FrontendConfig as JFE
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Config as TC
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig as TF
    from speechain_tpu_torch.ops.frontend import FrontendConfig as TFE

    def layer(ffn, heads):
        out = dict(d_model=D, num_heads=heads, num_layers=1,
                   fdfwd_dim=2 * D, fdfwd_type=ffn, att_dropout=0.0,
                   fdfwd_dropout=0.0, res_dropout=0.0, posenc_dropout=0.0)
        if ffn == "conv":
            out["fdfwd_args"] = {"kernel_size": 9}
        return out

    fe = dict(sr=22050, n_mels=80, win_length=0.05, hop_length=0.0125,
              fmin=125.0, fmax=7600.0, return_energy=True)
    pred = dict(conv_dims=[16, 16], conv_kernel=3, conv_dropout=0.0)
    kw = dict(vocab_size=V, enc_emb=dict(embedding_dim=D),
              enc_prenet=(dict(conv_dims=[D, D], conv_kernel=3)
                          if prenet else {}),
              encoder=layer(*enc_ffn), decoder=layer(*dec_ffn),
              duration_predictor=dict(pred, use_gate=gate),
              pitch_predictor=pred, energy_predictor=pred,
              postnet=dict(conv_dims=[16, 16], conv_kernel=5,
                           conv_dropout=0.0),
              spk_emb=dict(spk_num=3) if spk else None,
              reduction_factor=r)
    norms = lambda F: dict(feat_norm=F(feat_dim=80),          # noqa: E731
                           pitch_norm=F(feat_dim=1),
                           energy_norm=F(feat_dim=1))
    return (JC(frontend=JFE(**fe), **norms(JF), **kw),
            TC(frontend=TFE(**fe), **norms(TF), **kw))


def batch(zero_durations=False, spk=False):
    """3 utterances: waveforms (B, L, 1), frame-level pitch, teacher
    durations (zeros past each text; with ``zero_durations`` a few inner
    zeros too)."""
    rng = np.random.default_rng(8)
    L = max(SAMPLES)
    t = np.arange(L) / 22050.0
    wave = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(L)
                     for f in (220.0, 330.0, 180.0)]).astype(np.float32)
    wave_len = np.array(SAMPLES, np.int32)
    for i, n in enumerate(SAMPLES):
        wave[i, n:] = 0.0
    T = L // 275 + 1
    frames = np.array([n // 275 + 1 for n in SAMPLES], np.int32)
    pitch = (150 + 50 * rng.random((B, T))).astype(np.float32)
    pitch *= (np.arange(T)[None] < frames[:, None])
    text = np.zeros((B, max(TOKENS)), np.int32)
    dur = np.zeros((B, max(TOKENS)), np.float32)
    for i, n in enumerate(TOKENS):
        text[i, :n] = rng.integers(1, V, n)
        dur[i, :n] = rng.integers(1, 7, n)
    if zero_durations:
        dur[0, [2, 5]] = 0.0
        dur[1, 0] = 0.0
    out = dict(text=text, text_len=np.array(TOKENS, np.int32),
               feat=wave[..., None], feat_len=wave_len, pitch=pitch,
               pitch_len=frames, duration=dur,
               duration_len=np.array(TOKENS, np.int32))
    if spk:
        out["spk_ids"] = np.array([0, 2, 1], np.int32)
    return out


def net_variables(jnet, b, seed):
    kw = {} if "spk_ids" not in b else dict(spk_ids=jnp.asarray(b["spk_ids"]))
    args = [jnp.asarray(b[k]) for k in (
        "text", "text_len", "feat", "feat_len", "pitch", "pitch_len",
        "duration", "duration_len")]
    return jax.tree_util.tree_map(np.asarray, init_vars(
        jnet, *args, seed=seed, train=False, **kw))


def test_prepare_targets_matches_jax():
    """Waveform -> log-Mel + energy targets, the three norms' updates in
    training (from seen statistics, so the running averages move), and
    the reduction-factor grouping (r = 2)."""
    from speechain_tpu.models.nar_tts import FastSpeech2Net as JNet
    from speechain_tpu.ops.feat_norm import init_stats
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    jcfg, tcfg = configs(r=2)
    jnet = JNet(cfg=jcfg)
    b = batch()
    rng = np.random.default_rng(9)
    norm_stats = {}
    for name in ("feat_norm", "pitch_norm", "energy_norm"):
        st = init_stats(getattr(jcfg, name))
        dim = st.mean.shape
        norm_stats[name] = {"stats": st._replace(
            mean=rng.standard_normal(dim).astype(np.float32),
            std=rng.uniform(0.5, 2.0, dim).astype(np.float32),
            batch=np.full(st.batch.shape, 2.0, np.float32),
            seen=np.ones(st.seen.shape, bool))}
    args = [b[k] for k in ("feat", "feat_len", "pitch", "pitch_len")]
    want, new = quick_jit(lambda *a: jnet.apply(
        {"norm_stats": norm_stats}, *a, train=True,
        method=JNet.prepare_targets, mutable=["norm_stats"]))(
            *map(jnp.asarray, args))
    net = FastSpeech2Net(tcfg)
    sd = net.state_dict()
    sd.update(from_flax_variables({"norm_stats": norm_stats}))
    net.load_state_dict(sd)
    got = net.train().prepare_targets(*map(_t, args))
    names = ("feat", "feat_len", "pitch", "pitch_len", "energy",
             "energy_len")
    assert got[0].shape == (B, 20, 160) and got[2].shape == (B, 20)
    for n, g, w in zip(names, got, want):
        if n.endswith("_len"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), n)
        else:
            within(g, np.asarray(w), 1e-4, n)
    stats = from_flax_variables(jax.tree_util.tree_map(np.asarray, new))
    assert len(stats) == 18
    for n, st in stats.items():
        g = net.state_dict()[n]
        if st.dtype == torch.bool:
            assert torch.equal(g, st), n
        else:
            within(g, st.numpy(), 1e-4, n)
    assert float(net.state_dict()["energy_norm.stats.batch"][0]) == 3.0


@pytest.mark.parametrize("gate", [False, True])
def test_fastspeech2_loss_matches_jax(gate):
    """fastspeech2_loss on the same outputs: every loss and duration_f1,
    and the gate BCE where the predictor has a gate head."""
    from speechain_tpu.models.nar_tts import fastspeech2_loss as jloss
    from speechain_tpu_torch.models.nar_tts import fastspeech2_loss
    jcfg, tcfg = configs(gate=gate)
    rng = np.random.default_rng(10)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dur = rng.integers(0, 4, (B, 10)).astype(np.float32)
    outs = dict(pred_before=f(B, 40, 80), pred_after=f(B, 40, 80),
                tgt_feat=f(B, 40, 80), tgt_feat_len=np.array([40, 33, 26]),
                pred_pitch=f(B, 10), tgt_pitch=f(B, 10),
                tgt_pitch_len=np.array(TOKENS), pred_energy=f(B, 10),
                tgt_energy=f(B, 10), tgt_energy_len=np.array(TOKENS),
                pred_duration=np.log(dur + 1.0) + f(B, 10),
                pred_duration_gate=f(B, 10) if gate else None,
                tgt_duration_len=np.array(TOKENS))
    jl, jm = quick_jit(lambda o, d: jloss(o, d, jcfg))(
        {k: None if v is None else jnp.asarray(v) for k, v in outs.items()},
        jnp.asarray(dur))
    tl, tm = fastspeech2_loss({k: None if v is None else _t(v)
                               for k, v in outs.items()}, _t(dur), tcfg)
    assert sorted(jm) == sorted(tm)
    assert ("duration_gate_loss" in tm) == gate
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert 0.0 < float(tm["duration_f1"]) < 1.0


# One case runs both FFN types (every JAX step compiles for seconds): the
# recipe's 'conv' FFN with 2 heads in the encoder, bench.py's 'linear' FFN
# with 4 heads in the decoder; zero-duration tokens; a speaker table, whose
# ids the norms take as group ids; a duration gate; a BatchNorm prenet.
STEP_CASE = dict(cfg=dict(enc_ffn=("conv", 2), dec_ffn=("linear", 4),
                          spk=True, gate=True, prenet=True),
                 batch=dict(zero_durations=True, spk=True))


@pytest.fixture(scope="module")
def steps():
    from speechain_tpu.models.nar_tts import FastSpeech2Net as JNet
    from speechain_tpu.train.optim import build_optimizer as jbuild
    from speechain_tpu.train.state import init_train_state as jinit
    from speechain_tpu.train.state import make_fastspeech2_step as jmake
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_fastspeech2_step)
    spec = STEP_CASE
    jcfg, tcfg = configs(**spec["cfg"])
    jnet = JNet(cfg=jcfg)
    b = batch(**spec["batch"])
    v = net_variables(jnet, b, seed=11)
    jtx = jbuild(**OPT)
    jstate = jinit(jax.tree_util.tree_map(jnp.asarray, v), jtx)
    jstep = quick_jit(jmake(jnet, jcfg, jtx, axis_name=None))
    jb = {k: jnp.asarray(x) for k, x in b.items()}
    jlosses = []
    for i in range(3):
        jstate, m = jstep(jstate, jb, jax.random.PRNGKey(i))
        jlosses.append(float(m["loss"]))
    jvars = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, **jstate.mutables})

    net = FastSpeech2Net(tcfg)
    net.load_state_dict(from_flax_variables(v), strict=True)
    tx = build_optimizer(**OPT)
    state = init_train_state(net, tx, device="cpu")
    step = make_fastspeech2_step(net, tcfg, tx, device="cpu")
    tb = {k: _t(x) for k, x in b.items()}
    gen = torch.Generator().manual_seed(0)
    tlosses, tmetrics = [], None
    for _ in range(3):
        state, tmetrics = step(state, tb, gen)
        tlosses.append(float(tmetrics["loss"]))
    return jlosses, jvars, tlosses, state, v, tcfg, tb, tmetrics, m, jstate


def first_moments(net, flat):
    """Adam's flat first moment split into the port's parameter names
    (the order of ``net.parameters()``, as ``init_train_state`` flattens
    them)."""
    out, offset = {}, 0
    for name, p in net.named_parameters():
        out[name] = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    assert offset == flat.numel()
    return out


def test_three_fastspeech2_steps_match_jax(steps):
    """Three make_fastspeech2_step steps against JAX's
    make_fastspeech2_step(axis_name=None): losses, every metric of the
    last step, parameters, BatchNorm and feature-norm statistics."""
    jlosses, jvars, tlosses, state, v, _, _, tm, jm, _ = steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert all(np.isfinite(jlosses)) and int(state.step) == 3
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want = from_flax_variables(jvars)
    got = state.net.state_dict()
    assert sorted(want) == sorted(got)
    start = from_flax_variables(v)
    moved = 0
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.bool:
            assert torch.equal(g, w), name
            continue
        err = float((g.float() - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-6), (name, err)
        moved += not torch.equal(g, start[name])
    assert moved >= len(want) // 2
    assert float(got["pitch_norm.stats.batch"][0]) == 3.0
    assert "duration_gate_loss" in tm
    for name in ("encoder.prenet.batchnorm_0.running_mean",
                 "postnet.batchnorm_2.running_var",
                 "encoder.encoder.layer_0.feed_forward.in_layer.weight",
                 "decoder.layer_0.feed_forward.out_layer.bias",
                 "spk_emb.lookup.weight", "duration_predictor.gate_head.bias",
                 "feat_norm.stats.mean"):
        assert not torch.equal(got[name], start[name]), name


def test_fastspeech2_gradients_match_jax(steps):
    """The gradients of the three steps, through Adam's first moment
    (both packages keep it flat): mu = 0.1 (0.81 g1 + 0.9 g2 + g3) of the
    clipped gradients, so a gradient of the wrong sign or a missing one
    shows here, where the parameters, which Noam's warm-up moves by
    ~1e-6, cannot show it. Each parameter's moment within 1e-3 of its
    largest magnitude (or of 1e-6 of the largest moment, for moments zero
    up to rounding), phase 10's rule for gradients on the card; a zero
    moment only where JAX's is zero."""
    _, _, _, state, _, _, _, _, _, jstate = steps
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    mu = np.asarray(jstate.opt_state["inner"][0].mu)     # leaves' order
    ends = np.cumsum([x.size for x in leaves])
    assert ends[-1] == mu.size
    want = from_flax_variables({"params": jax.tree_util.tree_unflatten(
        tree, [m.reshape(x.shape) for m, x in zip(np.split(mu, ends[:-1]),
                                                  leaves)])})
    got = first_moments(state.net, state.opt_state["mu"])
    assert sorted(want) == sorted(got)
    scale = max(float(w.abs().max()) for w in want.values())
    assert scale > 0
    for name, w in want.items():
        wmax = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        assert err <= max(1e-3 * wmax, 1e-6 * scale), (name, err, wmax)
        assert (wmax == 0) == (float(got[name].abs().max()) == 0), name


def test_eval_step_leaves_state_unchanged(steps):
    """A train=False step computes the metrics in evaluation mode and
    leaves every parameter and statistic byte-identical."""
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import make_fastspeech2_step
    _, _, _, state, _, tcfg, tb, _, _, _ = steps
    before = {k: x.clone() for k, x in state.net.state_dict().items()}
    step = make_fastspeech2_step(state.net, tcfg, build_optimizer(**OPT),
                                 train=False, device="cpu")
    st, m = step(state, tb, torch.Generator().manual_seed(1))
    assert torch.isfinite(m["loss"]) and not m["loss"].requires_grad
    assert int(st.step) == int(state.step)
    assert not st.net.training
    for k, x in st.net.state_dict().items():
        assert torch.equal(x, before[k]), k


def test_weight_bridge_round_trip_fastspeech2(steps):
    """to_flax_variables inverts from_flax_variables over FastSpeech2's
    whole tree: params, the postnet's (and prenet's) batch_stats and the
    three norms' norm_stats."""
    _, _, _, _, v, _, _, _, _, _ = steps
    back = to_flax_variables(from_flax_variables(v))
    want = jax.tree_util.tree_leaves_with_path(v)
    got = {tuple(str(getattr(p, "key", p)) for p in k): x
           for k, x in jax.tree_util.tree_leaves_with_path(back)}
    assert len(got) == len(want)
    for path, leaf in want:
        key = tuple(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)
        np.testing.assert_array_equal(got[key], np.asarray(leaf),
                                      err_msg=str(key))
    for col, mod in (("batch_stats", "postnet"), ("norm_stats", "feat_norm"),
                     ("norm_stats", "pitch_norm"),
                     ("norm_stats", "energy_norm")):
        assert any(k[:2] == (col, mod) for k in got), (col, mod)


def test_training_forward_needs_its_targets():
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    net = FastSpeech2Net(configs()[1]).train()
    with pytest.raises(ValueError, match="pitch"):
        net(torch.ones(1, 3, dtype=torch.long), torch.tensor([3]))


def test_fastspeech2_step_needs_a_card_unless_cpu_is_asked():
    from speechain_tpu_torch.models.nar_tts import FastSpeech2Net
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import make_fastspeech2_step
    net = FastSpeech2Net(configs()[1])
    tx = build_optimizer(**OPT)
    with pytest.raises(NotImplementedError):
        make_fastspeech2_step(net, net.cfg, tx, axis_name="data",
                              device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fastspeech2_step(net, net.cfg, tx)
