"""The port's Transformer-TTS network, loss and training step against the
JAX package's, on the CPU.

Every flax variable comes from ``jax.eval_shape`` of the JAX
``ARTTSNet``'s init, filled with seeded numpy values and bridged with
``from_flax_variables``; both sides run the same numpy inputs in float32
at dropout 0 (the two packages draw dropout masks from different
generators). The JAX side runs its XLA paths; the port's FFN and
flash-attention kernels take their plain versions on CPU tensors.

Sizes: vocabulary 20; the encoder 32 wide (2 heads, 2 layers, F 64, a
BatchNorm Conv1d prenet of kernel 5), the decoder prenet [16, 16], so the
decoder runs at 16 (2 heads of 8, 2 layers, F 48) although its config
says 32, as the recipe's runs at 256 although it says 512; a postnet of
2 x 16 with kernel 5; the recipe's 16 kHz frontend (80 mels, hop 200, n_fft
800); 2 utterances of 9 and 6 tokens, one with a padded tail.

Tolerances: the network's outputs and layer 0's cross-attention 1e-5 of
max(1, max|ref|) (float32 rounding of the stacks; the forward takes mel
features, so no frontend rounding enters); the losses 1e-5 relative; the
training step on waveforms as the FastSpeech2 step's test: losses 1e-4
relative, parameters and statistics 1e-4 of each array's largest
magnitude, and the gradients through Adam's first moment, 1e-3 of each
parameter's (the frontend's DFT and mel products sum 800 and 401 terms
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_tts_train import (_t, first_moments, init_vars,
                                             quick_jit, within)
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

KEY = jax.random.PRNGKey(0)
V, D, W, B = 20, 32, 16, 2
TOKENS = (9, 6)
FRAMES = (24, 17)                         # mel frames of the forward cases
SAMPLES = (31 * 200, 22 * 200 + 57)       # 32 and 23 frames (the step's)
OPT = dict(optim_conf=dict(lr=1e-3, betas=(0.9, 0.98), eps=1e-9),
           warmup_steps=4000)             # the recipe's Noam / Adam


def configs(r=1, spk=False, guid=0.2, lnr_dropout=0.0):
    """The JAX and port ARTTSConfig of one case: the recipe's layout
    (posenc_scale, Conv1d prenet with lnr_dims -1, L2 loss, stop weight
    5, a global feature norm) at the sizes above, dropout 0 but the
    decoder prenet's ``lnr_dropout``."""
    from speechain_tpu.models.ar_tts import ARTTSConfig as JC
    from speechain_tpu.ops.feat_norm import FeatNormConfig as JF
    from speechain_tpu.ops.frontend import FrontendConfig as JFE
    from speechain_tpu_torch.models.ar_tts import ARTTSConfig as TC
    from speechain_tpu_torch.ops.feat_norm import FeatNormConfig as TF
    from speechain_tpu_torch.ops.frontend import FrontendConfig as TFE

    def stack(F_dim):
        return dict(d_model=D, num_heads=2, num_layers=2, fdfwd_dim=F_dim,
                    posenc_scale=True, att_dropout=0.0, fdfwd_dropout=0.0,
                    res_dropout=0.0, posenc_dropout=0.0)

    fe = dict(sr=16000, n_mels=80, win_length=0.05, hop_length=0.0125,
              fmin=125.0, fmax=7600.0)
    kw = dict(vocab_size=V, enc_emb=dict(embedding_dim=D),
              enc_prenet=dict(conv_dims=[D, D], conv_kernel=5, lnr_dims=-1),
              encoder=stack(2 * D), decoder=stack(48),
              dec_prenet=dict(lnr_dims=[W, W], lnr_dropout=lnr_dropout),
              postnet=dict(conv_dims=[16, 16], conv_kernel=5,
                           conv_dropout=0.0),
              spk_emb=dict(spk_num=3) if spk else None,
              reduction_factor=r, att_guid_sigma=guid)
    return (JC(frontend=JFE(**fe), feat_norm=JF(feat_dim=80), **kw),
            TC(frontend=TFE(**fe), feat_norm=TF(feat_dim=80), **kw))


def text_batch(seed=1):
    rng = np.random.default_rng(seed)
    text = np.zeros((B, max(TOKENS)), np.int32)
    for i, n in enumerate(TOKENS):
        text[i, :n] = rng.integers(1, V, n)
    return text, np.array(TOKENS, np.int32)


def mel_batch(seed=2):
    """Log-Mel-like features (B, T, 80), zero past each length."""
    rng = np.random.default_rng(seed)
    feat = (rng.standard_normal((B, max(FRAMES), 80)) - 4.0).astype(
        np.float32)
    for i, n in enumerate(FRAMES):
        feat[i, n:] = 0.0
    return feat, np.array(FRAMES, np.int32)


def wave_batch(seed=3):
    """Waveforms (B, L, 1) of a tone and noise, zero past each length."""
    rng = np.random.default_rng(seed)
    L = max(SAMPLES)
    t = np.arange(L) / 16000.0
    wave = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(L)
                     for f in (220.0, 330.0)]).astype(np.float32)
    for i, n in enumerate(SAMPLES):
        wave[i, n:] = 0.0
    return wave[..., None], np.array(SAMPLES, np.int32)


def net_pair(jcfg, tcfg, seed, spk=False):
    """The JAX ARTTSNet, its seeded variables (numpy) and the port's
    network with them bridged."""
    from speechain_tpu.models.ar_tts import ARTTSNet as JNet
    from speechain_tpu_torch.models.ar_tts import ARTTSNet
    jnet = JNet(cfg=jcfg)
    text, text_len = text_batch()
    feat, feat_len = mel_batch()
    kw = dict(spk_ids=jnp.asarray([0, 2], jnp.int32)) if spk else {}
    v = jax.tree_util.tree_map(np.asarray, init_vars(
        jnet, *map(jnp.asarray, (text, text_len, feat, feat_len)),
        seed=seed, train=False, **kw))
    net = ARTTSNet(tcfg)
    net.load_state_dict(from_flax_variables(v), strict=True)
    return jnet, v, net


# ------------------------------------------------------------- criteria

# attention_guidance cases (sigma, with y_len): ragged x / y lengths, one
# x length past X (clipped); without y_len the square case
GUIDANCE_CASES = [(0.2, True), (0.4, False)]


def criteria_inputs():
    rng = np.random.default_rng(4)
    guid = []
    for sigma, with_y in GUIDANCE_CASES:
        att = rng.random((3, 4, 12, 7 if with_y else 12)).astype(np.float32)
        guid.append((att, np.array([12, 9, 14], np.int32),
                     np.array([7, 5, 3], np.int32) if with_y else None))
    pred = rng.standard_normal((3, 10)).astype(np.float32)
    tgt_len = np.array([10, 6, 0], np.int32)
    tgt = (np.arange(10)[None] == (tgt_len - 1)[:, None]).astype(np.float32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    T = 12
    stop = f(B, T) - 2.0
    stop[0, 11] = stop[1, 3] = 3.0        # one right, one wrong stop
    outs = dict(pred_stop=stop, pred_before=f(B, T, 160),
                pred_after=f(B, T, 160), tgt_feat=f(B, T, 160),
                tgt_feat_len=np.array([12, 8], np.int32),
                text_len=np.array(TOKENS, np.int32),
                cross_att=rng.random((B, 2, T, 9)).astype(np.float32))
    return guid, (pred, tgt, tgt_len), outs


@pytest.fixture(scope="module")
def jax_criteria():
    """The JAX package's attention_guidance at each case, stop_accuracy
    and artts_loss (r = 2, guidance 0.2), compiled once."""
    from speechain_tpu.models.ar_tts import artts_loss as jloss
    from speechain_tpu.train.criteria import attention_guidance as jag
    from speechain_tpu.train.criteria import stop_accuracy as jsa
    jcfg, _ = configs(r=2)
    guid, acc, outs = criteria_inputs()

    def run(guid, acc, outs):
        return ([jag(a, x, y, sigma=s) for (a, x, y), (s, _)
                 in zip(guid, GUIDANCE_CASES)], jsa(*acc),
                jloss(outs, jcfg))

    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return quick_jit(run)(to_j(guid), to_j(acc), to_j(outs))


@pytest.mark.parametrize("case", range(len(GUIDANCE_CASES)))
def test_attention_guidance_matches_jax(jax_criteria, case):
    from speechain_tpu_torch.train.criteria import attention_guidance
    att, x_len, y_len = criteria_inputs()[0][case]
    got = attention_guidance(_t(att), _t(x_len),
                             None if y_len is None else _t(y_len),
                             sigma=GUIDANCE_CASES[case][0])
    np.testing.assert_allclose(float(got), float(jax_criteria[0][case]),
                               rtol=1e-6)


def test_stop_accuracy_matches_jax(jax_criteria):
    from speechain_tpu_torch.train.criteria import stop_accuracy
    got = stop_accuracy(*map(_t, criteria_inputs()[1]))
    assert float(got) == pytest.approx(float(jax_criteria[1]), abs=1e-7)
    assert 0.0 < float(got) < 1.0


def test_artts_loss_matches_jax(jax_criteria):
    """artts_loss on the same outputs, with the attention guidance: every
    loss and metric."""
    from speechain_tpu_torch.models.ar_tts import artts_loss
    _, tcfg = configs(r=2)
    outs = criteria_inputs()[2]
    jl, jm = jax_criteria[2]
    tl, tm = artts_loss({k: _t(v) for k, v in outs.items()}, tcfg)
    assert sorted(jm) == sorted(tm) and "att_guid_loss" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert 0.0 < float(tm["stop_f2"]) < 1.0


# ------------------------------------------------- the decoder prenet

def test_decoder_prenet_dropout_stays_on_in_evaluation():
    """LinearPrenet(train=True) in evaluation mode: the same generator
    seed gives the same output, another seed another, about half of the
    units are dropped and the kept ones scaled by 2; ``train=None`` (every
    other caller) follows the mode, and so does a train-mode prenet."""
    from speechain_tpu_torch.nn.prenets import LinearPrenet
    from speechain_tpu_torch.ops.dropout import step_rng
    torch.manual_seed(0)
    pre = LinearPrenet(80, [256, 256], lnr_dropout=0.5).eval()
    with torch.no_grad():
        for p in pre.parameters():
            p.normal_(0.0, 0.1)
    x = torch.randn(4, 30, 80)

    def run(seed, train=True):
        with step_rng(torch.Generator().manual_seed(seed)), torch.no_grad():
            return pre(x, train=train)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        plain = pre(x)                    # evaluation mode: no dropout
        h = torch.relu(pre.linear_1(torch.relu(pre.linear_0(x))))
    assert torch.equal(plain, h)
    assert torch.equal(run(1, train=None), h)
    one = LinearPrenet(80, [256], lnr_dropout=0.5).eval()
    with torch.no_grad():
        one.linear_0.weight.copy_(pre.linear_0.weight)
        one.linear_0.bias.copy_(pre.linear_0.bias)
        h0 = one(x)
        with step_rng(torch.Generator().manual_seed(3)):
            d0 = one(x, train=True)
    live = h0 != 0
    kept = (d0 != 0)[live].float().mean()
    assert 0.45 < float(kept) < 0.55, float(kept)
    assert torch.equal(d0[d0 != 0], 2.0 * h0[d0 != 0])
    pre.train()
    with step_rng(torch.Generator().manual_seed(1)), torch.no_grad():
        assert torch.equal(pre(x), a)


# ------------------------------------------------------------ the network

# (mode, r, speaker table): each value of each once
FORWARD_CASES = [("train", 2, True), ("eval", 1, False)]


@pytest.mark.parametrize("mode,r,spk", FORWARD_CASES)
def test_artts_forward_matches_jax(mode, r, spk):
    """ARTTSNet.forward on mel features against the JAX network's
    ``apply(train=...)``: pred_stop, pred_before, pred_after, the grouped
    targets and their lengths, and layer 0's cross-attention; in training
    the feature norm's updated statistics. The decoder runs at the
    prenet's width."""
    jcfg, tcfg = configs(r=r, spk=spk)
    jnet, v, net = net_pair(jcfg, tcfg, seed=10 + r, spk=spk)
    assert net.decoder.layer_0.self_att.d_model == W
    text, text_len = text_batch()
    feat, feat_len = mel_batch()
    train = mode == "train"
    spk_ids = np.array([0, 2], np.int32) if spk else None
    mut = ["norm_stats", "batch_stats"] if train else []
    want, new = quick_jit(lambda jv, s, *a: jnet.apply(
        jv, *a, train=train, mutable=mut, rngs={"dropout": KEY},
        spk_ids=s))(jax.tree_util.tree_map(jnp.asarray, v),
                    None if spk_ids is None else jnp.asarray(spk_ids),
                    *map(jnp.asarray, (text, text_len, feat, feat_len)))
    net.train(train)
    with torch.no_grad():
        got = net(*map(_t, (text, text_len, feat, feat_len)),
                  spk_ids=None if spk_ids is None else _t(spk_ids))
    assert sorted(got) == sorted(want)
    T = max(FRAMES) // r
    assert got["pred_after"].shape == (B, T, 80 * r)
    assert got["cross_att"].shape == (B, 2, T, max(TOKENS))
    for k, w in want.items():
        w = np.asarray(w)
        if k.endswith("_len"):
            np.testing.assert_array_equal(got[k].numpy(), w, k)
        else:
            err = float(np.abs(got[k].numpy() - w).max())
            assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), (k, err)
    if train:
        stats = from_flax_variables(jax.tree_util.tree_map(np.asarray, new))
        assert len(stats) == 6 + 2 * 2 + 3 * 2     # norm, prenet, postnet
        for n, st in stats.items():
            g = net.state_dict()[n]
            if st.dtype == torch.bool:
                assert torch.equal(g, st), n
            else:
                within(g, st.numpy(), 1e-5, n)


def test_artts_return_att_gives_every_layer():
    """``return_att`` returns every decoder layer's self- and
    cross-attention matrices (the reference's validation output): the
    rows of each sum to 1, the self-attention is causal, and layer 0's
    cross-attention equals the guidance's matrix."""
    from speechain_tpu_torch.models.ar_tts import ARTTSNet
    from speechain_tpu_torch.utils.weights import random_state_dict
    net = ARTTSNet(configs(r=2)[1])
    net.load_state_dict(random_state_dict(net, 12))
    text, text_len = text_batch()
    feat, feat_len = mel_batch()
    args = list(map(_t, (text, text_len, feat, feat_len)))
    with torch.no_grad():
        plain = net.eval()(*args)
        full = net(*args, return_att=True)
    assert len(full["dec_self_att"]) == len(full["dec_cross_att"]) == 2
    assert torch.equal(full["cross_att"], full["dec_cross_att"][0])
    torch.testing.assert_close(full["cross_att"], plain["cross_att"],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(full["pred_after"], plain["pred_after"],
                               rtol=0, atol=1e-5)
    sa = full["dec_self_att"][1]
    torch.testing.assert_close(sa.sum(-1), torch.ones(sa.shape[:-1]))
    assert float(torch.triu(sa[0, 0], 1).abs().max()) == 0.0


# --------------------------------------------------------- the training step

@pytest.fixture(scope="module")
def steps():
    """Three make_artts_step steps on waveforms (r = 2, the attention
    guidance, a speaker table whose ids the norm takes as group ids) on
    both sides."""
    from speechain_tpu.train.optim import build_optimizer as jbuild
    from speechain_tpu.train.state import init_train_state as jinit
    from speechain_tpu.train.state import make_artts_step as jmake
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_artts_step)
    jcfg, tcfg = configs(r=2, spk=True)
    jnet, v, net = net_pair(jcfg, tcfg, seed=13, spk=True)
    text, text_len = text_batch(7)
    wave, wave_len = wave_batch()
    b = dict(text=text, text_len=text_len, feat=wave, feat_len=wave_len,
             spk_ids=np.array([0, 2], np.int32))
    jtx = jbuild(**OPT)
    jstate = jinit(jax.tree_util.tree_map(jnp.asarray, v), jtx)
    jstep = quick_jit(jmake(jnet, jcfg, jtx, axis_name=None))
    jb = {k: jnp.asarray(x) for k, x in b.items()}
    jlosses = []
    for i in range(3):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i))
        jlosses.append(float(jm["loss"]))
    jvars = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, **jstate.mutables})

    tx = build_optimizer(**OPT)
    state = init_train_state(net, tx, device="cpu")
    step = make_artts_step(net, tcfg, tx, device="cpu")
    tb = {k: _t(x) for k, x in b.items()}
    gen = torch.Generator().manual_seed(0)
    tlosses = []
    for _ in range(3):
        state, tm = step(state, tb, gen)
        tlosses.append(float(tm["loss"]))
    return dict(jlosses=jlosses, jvars=jvars, jm=jm, jstate=jstate,
                tlosses=tlosses, tm=tm, state=state, v=v, tcfg=tcfg, tb=tb)


def test_three_artts_steps_match_jax(steps):
    """Three make_artts_step steps against JAX's
    make_artts_step(axis_name=None): losses, every metric of the last
    step (the guidance among them), parameters, BatchNorm and feature-norm
    statistics."""
    s = steps
    np.testing.assert_allclose(s["tlosses"], s["jlosses"], rtol=1e-4)
    assert all(np.isfinite(s["jlosses"])) and int(s["state"].step) == 3
    assert sorted(s["tm"]) == sorted(s["jm"]) and "att_guid_loss" in s["tm"]
    for k in s["jm"]:
        np.testing.assert_allclose(float(s["tm"][k]), float(s["jm"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want = from_flax_variables(s["jvars"])
    got = s["state"].net.state_dict()
    assert sorted(want) == sorted(got)
    start = from_flax_variables(s["v"])
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
    for name in ("encoder.prenet.batchnorm_0.running_mean",
                 "postnet.batchnorm_2.running_var", "feat_norm.stats.mean",
                 "decoder.layer_0.cross_att.q_layer.weight",
                 "dec_prenet.linear_0.weight", "stop_pred.bias",
                 "spk_emb.lookup.weight"):
        assert not torch.equal(got[name], start[name]), name


def test_artts_gradients_match_jax(steps):
    """The three steps' gradients through Adam's first moment, as the
    FastSpeech2 step's test: each parameter's within 1e-3 of its largest
    magnitude (or of 1e-6 of the largest moment); a zero moment only
    where JAX's is zero."""
    jstate, state = steps["jstate"], steps["state"]
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    mu = np.asarray(jstate.opt_state["inner"][0].mu)
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


def test_artts_eval_step_leaves_state_unchanged(steps):
    """A train=False step computes the metrics (the guidance among them)
    in evaluation mode and leaves every parameter and statistic
    byte-identical."""
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import make_artts_step
    state, tcfg = steps["state"], steps["tcfg"]
    before = {k: x.clone() for k, x in state.net.state_dict().items()}
    step = make_artts_step(state.net, tcfg, build_optimizer(**OPT),
                           train=False, device="cpu")
    st, m = step(state, steps["tb"], torch.Generator().manual_seed(1))
    assert torch.isfinite(m["loss"]) and "att_guid_loss" in m
    assert int(st.step) == int(state.step) and not st.net.training
    for k, x in st.net.state_dict().items():
        assert torch.equal(x, before[k]), k


def test_weight_bridge_maps_every_artts_leaf(steps):
    """Every leaf of the JAX ARTTSNet's tree (params, the prenet's and
    postnet's batch_stats, the feature norm's norm_stats) maps to one
    entry of the port's state_dict of the same shape, and
    to_flax_variables inverts the bridge."""
    v = steps["v"]
    mapped = from_flax_variables(v)
    sd = steps["state"].net.state_dict()
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(mapped) == n_leaves == len(sd)
    for k, x in mapped.items():
        assert tuple(sd[k].shape) == tuple(x.shape), k
    for mod in ("encoder", "feat_norm", "dec_prenet", "spk_emb", "decoder",
                "feat_pred", "stop_pred", "postnet"):
        assert any(k.startswith(mod + ".") for k in mapped), mod
    back = to_flax_variables(mapped)
    got = {tuple(str(getattr(p, "key", p)) for p in k): x
           for k, x in jax.tree_util.tree_leaves_with_path(back)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(v):
        key = tuple(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)
        np.testing.assert_array_equal(got[key], np.asarray(leaf),
                                      err_msg=str(key))


def test_artts_step_needs_a_card_unless_cpu_is_asked():
    from speechain_tpu_torch.models.ar_tts import ARTTSNet
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import make_artts_step
    net = ARTTSNet(configs()[1])
    tx = build_optimizer(**OPT)
    with pytest.raises(NotImplementedError):
        make_artts_step(net, net.cfg, tx, axis_name="data", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_artts_step(net, net.cfg, tx)
