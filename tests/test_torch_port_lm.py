"""The port's language model and its fusion into ASR beam search against
the JAX package, on the CPU.

A tiny LM of the LibriSpeech LM recipes' structure (``emb_scale`` off,
a causal pre-LN encoder, ReLU FFN; 2 layers, d 32, 4 heads, V 23) and a
tiny transformer ARASRNet with a CTC head (2 + 2 layers, d 32) that
decodes 16-dim features: seeded numpy values fill the JAX variables,
bridged into the port with ``from_flax_variables`` (strictly); both take
the same numpy inputs, the port with ``device="cpu"`` (the kernels'
plain versions). float32, dropout 0.

Tolerances: LM logits (forward and each cached step) within 1e-5 of
JAX's, cached steps within 1e-5 of the full forward's positions;
``lm_loss`` metrics 1e-5 relative; after three ``make_lm_step`` steps the
losses 1e-4 relative, every parameter within 1e-4 of its largest
magnitude and Adam's first moment (the gradients) within 1e-3 of its
largest; beam searches token-equal, scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu.nn.lm import LanguageModelNet as JLM
from speechain_tpu.nn.lm import LMConfig as JLMConfig
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.nn.lm import LanguageModelNet, LMConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.utils.weights import from_flax_variables
from tests.test_torch_port_asr import _random_tree
from tests.test_torch_port_tts_train import first_moments, quick_jit

V, D, N_MELS, B = 23, 32, 16, 2
SOS = V - 1
DROP0 = dict(posenc_dropout=0.0, fdfwd_dropout=0.0, att_dropout=0.0,
             res_dropout=0.0)
# the recipes' optimizer (noam, Adam (0.9, 0.98), eps 1e-9) at d 32
OPT = dict(optim_conf=dict(betas=(0.9, 0.98), eps=1e-9), d_model=D,
           warmup_steps=50000)


def _lm_kwargs():
    return dict(vocab_size=V, emb=dict(embedding_dim=D, emb_scale=False),
                encoder=dict(d_model=D, num_heads=4, num_layers=2,
                             fdfwd_dim=64, **DROP0))


def _text(seed, T=9, lens=(9, 5, 0)):
    """<sos> + tokens + <eos>, padded with 0 behind each length."""
    rng = np.random.default_rng(seed)
    text = rng.integers(1, V - 1, (len(lens), T)).astype(np.int32)
    text[:, 0] = SOS
    for i, n in enumerate(lens):
        if n:
            text[i, n - 1] = SOS
        text[i, n:] = 0
    return text, np.array(lens, np.int32)


@pytest.fixture(scope="module")
def lms():
    jnet = JLM(cfg=JLMConfig(**_lm_kwargs()))
    text, text_len = _text(30)
    shapes = jax.eval_shape(jnet.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(text), jnp.asarray(text_len))
    variables = _random_tree(shapes, seed=31)
    tnet = LanguageModelNet(LMConfig(**_lm_kwargs()))
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    return jnet, variables, tnet.eval()


def test_lm_forward_matches_jax(lms):
    jnet, variables, tnet = lms
    text, text_len = _text(32)
    jlogits, jmask, _ = quick_jit(lambda v, t, n: jnet.apply(v, t, n))(
        variables, jnp.asarray(text), jnp.asarray(text_len))
    with torch.no_grad():
        logits, mask = tnet(torch.from_numpy(text), torch.from_numpy(
            text_len))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)


def test_decode_step_matches_jax_and_the_forward(lms):
    """Five cached steps over a prefix (cache of 8 positions): each step's
    logits against JAX's decode_step and against the full forward's
    position; the position advances and a full cache raises."""
    jnet, variables, tnet = lms
    text, _ = _text(33, T=5, lens=(5, 5))
    _, primed = quick_jit(lambda v, tok: jnet.apply(
        v, tok, prime=True, cache_capacity=8, method=jnet.decode_step,
        mutable=["cache"]))(variables, jnp.asarray(text[:, :1]))
    jstep = quick_jit(lambda v, c, tok: jnet.apply(
        {**v, "cache": c}, tok, method=jnet.decode_step, mutable=["cache"]))
    jcache = primed["cache"]
    cache = tnet.prime(2, 8)
    assert cache.position == 0 and cache.self_k[0].shape == (2, 4, 8, 8)
    with torch.no_grad():
        full, _ = tnet(torch.from_numpy(text), torch.full((2,), 5))
        for i in range(5):
            jlogits, upd = jstep(variables, jcache,
                                 jnp.asarray(text[:, i:i + 1]))
            jcache = upd["cache"]
            logits = tnet.decode_step(torch.from_numpy(text[:, i:i + 1]),
                                      cache)
            assert cache.position == i + 1
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=1e-5, rtol=0, err_msg=f"{i}")
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, i].numpy(), atol=1e-5, rtol=0)
        reordered = cache.reorder(torch.tensor([1, 1]))
        assert torch.equal(reordered.self_v[1][0], cache.self_v[1][1])
        assert reordered.position == 5
        cache.position = 8
        with pytest.raises(ValueError, match="full"):
            tnet.decode_step(torch.from_numpy(text[:, :1]), cache)


def test_lm_loss_matches_jax(lms):
    """lm_loss's metrics (ce_loss, accuracy, text_ppl, loss) with label
    smoothing 0.1 over a batch with a short row and an empty one."""
    from speechain_tpu.models.lm import lm_loss as jloss
    from speechain_tpu_torch.models.lm import lm_loss
    rng = np.random.default_rng(34)
    logits = (2.0 * rng.standard_normal((3, 9, V))).astype(np.float32)
    text, text_len = _text(35)
    jl, jm = quick_jit(lambda lg, t, n: jloss(lg, t, n, label_smoothing=0.1))(
        jnp.asarray(logits), jnp.asarray(text), jnp.asarray(text_len))
    tl, tm = lm_loss(torch.from_numpy(logits), torch.from_numpy(text),
                     torch.from_numpy(text_len), label_smoothing=0.1)
    assert sorted(tm) == sorted(jm) == ["accuracy", "ce_loss", "loss",
                                        "text_ppl"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tl) == float(tm["loss"])


@pytest.fixture(scope="module")
def lm_steps(lms):
    """Three make_lm_step steps from the same variables on both sides,
    label smoothing 0.1 and a batch with a short and an empty row."""
    from speechain_tpu.train.optim import build_optimizer as jbuild
    from speechain_tpu.train.state import init_train_state as jinit
    from speechain_tpu.train.state import make_lm_step as jmake
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_lm_step)
    jnet, variables, _ = lms
    text, text_len = _text(36)
    jtx = jbuild(**OPT)
    jstate = jinit(jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    jstep = quick_jit(jmake(jnet, jtx, label_smoothing=0.1, axis_name=None))
    jbatch = dict(text=jnp.asarray(text), text_len=jnp.asarray(text_len))
    jlosses = []
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        jlosses.append(float(jm["loss"]))

    tnet = LanguageModelNet(LMConfig(**_lm_kwargs()))
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    tx = build_optimizer(**OPT)
    state = init_train_state(tnet, tx, device="cpu")
    step = make_lm_step(tnet, tx, label_smoothing=0.1, device="cpu")
    batch = dict(text=torch.from_numpy(text).long(),
                 text_len=torch.from_numpy(text_len).long())
    gen = torch.Generator().manual_seed(0)
    tlosses = []
    for _ in range(3):
        state, tm = step(state, batch, gen)
        tlosses.append(float(tm["loss"]))
    return dict(jlosses=jlosses, jstate=jstate, jm=jm, tlosses=tlosses,
                state=state, tm=tm, batch=batch, step=step)


def test_three_lm_steps_match_jax(lm_steps):
    s = lm_steps
    np.testing.assert_allclose(s["tlosses"], s["jlosses"], rtol=1e-4)
    assert int(s["state"].step) == 3 and sorted(s["tm"]) == sorted(s["jm"])
    for k in s["jm"]:
        np.testing.assert_allclose(float(s["tm"][k]), float(s["jm"][k]),
                                   rtol=1e-4, err_msg=k)
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, s["jstate"].params)})
    got = s["state"].net.state_dict()
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        err = float((got[name] - w).abs().max())
        assert err <= tol, (name, err)
    # the gradients, through Adam's flat first moment
    jstate = s["jstate"]
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    mu = np.asarray(jstate.opt_state["inner"][0].mu)
    ends = np.cumsum([x.size for x in leaves])
    assert ends[-1] == mu.size
    want = from_flax_variables({"params": jax.tree_util.tree_unflatten(
        tree, [m.reshape(x.shape) for m, x in zip(np.split(mu, ends[:-1]),
                                                  leaves)])})
    got = first_moments(s["state"].net, s["state"].opt_state["mu"])
    scale = max(float(w.abs().max()) for w in want.values())
    assert scale > 0
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= max(1e-3 * float(w.abs().max()), 1e-6 * scale), (
            name, err)


def test_lm_eval_step_leaves_the_net_unchanged(lm_steps):
    from speechain_tpu_torch.train.state import make_lm_step
    s = lm_steps
    net = s["state"].net
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step = make_lm_step(net, None, train=False, device="cpu")
    state, m = step(s["state"], s["batch"], torch.Generator())
    assert int(state.step) == 3 and torch.isfinite(m["text_ppl"])
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())
    with pytest.raises(NotImplementedError):
        make_lm_step(net, None, axis_name="data", device="cpu")


# ---- fusion into ASR beam search -----------------------------------------

def _asr_kwargs():
    return dict(
        vocab_size=V,
        enc_prenet=dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="transformer",
        encoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU", **DROP0),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU", emb_layernorm=True,
                     emb_scale=False, **DROP0),
        ctc_weight=0.3)


def _feats(seed=40):
    """Two utterances of 16-dim features, 40 and 27 frames (T_enc 9 and
    6)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 40, N_MELS)).astype(np.float32),
            np.array([40, 27], np.int32))


@pytest.fixture(scope="module")
def asr(lms):
    jnet = JNet(cfg=JConfig(frontend=JFE(n_mels=N_MELS), **_asr_kwargs()))
    feat, feat_len = _feats()
    shapes = jax.eval_shape(
        jnet.init, {"params": jax.random.PRNGKey(0)}, jnp.asarray(feat),
        jnp.asarray(feat_len), jnp.ones((B, 5), jnp.int32),
        jnp.full((B,), 5, jnp.int32))
    variables = _random_tree(shapes, seed=41)
    # <eos> likely, so that beams finish and the pool takes part
    variables["params"]["postnet"]["linear"]["bias"][SOS] += 3.0
    tnet = ARASRNet(ARASRConfig(frontend=FrontendConfig(n_mels=N_MELS),
                                **_asr_kwargs()))
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    return jnet, variables, tnet.eval()


SEARCH = dict(beam_size=4, max_len=8, temperature=1.2, sent_per_beam=2)
LM_CACHED = dict(lm_weight=0.6, lm_temperature=1.3)
FUSIONS = {
    "lm cached": LM_CACHED,
    "lm window 2": dict(LM_CACHED, lm_window_size=2),
    "ilm": dict(ilm_sub_weight=0.3),
    "ctc lm ilm": dict(LM_CACHED, ctc_weight=0.3, ilm_sub_weight=0.3),
}


def _decode(asr, lms, kw):
    """JAX's make_asr_decoder (quick_jit) and the port's on the CPU."""
    from speechain_tpu.infer.asr import make_asr_decoder as jmake
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    jnet, variables, tnet = asr
    jlm, lm_variables, tlm = lms
    feat, feat_len = _feats()
    uses_lm = "lm_weight" in kw
    jout = quick_jit(lambda v, lv, f, n: jmake(
        jnet, lm_net=jlm if uses_lm else None, lm_variables=lv,
        **SEARCH, **kw)(v, f, n))(variables, lm_variables,
                                  jnp.asarray(feat), jnp.asarray(feat_len))
    tout = make_asr_decoder(tnet, device="cpu",
                            lm_net=tlm if uses_lm else None,
                            **SEARCH, **kw)(torch.from_numpy(feat),
                                            torch.from_numpy(feat_len))
    return tout, jout


def _same(tout, jout):
    for k in ("hypo_text", "hypo_text_len", "nbest_text", "nbest_text_len"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    for k in ("hypo_text_confid", "nbest_confid"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def plain_search(asr):
    """The port's attention-only search at SEARCH."""
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    feat, feat_len = _feats()
    return make_asr_decoder(asr[2], device="cpu", **SEARCH)(
        torch.from_numpy(feat), torch.from_numpy(feat_len))


@pytest.mark.parametrize("fusion", list(FUSIONS))
def test_fused_beam_search_matches_jax(asr, lms, plain_search, fusion):
    """make_asr_decoder with LM fusion (KV-cached, and windowed at W 2),
    ILM subtraction alone, and CTC + LM + ILM, against JAX's; each fusion
    moves the scores off the attention-only search's."""
    tout, jout = _decode(asr, lms, FUSIONS[fusion])
    _same(tout, jout)
    assert not torch.equal(tout["hypo_text_confid"],
                           plain_search["hypo_text_confid"])


def test_window_covering_the_prefix_equals_cached_fusion(asr, lms):
    """W >= maxlen + 1 covers [sos] + the whole prefix from position 0, so
    windowed fusion equals cached fusion (as tests/test_infer.py holds for
    the JAX package)."""
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    feat, feat_len = _feats()
    args = (torch.from_numpy(feat), torch.from_numpy(feat_len))
    cached = make_asr_decoder(asr[2], device="cpu", lm_net=lms[2], **SEARCH,
                              **LM_CACHED)(*args)
    for W in (SEARCH["max_len"] + 1, 50):
        windowed = make_asr_decoder(asr[2], device="cpu", lm_net=lms[2],
                                    lm_window_size=W, **SEARCH,
                                    **LM_CACHED)(*args)
        for k in ("hypo_text", "hypo_text_len", "nbest_text"):
            assert torch.equal(windowed[k], cached[k]), (W, k)
        np.testing.assert_allclose(windowed["hypo_text_confid"].numpy(),
                                   cached["hypo_text_confid"].numpy(),
                                   atol=1e-4, rtol=0)


def test_lm_net_at_weight_0_is_ignored(asr, lms, plain_search):
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    feat, feat_len = _feats()
    out = make_asr_decoder(asr[2], device="cpu", lm_net=lms[2],
                           lm_weight=0.0, **SEARCH)(
        torch.from_numpy(feat), torch.from_numpy(feat_len))
    for k in ("hypo_text", "hypo_text_len", "hypo_text_confid"):
        assert torch.equal(out[k], plain_search[k]), k


def test_greedy_decode_takes_the_lm(asr, lms):
    """asr_greedy_decode with an LM is the fused search at beam 1, and
    moves the LM to the device it is asked for."""
    from speechain_tpu_torch.infer.asr import (asr_greedy_decode,
                                               make_asr_decoder)
    feat, feat_len = _feats()
    kw = dict(max_len=8, temperature=1.2, **LM_CACHED)
    lm = LanguageModelNet(LMConfig(**_lm_kwargs()))
    lm.load_state_dict(lms[2].state_dict())
    lm.train()
    greedy = asr_greedy_decode(asr[2], feat, feat_len, device="cpu",
                               lm_net=lm, **kw)
    assert not lm.training
    beam1 = make_asr_decoder(asr[2], device="cpu", lm_net=lms[2],
                             beam_size=1, **kw)(torch.from_numpy(feat),
                                                torch.from_numpy(feat_len))
    for k in ("hypo_text", "hypo_text_len", "hypo_text_confid"):
        assert torch.equal(greedy[k], beam1[k]), k
