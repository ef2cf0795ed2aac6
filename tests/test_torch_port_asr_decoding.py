"""The port's ASR decoding options against the JAX package, on the CPU:
the CTC prefix scorer, joint attention + CTC beam search at the recipes'
temperature and CTC weight, greedy decoding and teacher-forced scoring.

A tiny conformer ARASRNet (2 + 2 layers, d 32, V 23, T_enc 12 and 8):
seeded numpy values fill the JAX variables, bridged into the port; both
decode the same numpy waveforms (the port with ``device="cpu"``, i.e. the
CTC kernels' plain versions).

Tolerances: scorer entries within 1e-4 x max(1, |ref|), entries at or
below -1e19 (NEG_INF sums) at or below it on both sides; hypotheses
token-equal, scores within 1e-4; teacher-forced outputs within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.ops.feat_norm import FeatNormConfig as JFN
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.utils.weights import from_flax_variables
from tests.test_torch_port_asr import _random_tree
from tests.test_torch_port_tts_train import quick_jit

V, D, L = 23, 32, 8000          # 8000 samples: 51 mel frames, T_enc 12
RECIPE = dict(temperature=1.2, ctc_weight=0.2)   # every ASR infer_cfg
BIG = -1e19                     # at or below: a NEG_INF sum


def _cfg_kwargs(ctc_weight=0.3):
    return dict(
        vocab_size=V,
        enc_prenet=dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="conformer",
        encoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU", depthwise_kernel_size=7),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU"),
        ctc_weight=ctc_weight)


def _port_net(variables, ctc_weight=0.3):
    net = ARASRNet(ARASRConfig(frontend=FrontendConfig(n_mels=16,
                                                       preemphasis=0.97),
                               feat_norm=FeatNormConfig(feat_dim=16),
                               **_cfg_kwargs(ctc_weight)))
    sd = from_flax_variables(variables)
    if ctc_weight == 0.0:
        sd = {k: v for k, v in sd.items() if not k.startswith("ctc_head.")}
    net.load_state_dict(sd, strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(frontend=JFE(n_mels=16, preemphasis=0.97),
                   feat_norm=JFN(feat_dim=16), **_cfg_kwargs())
    jnet = JNet(cfg=jcfg)
    B = 2
    shapes = jax.eval_shape(
        jnet.init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, L, 1)),
        jnp.full((B,), L, jnp.int32), jnp.ones((B, 5), jnp.int32),
        jnp.full((B,), 5, jnp.int32))
    variables = _random_tree(shapes, seed=21)
    # <eos> likely, so that beams finish and the eos filter takes part
    variables["params"]["postnet"]["linear"]["bias"][V - 1] += 4.0
    return jnet, variables, _port_net(variables)


def _waves(seed=22):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.standard_normal((2, L, 1))).astype(np.float32)
    return wave, np.array([L, L - 2345], np.int32)     # T_enc 12 and 8


def _close(got, want, what):
    """Entries of ``want`` above BIG within 1e-4 x max(1, |want|); those
    at or below BIG at or below it in ``got`` too."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    big = want <= BIG
    np.testing.assert_array_equal(got <= BIG, big, err_msg=what)
    err = np.abs(got - want)[~big]
    tol = 1e-4 * np.maximum(1.0, np.abs(want))[~big]
    assert (err <= tol).all(), (what, float((err - tol).max()))


# ---- the scorer -------------------------------------------------------

SCORER_B, SCORER_K, SCORER_T, SCORER_V = 2, 3, 12, 7


@pytest.fixture(scope="module")
def scorers():
    """JAX's and the port's scorer over the same log-probs (row 1 four
    frames short); JAX's score and update_state jitted once."""
    from speechain_tpu.infer.ctc_scorer import CTCPrefixScorer as JScorer
    from speechain_tpu_torch.infer.ctc_scorer import CTCPrefixScorer
    B, K, T, Vs = SCORER_B, SCORER_K, SCORER_T, SCORER_V
    rng = np.random.default_rng(23)
    logits = rng.standard_normal((B, T, Vs)).astype(np.float32) * 2.0
    x = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    enc_len = np.array([T, T - 4], np.int32)
    js = JScorer(jnp.asarray(x), jnp.asarray(enc_len), K, eos_id=Vs - 1)
    ts = CTCPrefixScorer(torch.from_numpy(x), torch.from_numpy(enc_len), K,
                         eos_id=Vs - 1)
    return js, jax.jit(js.score), jax.jit(js.update_state), ts


@pytest.mark.parametrize("prefix", [[], [3], [3, 3], [3, 5, 3]],
                         ids=["empty", "3", "3-3", "3-5-3"])
def test_ctc_prefix_scorer_matches_jax(scorers, prefix):
    """init_state, then update_state along ``prefix`` (each beam its own
    source row, shifted within the utterance), then score: states and
    scores against JAX's at every step; row 1 is 4 frames short."""
    js, jscore, jupdate, ts = scorers
    B, K, Vs = SCORER_B, SCORER_K, SCORER_V
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    jst, tst = js.init_state(), ts.init_state()
    beam_idx = (np.arange(B * K) // K) * K + (np.arange(B * K) + 1) % K
    for step, tok in enumerate(prefix + [None]):
        what = f"prefix {prefix[:step]}"
        _close(tst.r.numpy(), jst.r, f"{what}: r")
        _close(tst.psi.numpy(), jst.psi, f"{what}: psi")
        np.testing.assert_array_equal(tst.last_token.numpy(),
                                      np.asarray(jst.last_token))
        assert tst.prefix_len == int(jst.prefix_len) == step
        jsc, tsc = jscore(jst), ts.score(tst)
        _close(tsc.numpy(), jsc, f"{what}: score")
        if tok is None:
            break
        # beams of one utterance may extend different tokens
        toks = np.full(B * K, tok, np.int64)
        toks[1::K] = tok % 4 + 1
        jst = jupdate(jst, jsc, jnp.asarray(beam_idx),
                      jnp.asarray(toks, jnp.int32))
        tst = ts.update_state(tst, tsc, torch.from_numpy(beam_idx),
                              torch.from_numpy(toks))


# ---- joint attention + CTC decoding -------------------------------------

def _same_decode(tout, jout, nbest=True):
    np.testing.assert_array_equal(tout["hypo_text"].numpy(),
                                  np.asarray(jout["hypo_text"]))
    np.testing.assert_array_equal(tout["hypo_text_len"].numpy(),
                                  np.asarray(jout["hypo_text_len"]))
    np.testing.assert_allclose(tout["hypo_text_confid"].numpy(),
                               np.asarray(jout["hypo_text_confid"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tout["feat_token_len_ratio"].numpy(),
                               np.asarray(jout["feat_token_len_ratio"]),
                               rtol=1e-6)
    if nbest:
        np.testing.assert_array_equal(tout["nbest_text"].numpy(),
                                      np.asarray(jout["nbest_text"]))
        np.testing.assert_allclose(tout["nbest_confid"].numpy(),
                                   np.asarray(jout["nbest_confid"]),
                                   atol=1e-4, rtol=0)


FUSED = dict(beam_size=4, max_len=8, sent_per_beam=2, **RECIPE)


@pytest.fixture(scope="module")
def jax_fused_decode(models):
    """JAX's make_asr_decoder at FUSED, compiled once for each
    eos_filtering (quick_jit) with eos_threshold an argument, so that the
    threshold cases share one program."""
    from speechain_tpu.infer.asr import make_asr_decoder as jmake
    jnet, variables, _ = models
    programs = {}

    def decode(wave, wave_len, eos_filtering, eos_threshold):
        if eos_filtering not in programs:
            programs[eos_filtering] = quick_jit(
                lambda thr, v, w, n: jmake(
                    jnet, eos_filtering=eos_filtering, eos_threshold=thr,
                    **FUSED)(v, w, n))
        return programs[eos_filtering](
            jnp.float32(eos_threshold), variables, jnp.asarray(wave),
            jnp.asarray(wave_len))

    return decode


@pytest.mark.parametrize("eos_filtering,eos_threshold", [
    (False, 1.5), (True, 1.5), (True, -1e9)])
def test_ctc_fused_beam_search_matches_jax(models, jax_fused_decode,
                                           eos_filtering, eos_threshold):
    """make_asr_decoder at beam 4 with the recipes' temperature 1.2 and
    CTC weight 0.2, JAX against the port on the CPU."""
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    tnet = models[2]
    wave, wave_len = _waves()
    jout = jax_fused_decode(wave, wave_len, eos_filtering, eos_threshold)
    tout = make_asr_decoder(tnet, device="cpu", eos_filtering=eos_filtering,
                            eos_threshold=eos_threshold, **FUSED)(
        torch.from_numpy(wave), torch.from_numpy(wave_len))
    _same_decode(tout, jout)
    if eos_threshold < 0:                 # no <eos> passes: full length
        assert int(tout["hypo_text_len"][0]) == 7


def test_ctc_weight_without_ctc_head_is_attention_only(models):
    """A net without a CTC head decodes attention-only under ctc_weight >
    0, as in the JAX package; the fused search differs from it."""
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    _, variables, tnet = models
    bare = _port_net(variables, ctc_weight=0.0)
    assert not hasattr(bare, "ctc_head")
    wave, wave_len = _waves()
    args = (torch.from_numpy(wave), torch.from_numpy(wave_len))
    kw = dict(beam_size=4, max_len=8, temperature=1.2, eos_filtering=True,
              eos_threshold=-1e9)
    with_w = make_asr_decoder(bare, device="cpu", ctc_weight=0.2, **kw)(*args)
    without = make_asr_decoder(bare, device="cpu", ctc_weight=0.0, **kw)(
        *args)
    for key in ("hypo_text", "hypo_text_len", "hypo_text_confid"):
        assert torch.equal(with_w[key], without[key]), key
    fused = make_asr_decoder(tnet, device="cpu", ctc_weight=0.2, **kw)(*args)
    assert not torch.equal(fused["hypo_text_confid"],
                           without["hypo_text_confid"])


def test_greedy_decode_matches_jax(models):
    from speechain_tpu.infer.asr import asr_greedy_decode as jgreedy
    from speechain_tpu_torch.infer.asr import asr_greedy_decode
    jnet, variables, tnet = models
    wave, wave_len = _waves(seed=24)
    kw = dict(max_len=8, **RECIPE)
    jout = jax.jit(lambda v, w, n: jgreedy(jnet, v, w, n, **kw))(
        variables, jnp.asarray(wave), jnp.asarray(wave_len))
    tout = asr_greedy_decode(tnet, torch.from_numpy(wave),
                             torch.from_numpy(wave_len), device="cpu", **kw)
    _same_decode(tout, jout, nbest=False)
    if not torch.cuda.is_available():      # the card unless the CPU is asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            asr_greedy_decode(tnet, torch.from_numpy(wave),
                              torch.from_numpy(wave_len), **kw)


def test_teacher_scorer_matches_jax(models):
    from speechain_tpu.infer.asr import make_asr_teacher_scorer as jmake
    from speechain_tpu_torch.infer.asr import make_asr_teacher_scorer
    jnet, variables, tnet = models
    wave, wave_len = _waves(seed=25)
    rng = np.random.default_rng(26)
    text = rng.integers(1, V - 1, (2, 7)).astype(np.int32)
    text[:, 0] = V - 1
    text_len = np.array([7, 4], np.int32)          # <sos> ... <eos>, padded
    text[0, 6] = text[1, 3] = V - 1
    text[1, 4:] = 0
    jout = quick_jit(jmake(jnet, temperature=1.2))(
        variables, jnp.asarray(wave), jnp.asarray(wave_len),
        jnp.asarray(text), jnp.asarray(text_len))
    tout = make_asr_teacher_scorer(tnet, device="cpu", temperature=1.2)(
        torch.from_numpy(wave), torch.from_numpy(wave_len),
        torch.from_numpy(text).long(), torch.from_numpy(text_len).long())
    assert set(tout) == set(jout)
    for key in ("hypo_text", "hypo_text_len"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)
    for key in ("hypo_text_confid", "feat_token_len_ratio"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
