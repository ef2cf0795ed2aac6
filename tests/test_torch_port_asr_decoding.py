"""The port's ASR decoding options against the JAX package, on the CPU:
the CTC prefix scorer, the two CTC kernels' order of work (emulated in
plain PyTorch), joint attention + CTC beam search at the recipes'
temperature and CTC weight, greedy decoding and teacher-forced scoring.

A tiny conformer ARASRNet (2 + 2 layers, d 32, V 23, T_enc 12 and 8):
seeded numpy values fill the JAX variables, bridged into the port; both
decode the same numpy waveforms (the port with ``device="cpu"``, i.e. the
CTC kernels' plain versions).

Tolerances: scorer entries within 1e-4 x max(1, |ref|) (the emulated
kernels' within 1e-4 x max(1, max|ref|), as the card's check), entries
at or below -1e19 (NEG_INF sums) at or below it on both sides; hypotheses
token-equal, scores within 1e-4; teacher-forced outputs within 1e-5.
"""

import re
from pathlib import Path

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


def _close(got, want, what, whole=False):
    """Entries of ``want`` above BIG within 1e-4 x max(1, |want|) (with
    ``whole``, 1e-4 x max(1, max|want| over them)); those at or below BIG
    at or below it in ``got`` too."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    big = want <= BIG
    np.testing.assert_array_equal(got <= BIG, big, err_msg=what)
    err = np.abs(got - want)[~big]
    ref = np.abs(want)[~big]
    tol = 1e-4 * np.maximum(1.0, ref.max(initial=0.0) if whole else ref)
    assert (err <= tol).all(), (what, float((err - tol).max()))


# ---- the scorer -------------------------------------------------------

SCORER_B, SCORER_K, SCORER_T, SCORER_V = 2, 3, 12, 7


def _scorer_pair(seed, temperature, T, silence=0):
    """JAX's and the port's scorer over the same log_softmax(temperature x
    randn) (row 1 four frames short; blank certain in the first
    ``silence`` frames); JAX's score and update_state jitted once."""
    from speechain_tpu.infer.ctc_scorer import CTCPrefixScorer as JScorer
    from speechain_tpu_torch.infer.ctc_scorer import CTCPrefixScorer
    B, K, Vs = SCORER_B, SCORER_K, SCORER_V
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, Vs)).astype(np.float32) * temperature
    logits[:, :silence, 0] += 100.0
    x = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    enc_len = np.array([T, T - 4], np.int32)
    js = JScorer(jnp.asarray(x), jnp.asarray(enc_len), K, eos_id=Vs - 1)
    ts = CTCPrefixScorer(torch.from_numpy(x), torch.from_numpy(enc_len), K,
                         eos_id=Vs - 1)
    return js, jax.jit(js.score), jax.jit(js.update_state), ts


@pytest.fixture(scope="module")
def scorers():
    """The scorers of log_softmax(2 randn) over SCORER_T frames."""
    return _scorer_pair(23, 2.0, SCORER_T)


@pytest.fixture(scope="module")
def peaky_scorers():
    """Peaky log-probs over 70 frames: three of the score kernel's chunks
    (32, 32, 6) and three frames a lane in the update's scan. A leading
    silence of 40 frames puts the largest term of most columns in the
    second chunk, so the running sum is rescaled there."""
    return _scorer_pair(24, 20.0, 70, silence=40)


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


# ---- the kernels' order of work (csrc/ctc_prefix.cu), emulated -----------

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
NO_MAX = -1e30                  # the kernels' running max before any frame
LANES = 32


def _source_int(name):
    """A constexpr int of csrc/ctc_prefix.cu."""
    src = (Path(__file__).resolve().parents[1] / "speechain_tpu_torch" /
           "csrc" / "ctc_prefix.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _lane_lse(v):
    """The last-token column of one row: lane l takes frames l, l + 32, ...
    of ``v`` (log2 units, frame order), a max pass and a sum pass, then
    the butterfly over lanes (xor 16, 8, 4, 2, 1) the kernel runs. (The
    kernel loads FU = 8 frames a lane at a time and rescales between such
    groups: one group up to T 257, as here.)"""
    n = -(-v.numel() // LANES) * LANES
    lanes = torch.full((n,), NO_MAX)
    lanes[:v.numel()] = v
    lanes = lanes.view(-1, LANES)                  # [j, lane]: frame 32 j + l
    ok = (torch.arange(n) < v.numel()).view(-1, LANES)
    m = torch.full((LANES,), NO_MAX)
    for row in lanes:
        m = torch.maximum(m, row)
    s = torch.zeros(LANES)
    for row, o in zip(lanes, ok):
        s = torch.where(o, s + torch.exp2(row - m), s)
    lane = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        mo, so = m[lane ^ off], s[lane ^ off]
        mm = torch.maximum(m, mo)
        s = s * torch.exp2(m - mm) + so * torch.exp2(mo - mm)
        m = mm
    return (m[0] + torch.log2(s[0])) * LN2 if s[0] > 0 else -1e20


def _emulated_score(ts, state):
    """ctc_prefix_score in the kernel's order: LSE over frames t of
    phi'_t + x_t in log2 units (phi'_0 = 0 at prefix length 0, NEG_INF
    after; phi'_t = r_sum[t - 1]), TC-frame chunks each a max pass, the
    running sum rescaled once, a sum pass in frame order; one log2 a
    column; then the last-token columns over lanes with r_b as phi."""
    from speechain_tpu_torch.ops.cuda_ctc_prefix import NEG_INF, logaddexp
    tc = _source_int("TC")
    x, r, K = ts.x, state.r, ts.K
    B, T, V = x.shape
    BK = B * K
    xr = x[ts.row]                                        # (BK, T, V)
    r_sum = logaddexp(r[:, 0], r[:, 1])                   # (T, BK)
    phi0 = torch.full((1, BK), 0.0 if state.prefix_len == 0 else NEG_INF)
    phi = torch.cat([phi0, r_sum[:-1]]) * LOG2E           # (T, BK)
    m = torch.full((BK, V), NO_MAX)
    s = torch.zeros(BK, V)
    for t0 in range(0, T, tc):
        frames = range(t0, min(T, t0 + tc))
        mc = m
        for t in frames:
            mc = torch.maximum(mc, xr[:, t] * LOG2E + phi[t][:, None])
        s = s * torch.exp2(m - mc)
        m = mc
        for t in frames:
            s = s + torch.exp2(xr[:, t] * LOG2E + phi[t][:, None] - m)
    out = (m + torch.log2(s)) * LN2
    for i in range(BK):
        c = int(state.last_token[i])
        if c < 0 or c in (ts.eos_id, ts.blank_id):
            continue
        v = (xr[i, 1:, c] * LOG2E + r[:-1, 1, i] * LOG2E)
        out[i, c] = _lane_lse(v)
    last = ts.enc_len[ts.row] - 1
    last = torch.where(last < 0, last + T, last)
    out[:, ts.eos_id] = r_sum[last, torch.arange(BK)]
    out[:, ts.blank_id] = NEG_INF
    return out - state.psi[:, None]


def _emulated_update(ts, state, scores, beam_idx, token):
    """ctc_prefix_update in the kernel's order: lane l composes the
    log-semiring maps of frames 1 + l per .. l per + per (per = ceil((T -
    1) / 32)), a Hillis-Steele scan over the 32 lanes composes them, and
    each lane replays its frames from the state its prefix gives. Each
    logaddexp in the reference's formula (the kernel's, on the special-
    function units, is within ~2e-7 of it)."""
    from speechain_tpu_torch.ops.cuda_ctc_prefix import NEG_INF
    from speechain_tpu_torch.ops.cuda_ctc_prefix import logaddexp as lae
    x, r, K = ts.x, state.r, ts.K
    B, T, V = x.shape
    BK = B * K
    x_tok = x[ts.row[:, None], torch.arange(T)[None], token[:, None]]
    xb = ts.x_blank[ts.row]                               # (BK, T)
    r_old = r[:, :, beam_idx]
    rep = (token == state.last_token[beam_idx])[:, None]
    phi = torch.where(rep.T, r_old[:, 1], lae(r_old[:, 0], r_old[:, 1])).T
    per = -(-(T - 1) // LANES)
    lane = torch.arange(LANES)
    lo = torch.clamp(1 + lane * per, max=T)               # lanes' frames
    hi = torch.clamp(lo + per, max=T)
    neg = torch.full((BK, LANES), NEG_INF)
    zero = torch.zeros(BK, LANES)
    a, b, c, d, e, f = zero, neg, neg, neg, zero, neg     # identity maps
    for j in range(per):
        t = lo + j
        ok = (t < hi)[None]
        tc = torch.clamp(t, max=T - 1)
        xt, xbt, ph = x_tok[:, tc], xb[:, tc], phi[:, tc - 1]
        new = (a + xt, b + xt, lae(c, ph) + xt,
               lae(a, d) + xbt, lae(b, e) + xbt, lae(c, f) + xbt)
        a, b, c, d, e, f = (torch.where(ok, n, o)
                            for n, o in zip(new, (a, b, c, d, e, f)))

    def compose(F, G):                                    # F after G
        fa, fb, fc, fd, fe, ff = F
        ga, gb, gc, gd, ge, gf = G
        return (lae(fa + ga, fb + gd), lae(fa + gb, fb + ge),
                lae(lae(fa + gc, fb + gf), fc),
                lae(fd + ga, fe + gd), lae(fd + gb, fe + ge),
                lae(lae(fd + gc, fe + gf), ff))

    maps = (a, b, c, d, e, f)
    dd = 1
    while dd < LANES:
        shifted = tuple(torch.cat([m[:, :dd], m[:, :-dd]], 1) for m in maps)
        comp = compose(maps, shifted)
        maps = tuple(torch.where(lane[None] >= dd, n, o)
                     for n, o in zip(comp, maps))
        dd *= 2
    pa, pb, pc, pd, pe, pf = (torch.cat([m[:, :1], m[:, :-1]], 1)
                              for m in maps)
    n0 = (x_tok[:, 0] if state.prefix_len == 0
          else torch.full((BK,), NEG_INF))[:, None]
    k0 = torch.full((BK, 1), NEG_INF)
    first = (lane == 0)[None]
    n = torch.where(first, n0, lae(lae(pa + n0, pb + k0), pc))
    k = torch.where(first, k0, lae(lae(pd + n0, pe + k0), pf))
    r_new = torch.empty(T, 2, BK)
    r_new[0, 0], r_new[0, 1] = n0[:, 0], k0[:, 0]
    for j in range(per):
        t = lo + j
        ok = t < hi
        tc = torch.clamp(t, max=T - 1)
        nn = lae(n, phi[:, tc - 1]) + x_tok[:, tc]
        k = lae(n, k) + xb[:, tc]
        n = nn
        r_new[t[ok], 0] = n[:, ok].T
        r_new[t[ok], 1] = k[:, ok].T
    return r_new, state.psi[beam_idx] + scores[beam_idx, token]


@pytest.mark.parametrize("case", ["scorers", "peaky_scorers"])
def test_ctc_kernel_order_matches_jax(request, case):
    """The two CTC kernels' arithmetic, emulated in the order the kernels
    do it, against JAX's scorer along prefixes of lengths 0-6: repeated
    tokens (every other row repeats its own last token), beams of one
    utterance extending different tokens, row 1 four frames short."""
    js, jscore, jupdate, ts = request.getfixturevalue(case)
    B, K = SCORER_B, SCORER_K
    BK = B * K
    jst, tst = js.init_state(), ts.init_state()
    beam_idx = (np.arange(BK) // K) * K + (np.arange(BK) + 1) % K
    src = torch.from_numpy(beam_idx)
    for step, tok in enumerate([3, 3, 5, 2, 2, 4, None]):
        what = f"{case}, prefix length {step}"
        _close(tst.r.numpy(), jst.r, f"{what}: r", whole=True)
        _close(tst.psi.numpy(), jst.psi, f"{what}: psi", whole=True)
        jsc, tsc = jscore(jst), _emulated_score(ts, tst)
        _close(tsc.numpy(), jsc, f"{what}: score", whole=True)
        if tok is None:
            break
        toks = np.full(BK, tok, np.int64)
        toks[1::K] = tok % 4 + 1
        if step > 0:
            toks[::2] = tst.last_token.numpy()[beam_idx][::2]
        jst = jupdate(jst, jsc, jnp.asarray(beam_idx),
                      jnp.asarray(toks, jnp.int32))
        tok_t = torch.from_numpy(toks)
        r, psi = _emulated_update(ts, tst, tsc, src, tok_t)
        tst = tst._replace(r=r, psi=psi, last_token=tok_t,
                           prefix_len=step + 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its CUDA branch up to the launch (which needs nvcc)."""

    @property
    def is_cuda(self):
        return True


class _Launched(Exception):
    pass


def test_ctc_update_frame_limit(monkeypatch):
    """The update kernel stages a row's 3 T floats in shared memory: its
    wrapper's frame limit is reckoned from the source's rows a block, the
    CUDA branch takes T up to it and raises a ValueError naming it past
    it, before any launch; the plain version takes any T."""
    from speechain_tpu_torch.ops import cuda_ctc_prefix as cp

    def launch(*args):
        raise _Launched

    assert cp.UPDATE_WARPS == _source_int("UPDATE_WARPS")
    assert 3 * 4 * cp.UPDATE_WARPS * (cp.UPDATE_MAX_FRAMES + 1) \
        > 227 * 1024 >= 3 * 4 * cp.UPDATE_WARPS * cp.UPDATE_MAX_FRAMES
    monkeypatch.setattr(cp.KERNEL, "launch", launch)
    monkeypatch.setattr(cp, "stream_ptr", lambda t: 0)

    def args(T, wrap):
        f = torch.zeros
        a = (f(1, T, 2), f(1, T), f(T, 2, 1), f(1),
             torch.zeros(1, dtype=torch.int64), f(1, 2),
             torch.zeros(1, dtype=torch.int64),
             torch.ones(1, dtype=torch.int64))
        return [torch.Tensor._make_subclass(_OnCard, t) if wrap else t
                for t in a]

    with pytest.raises(_Launched):
        cp.ctc_prefix_update(*args(cp.UPDATE_MAX_FRAMES, True), 0, 1)
    with pytest.raises(ValueError, match=f"at most {cp.UPDATE_MAX_FRAMES}"):
        cp.ctc_prefix_update(*args(cp.UPDATE_MAX_FRAMES + 1, True), 0, 1)
    r_new, _ = cp.ctc_prefix_update(*args(cp.UPDATE_MAX_FRAMES + 1, False),
                                    0, 1)
    assert r_new.shape == (cp.UPDATE_MAX_FRAMES + 1, 2, 1)


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
