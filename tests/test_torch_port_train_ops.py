"""The PyTorch port's training operators against the JAX package, on the CPU.

Each CUDA kernel's wrapper takes its plain PyTorch version for a CPU
tensor; these tests hold that plain version, forward and gradients
(autograd), against the JAX kernel it replaces in Pallas interpret mode,
at dropout 0 and 0.1: the port draws its dropout masks with the same
integer mixer and indexing as the JAX kernels' interpret mode, so the
masks agree bit for bit. Inputs are made with numpy from fixed seeds.

Tolerances: 1e-5 absolute (float32, same rounding points, different
summation order) for the kernels, the criteria, the feature norm and
SpecAugment; 1e-4 for log-Mel (the frontend's contract) and the CTC loss
value (a sum over alignments); 1e-7 for the optimizer's parameters;
exact equality for dropout bits and for the schedule at counts 0-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechain_tpu.ops import feat_norm as jfn
from speechain_tpu.ops import frontend as jfe
from speechain_tpu.ops import specaug as jsa
from speechain_tpu.ops.pallas_attention import _dropout_mask, flash_attention
from speechain_tpu.ops.pallas_ffn import _pick_rows, fused_ffn_residual
from speechain_tpu.train import criteria as jcrit
from speechain_tpu.train import optim as joptim
from speechain_tpu_torch.ops import dropout as tdrop
from speechain_tpu_torch.ops import feat_norm as tfn
from speechain_tpu_torch.ops import frontend as tfe
from speechain_tpu_torch.ops import specaug as tsa
from speechain_tpu_torch.ops.cuda_ffn import cuda_ffn
from speechain_tpu_torch.ops.cuda_flash_attention import (
    flash_attention as tflash)
from speechain_tpu_torch.train import criteria as tcrit
from speechain_tpu_torch.train import optim as toptim

J = jnp.asarray


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------- dropout

@pytest.mark.parametrize("seed", [0, 12345, -7, 2 ** 31 - 1])
def test_dropout_bits_match_jax_interpret_mixer(seed):
    for rate, (R, C) in ((0.1, (8, 48)), (0.3, (5, 7))):
        want = _dropout_mask((R, C), rate, jnp.int32(seed))
        got = tdrop.rows_mask(R, C, rate, seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pick_rows_is_a_copy():
    for n in (1, 7, 8, 24, 496, 2985, 3184, 4096):
        assert tdrop.pick_rows(n) == _pick_rows(n)


# -------------------------------------------------------------------- FFN

@pytest.mark.parametrize("rate,res_rate", [(0.0, 0.0), (0.1, 0.1)])
def test_ffn_residual_fwd_and_vjp_match_pallas(rate, res_rate):
    rng = np.random.default_rng(0)
    N, D, Fd = 24, 32, 64           # _pick_rows(24) = 8: three streams
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    res = rng.standard_normal((2, 12, D)).astype(np.float32)
    k1 = (rng.standard_normal((D, Fd)) / np.sqrt(D)).astype(np.float32)
    k2 = (rng.standard_normal((Fd, D)) / np.sqrt(Fd)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(Fd)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((2, 12, D)).astype(np.float32)
    seed, rseed = 1234567, -89

    def jf(x, res, k1, b1, k2, b2):
        return fused_ffn_residual(
            x, res, k1, b1, k2, b2, jnp.int32(seed), jnp.int32(rseed),
            "GELU", rate, res_rate, 0.5)

    want, vjp = jax.vjp(jf, J(x), J(res), J(k1), J(b1), J(k2), J(b2))
    wgrads = vjp(J(g))
    targs = [_t(x, True), _t(res, True), _t(k1.T, True), _t(b1, True),
             _t(k2.T, True), _t(b2, True)]
    got = cuda_ffn(targs[0], targs[2], targs[3], targs[4], targs[5], "GELU",
                   targs[1], 0.5, rate, res_rate, seed, rseed)
    close(got, want)
    (got * _t(g)).sum().backward()
    for i, (a, w) in enumerate(zip(targs, wgrads)):
        w = np.asarray(w)
        close(a.grad, w.T if i in (2, 4) else w)


# -------------------------------------------------------- flash attention

CASES = {
    # name: (Tq, Tk, causal, key lengths)
    "causal_self_with_empty_row": (6, 6, True, [6, 0]),
    "cross_tq_ne_tk": (5, 9, False, [9, 4]),
    "self_no_mask": (7, 7, False, None),
}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_fwd_and_vjp_match_pallas(case, rate):
    Tq, Tk, causal, lens = CASES[case]
    B, D, H = 2, 32, 2
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, D)).astype(np.float32)
    g = rng.standard_normal((B, Tq, D)).astype(np.float32)
    km = None if lens is None else (
        np.arange(Tk)[None] < np.array(lens)[:, None]).astype(np.int32)
    seed, scale = 424242, D ** -0.5

    def jf(q, k, v):
        return flash_attention(q, k, v, jnp.array([seed], jnp.int32), scale,
                               H, causal, rate,
                               None if km is None else J(km))

    want, vjp = jax.vjp(jf, J(q), J(k), J(v))
    wgrads = vjp(J(g))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = tflash(tq, tk, tv, scale, H, causal, rate, seed,
                 None if km is None else _t(km))
    assert torch.isfinite(got).all()
    close(got, want)
    (got * _t(g)).sum().backward()
    for a, w in zip((tq, tk, tv), wgrads):
        close(a.grad, w)


# ------------------------------------------------------- feature norm train

@pytest.mark.parametrize("norm_type", ["global", "group"])
def test_feat_norm_training_updates_match_jax(norm_type):
    rng = np.random.default_rng(2)
    B, T, D, G = 4, 11, 6, 3
    cfg_kw = dict(norm_type=norm_type, num_groups=G if norm_type == "group"
                  else 1, feat_dim=D, max_epoch_num=1)
    jcfg, tcfg = jfn.FeatNormConfig(**cfg_kw), tfn.FeatNormConfig(**cfg_kw)
    gids = (np.array([0, 2, 2, 1], np.int32) if norm_type == "group"
            else None)
    jstats = jfn.init_stats(jcfg)
    tstats = tfn.init_stats(tcfg)
    for epoch in (0, 1, 5):          # the third step is past max_epoch_num
        feat = (rng.standard_normal((B, T, D)) * 2 + 1).astype(np.float32)
        flen = np.array([T, 7, 0, 4], np.int32)
        jout, _, jstats = jfn.apply_feat_norm(
            jstats, J(feat), J(flen), jcfg, train=True, epoch=J(epoch),
            group_ids=None if gids is None else J(gids))
        tout, _ = tfn.apply_feat_norm(
            tstats, _t(feat), _t(flen), tcfg, train=True,
            epoch=torch.tensor(epoch),
            group_ids=None if gids is None else _t(gids))
        close(tout, jout)
        for name, a, w in zip(tfn.NormStats._fields, tstats, jstats):
            close(a.float(), np.asarray(w, np.float32))


# ------------------------------------------------------------ SpecAugment

@pytest.mark.parametrize("feat_norm", [True, False])
def test_spec_augment_law_with_jax_draws(feat_norm):
    cfg_kw = dict(freq_mask_width=5, time_mask_width=0.2, feat_norm=feat_norm)
    jcfg, tcfg = (jsa.SpecAugmentConfig(**cfg_kw),
                  tsa.SpecAugmentConfig(**cfg_kw))
    B, T, D = 3, 40, 12
    feat = np.random.default_rng(3).standard_normal((B, T, D)).astype(
        np.float32)
    flen = np.array([40, 33, 37], np.int32)
    key = jax.random.PRNGKey(7)
    want = jsa.spec_augment(key, J(feat), J(flen), jcfg)
    # the reference's own draws, split as spec_augment splits its key
    k_warp, k_flen, k_fpos, k_tlen, k_tpos = jax.random.split(key, 5)
    k1, k2 = jax.random.split(k_warp)
    u = lambda k, s: _t(jax.random.uniform(k, s))
    N = (B, 2)
    draws = tsa.SpecAugDraws(u(k1, ()), u(k2, ()), u(k_flen, N),
                             u(k_fpos, N), u(k_tlen, N), u(k_tpos, N))
    got = tsa.spec_augment(_t(feat), _t(flen), tcfg, draws)
    close(got, want)
    # the law changed something: warp and masks are both active here
    assert not np.allclose(np.asarray(want), feat)


def test_warp_segments_matches_jax():
    feat = np.random.default_rng(4).standard_normal((2, 20, 3)).astype(
        np.float32)
    for c, t, m in ((8, 10, 17), (5, 3, 20), (9, 9, 12)):
        close(tsa.warp_segments(_t(feat), c, t, m),
              jsa.warp_segments(J(feat), c, t, m))


# ---------------------------------------------------------------- criteria

def _crit_inputs():
    rng = np.random.default_rng(5)
    B, L, V, T = 4, 6, 11, 7
    logits = rng.standard_normal((B, L - 1, V)).astype(np.float32) * 2
    text = rng.integers(1, V, (B, L)).astype(np.int32)
    text[0, 2] = text[0, 3]                 # a repeat: needs a blank
    text_len = np.array([6, 4, 0, 1], np.int32)
    ctc = rng.standard_normal((B, T, V)).astype(np.float32)
    ctc_len = np.array([7, 2, 5, 7], np.int32)  # row 1 cannot align
    return logits, text, text_len, ctc, ctc_len


def test_cross_entropy_and_accuracy_match_jax():
    logits, text, text_len, _, _ = _crit_inputs()
    for eps in (0.0, 0.2):
        jl, jg = jax.value_and_grad(lambda x: jcrit.cross_entropy(
            x, J(text), J(text_len), label_smoothing=eps))(J(logits))
        tl = _t(logits, True)
        got = tcrit.cross_entropy(tl, _t(text), _t(text_len),
                                  label_smoothing=eps)
        got.backward()
        close(got, jl)
        close(tl.grad, jg)
    close(tcrit.accuracy(_t(logits), _t(text), _t(text_len)),
          jcrit.accuracy(J(logits), J(text), J(text_len)))


def test_ctc_loss_infeasible_and_empty_rows_match_jax():
    _, text, text_len, ctc, ctc_len = _crit_inputs()
    ctext, clen = text[:, 1:], np.maximum(text_len - 2, 0)
    clen[1] = 4                              # 4 labels in 2 frames
    jl, jg = jax.value_and_grad(lambda x: jcrit.ctc_loss(
        x, J(ctc_len), J(ctext), J(clen)))(J(ctc))
    tl = _t(ctc, True)
    got = tcrit.ctc_loss(tl, _t(ctc_len), _t(ctext), _t(clen))
    got.backward()
    assert np.isfinite(float(jl))
    close(got, jl, atol=1e-4)
    close(tl.grad, jg, atol=1e-5)
    assert float(tl.grad[1].abs().max()) == 0.0   # the infeasible row


# ----------------------------------------------------------- optimization

def test_noam_schedule_counts_match_jax():
    js = joptim.noam_schedule(2e-3, 16000)
    ts = toptim.noam_schedule(2e-3, 16000)
    for c in (0, 1, 2, 3):               # optax's count: 0 and 1 agree
        assert float(ts(torch.tensor(c, dtype=torch.int32))) == float(
            js(jnp.int32(c)))
    assert float(ts(torch.tensor(0))) == float(ts(torch.tensor(1)))
    for c in (16000, 40000):             # pow vs rsqrt: one float32 ulp
        np.testing.assert_allclose(
            float(ts(torch.tensor(c, dtype=torch.int32))),
            float(js(jnp.int32(c))), rtol=2e-7)


def test_flat_adam_with_clip_and_nonfinite_skip_matches_optax():
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    names = sorted(shapes)
    kw = dict(optim_conf=dict(lr=2e-3, betas=(0.9, 0.98), eps=1e-9),
              warmup_steps=10, grad_clip=1.0)
    jtx = joptim.build_optimizer(**kw)
    ttx = toptim.build_optimizer(**kw)
    jp = {k: J(v) for k, v in params.items()}
    tp = [_t(params[k]) for k in names]
    jst, tst = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        grads = {k: (3 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        if step == 1:
            grads["b"][2] = np.inf           # skipped update
        upd, jst = jtx.update({k: J(v) for k, v in grads.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = ttx.update([_t(grads[k]) for k in names], tst, tp)
        for k, p in zip(names, tp):
            close(p, jp[k], atol=1e-7)
    assert int(tst["count"]) == 3 and int(tst["notfinite"]) == 1


# ------------------------------------------------- pre-STFT normalization

@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("norm", ["mean_std", "min_max"])
def test_logmel_pre_stft_norm_takes_the_plain_pipeline(norm, int16):
    """pre_stft_norm configs leave the log-Mel kernel (which applies no
    such normalization, as the TPU kernel does not) for the plain
    pipeline; held against the JAX package's XLA pipeline."""
    rng = np.random.default_rng(7)
    L = 4000
    wave = (rng.integers(-9000, 9000, (3, L)).astype(np.int16) if int16
            else (0.1 * rng.standard_normal((3, L))).astype(np.float32))
    wave_len = np.array([L, L - 1234, 900], np.int32)
    kw = dict(n_mels=40, preemphasis=0.97, pre_stft_norm=norm)
    want = jfe.compute_logmel(J(wave), J(wave_len),
                              jfe.FrontendConfig(**kw), use_pallas=False)
    got = tfe.compute_logmel(_t(wave), _t(wave_len),
                             tfe.FrontendConfig(**kw))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[0], want[0], atol=1e-4)
    plain = tfe.compute_logmel(_t(wave), _t(wave_len), tfe.FrontendConfig(
        n_mels=40, preemphasis=0.97))
    assert float((plain[0] - got[0]).abs().max()) > 1e-2
