"""The PyTorch port's operators against the JAX package, on the CPU.

Each CUDA kernel's wrapper takes its plain PyTorch version for a CPU
tensor; these tests hold that plain version against the JAX kernel it
replaces (run in Pallas interpret mode, as the JAX package's own tests do)
and against the JAX package's XLA path, in float32. Inputs are made with
numpy from a fixed seed.

Tolerances: 1e-5 absolute for the FFN, attention and conv-module kernels
(float32, same rounding points, different summation order); 1e-4 for
log-Mel, the frontend's stated contract. In bfloat16 the kernels are held
to the Pallas kernels at 2^-7 x max|ref| (two bf16 ulps of the largest
output): the rounding points are the same, but the TPU kernel evaluates
its GELU in bf16 arithmetic where the port rounds only z and h.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops import feat_norm as jfn
from speechain_tpu.ops import frontend as jfe
from speechain_tpu_torch.ops import cuda_attention, cuda_convmod, cuda_ffn
from speechain_tpu_torch.ops import feat_norm as tfn
from speechain_tpu_torch.ops import frontend as tfe
from speechain_tpu_torch.ops.cuda_logmel import cuda_logmel

RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close_to_kernel(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _wave(B=2, L=4000, int16=False, seed=0):
    rng = np.random.default_rng(seed)
    if int16:
        wave = rng.integers(-8000, 8000, (B, L)).astype(np.int16)
    else:
        wave = (0.1 * rng.standard_normal((B, L))).astype(np.float32)
    wave_len = np.array([L, L - 1234][:B], np.int32)
    return wave, wave_len


# ---------------------------------------------------------------- log-Mel

@pytest.mark.parametrize("int16,preemphasis,center", [
    (False, 0.97, True), (True, 0.97, True), (False, None, True),
    (False, 0.97, False)])
def test_logmel_matches_jax(int16, preemphasis, center):
    cfg_kw = dict(n_mels=40, preemphasis=preemphasis, center=center)
    wave, wave_len = _wave(int16=int16)
    jfeat, jlen, _, _ = jfe.compute_logmel(
        jnp.asarray(wave), jnp.asarray(wave_len),
        jfe.FrontendConfig(**cfg_kw), use_pallas=False)
    tfeat, tlen = cuda_logmel(_t(wave), _t(wave_len),
                              tfe.FrontendConfig(**cfg_kw))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), atol=1e-4,
                               rtol=0)
    # frames beyond feat_len are exactly zero
    assert float(tfeat[1, int(tlen[1]):].abs().max()) == 0.0


@pytest.mark.parametrize("extra", [
    dict(return_energy=True), dict(pre_stft_norm="mean_std"),
    dict(pre_stft_norm="min_max")])
def test_frontend_plain_pipeline_matches_jax(extra):
    """Configurations the log-Mel kernel does not take (energy output,
    pre-STFT norm) run the plain pipeline, held to the XLA path."""
    cfg_kw = dict(n_mels=40, preemphasis=0.97, **extra)
    wave, wave_len = _wave()
    jout = jfe.compute_logmel(jnp.asarray(wave), jnp.asarray(wave_len),
                              jfe.FrontendConfig(**cfg_kw), use_pallas=False)
    tout = tfe.compute_logmel(_t(wave), _t(wave_len),
                              tfe.FrontendConfig(**cfg_kw))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=1e-4)
    if extra.get("return_energy"):
        np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                                   rtol=1e-5, atol=1e-5)
    else:
        with pytest.raises(NotImplementedError):
            cuda_logmel(_t(wave), _t(wave_len), tfe.FrontendConfig(**cfg_kw))


def test_filterbanks_are_identical_copies():
    for a, b in ((jfe.mel_filterbank(201, 80, 16000),
                  tfe.mel_filterbank(201, 80, 16000)),
                 (jfe.dft_filterbank(400, jfe.hann_window(400)),
                  tfe.dft_filterbank(400, tfe.hann_window(400)))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ feature norm

@pytest.mark.parametrize("norm_type", ["global", "group", "utterance",
                                       "batch"])
def test_feat_norm_eval_matches_jax(norm_type):
    B, T, D, G = 3, 9, 6, 3
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((B, T, D)).astype(np.float32)
    feat_len = np.array([9, 5, 0], np.int32)
    group_ids = np.array([0, 2, 1], np.int32)
    kw = dict(norm_type=norm_type, feat_dim=D, num_groups=G)
    stats_np = dict(
        mean=rng.standard_normal((G, D)).astype(np.float32),
        std=rng.uniform(0.5, 2.0, (G, D)).astype(np.float32),
        batch=np.ones(G, np.float32),
        seen=np.array([True, False, True]),      # group 1 falls back
        aver_mean=rng.standard_normal(D).astype(np.float32),
        aver_std=rng.uniform(0.5, 2.0, D).astype(np.float32))
    jstats = jfn.NormStats(**{k: jnp.asarray(v) for k, v in stats_np.items()})
    tstats = tfn.NormStats(**{k: _t(v) for k, v in stats_np.items()})
    gid = group_ids if norm_type == "group" else None
    jout, _, _ = jfn.apply_feat_norm(
        jstats, jnp.asarray(feat), jnp.asarray(feat_len),
        jfn.FeatNormConfig(**kw), train=False,
        group_ids=None if gid is None else jnp.asarray(gid))
    tout, _ = tfn.apply_feat_norm(
        tstats, _t(feat), _t(feat_len), tfn.FeatNormConfig(**kw),
        group_ids=None if gid is None else _t(gid))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-6)


# ------------------------------------------------------------------- FFN

def _ffn_inputs(N=16, D=128, Fd=256, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    res = rng.standard_normal((N, D)).astype(np.float32)
    k1 = (rng.standard_normal((D, Fd)) / np.sqrt(D)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(Fd)).astype(np.float32)
    k2 = (rng.standard_normal((Fd, D)) / np.sqrt(Fd)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, res, k1, b1, k2, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ffn_plain_matches_pallas_kernel(residual, dtype):
    from speechain_tpu.ops.pallas_ffn import fused_ffn, fused_ffn_residual
    x, res, k1, b1, k2, b2 = _ffn_inputs()
    td, jd = DTYPES[dtype]
    seed = jnp.zeros((1,), jnp.int32)
    J = jnp.asarray
    if residual:
        want = fused_ffn_residual(J(x).astype(jd), J(res).astype(jd), J(k1),
                                  J(b1), J(k2), J(b2), seed, seed, "GELU",
                                  0.0, 0.0, 0.5)
    else:
        want = fused_ffn(J(x).astype(jd), J(k1), J(b1), J(k2), J(b2), seed,
                         "GELU", 0.0)
    got = cuda_ffn.cuda_ffn(_t(x).to(td), _t(k1.T).to(td), _t(b1),
                            _t(k2.T).to(td), _t(b2), "GELU",
                            _t(res).to(td) if residual else None, 0.5)
    assert got.dtype == td
    _close_to_kernel(got, want, dtype)


def test_ffn_plain_bf16_rounding_points():
    """In bfloat16 the plain version rounds z and h to bf16 like the TPU
    kernel: z_bf16 -> gelu -> bf16 -> second product in float32."""
    x, res, k1, b1, k2, b2 = _ffn_inputs(N=8)
    bf = torch.bfloat16
    xb, w1, w2 = _t(x).to(bf), _t(k1.T).to(bf), _t(k2.T).to(bf)
    got = cuda_ffn.ffn_plain(xb, w1, _t(b1), w2, _t(b2), "GELU",
                             _t(res).to(bf), 0.5)
    z = (xb.double() @ w1.double().t() + _t(b1).double()).to(bf)
    h = torch.nn.functional.gelu(z.double()).to(bf).double()
    y = _t(res).to(bf).double() + 0.5 * (h @ w2.double().t()
                                         + _t(b2).double())
    assert got.dtype == bf
    # one bf16 ulp at |y| ~ 4 is 2^-5
    np.testing.assert_allclose(got.double().numpy(), y.numpy(),
                               atol=2 ** -5, rtol=0)


# ------------------------------------------------------ rel-pos attention

def _relpos_inputs(B=2, T=12, D=128, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, D)).astype(np.float32)
               for _ in range(3))
    ph = rng.standard_normal((2 * T - 1, D)).astype(np.float32)
    bu = (0.3 * rng.standard_normal(D)).astype(np.float32)
    bv = (0.3 * rng.standard_normal(D)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 7:] = False
    return q, k, v, ph, bu, bv, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relpos_plain_matches_pallas_kernel(dtype):
    from speechain_tpu.ops.pallas_attention import flash_relpos_attention
    q, k, v, ph, bu, bv, mask = _relpos_inputs()
    td, jd = DTYPES[dtype]
    D, H = q.shape[-1], 2
    scale = 1.0 / np.sqrt(D)

    def J(a):
        return jnp.asarray(a).astype(jd)

    want = flash_relpos_attention(
        J(q), J(k), J(v), J(ph), jnp.asarray(bu).reshape(1, D),
        jnp.asarray(bv).reshape(1, D), jnp.zeros((1,), jnp.int32), scale, H,
        0.0, jnp.asarray(mask).astype(jnp.int32))
    got = cuda_attention.cuda_relpos_attention(
        _t(q).to(td), _t(k).to(td), _t(v).to(td), _t(ph).to(td), _t(bu),
        _t(bv), scale, H, _t(mask))
    assert got.dtype == td
    _close_to_kernel(got, want, dtype)


def test_relpos_fully_masked_row_is_finite_and_uniform():
    q, k, v, ph, bu, bv, mask = _relpos_inputs()
    mask[0] = False                                  # zero-length row
    got = cuda_attention.cuda_relpos_attention(
        _t(q), _t(k), _t(v), _t(ph), _t(bu), _t(bv), 0.1, 2, _t(mask))
    assert torch.isfinite(got).all()
    # a uniform softmax over all keys averages the value rows
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(v[0].mean(0), v[0].shape),
                               atol=1e-5)


def test_rel_shift_matches_jax():
    from speechain_tpu.nn.attention import rel_shift as jrel_shift
    W = RNG.standard_normal((2, 3, 7, 13)).astype(np.float32)
    np.testing.assert_array_equal(
        cuda_attention.rel_shift(_t(W)).numpy(),
        np.asarray(jrel_shift(jnp.asarray(W))))


# ------------------------------------------------------------- conv module

def _convmod_inputs(B=2, T=20, C=128, K=7, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    x[1, 13:] = 0.0                                  # padded frames
    w1 = (rng.standard_normal((C, 2 * C)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
    dwk = (rng.standard_normal((K, C)) / np.sqrt(K)).astype(np.float32)
    dwb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, w1, b1, dwk, dwb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convmod_plain_matches_pallas_kernel(dtype):
    from speechain_tpu.ops.pallas_convmod import fused_conv_glu_dw
    x, w1, b1, dwk, dwb = _convmod_inputs()
    td, jd = DTYPES[dtype]
    K = dwk.shape[0]
    J = jnp.asarray
    ju, js, jss = fused_conv_glu_dw(J(x).astype(jd), J(w1), J(b1), J(dwk),
                                    J(dwb), K)
    u, s, ss = cuda_convmod.cuda_conv_glu_dw(
        _t(x).to(td), _t(w1.T).to(td), _t(b1).to(td),
        _t(dwk.T[:, None, :]), _t(dwb).to(td))
    assert u.dtype == td
    _close_to_kernel(u, ju, dtype)
    # sums over B*T = 40 frames of the rounded u: 1e-5 relative to their size
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(js)).max())
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


def test_kernel_wrappers_take_plain_version_on_cpu():
    """A CPU tensor never reaches a kernel: no launch is counted, forward
    or backward, and every entry point has its own count."""
    from speechain_tpu_torch.ops import entry_points, kernels
    from speechain_tpu_torch.ops.cuda_flash_attention import flash_attention
    before = [dict(k.counts) for k in kernels()]
    x, w1, b1, dwk, dwb = _convmod_inputs(T=5)
    cuda_convmod.cuda_conv_glu_dw(_t(x), _t(w1.T), _t(b1),
                                  _t(dwk.T[:, None, :]), _t(dwb))
    xf, res, k1, b1f, k2, b2 = _ffn_inputs(N=4)
    xt = _t(xf).requires_grad_()
    cuda_ffn.cuda_ffn(xt, _t(k1.T), _t(b1f), _t(k2.T), _t(b2)).sum(
        ).backward()
    q = torch.randn(2, 3, 8, requires_grad=True)
    flash_attention(q, q, q, 0.5, 2, causal=True).sum().backward()
    wave, wave_len = _wave(B=1)
    cuda_logmel(_t(wave), _t(wave_len), tfe.FrontendConfig(n_mels=8))
    from speechain_tpu_torch.ops.cuda_layernorm import fused_layer_norm
    from speechain_tpu_torch.ops.cuda_prenet import fused_prenet_core
    xl = torch.randn(8, 128, requires_grad=True)
    fused_layer_norm(xl, torch.ones(128), torch.zeros(128)).sum().backward()
    pw = [torch.randn(*s, requires_grad=True)
          for s in ((9, 64), (64,), (64,), (9, 64, 64))]
    fused_prenet_core(torch.randn(1, 9, 9), *pw, "LeakyReLU").sum(
        ).backward()
    from speechain_tpu_torch.infer.ctc_scorer import CTCPrefixScorer
    scorer = CTCPrefixScorer(torch.log_softmax(torch.randn(1, 4, 5), -1),
                             torch.tensor([4]), 2, eos_id=4)
    state = scorer.init_state()
    scorer.update_state(state, scorer.score(state), torch.tensor([0, 1]),
                        torch.tensor([2, 3]))
    assert [dict(k.counts) for k in kernels()] == before
    assert [k.name for k in kernels()] == ["logmel", "ffn",
                                           "relpos_attention", "convmod",
                                           "flash_attention", "layernorm",
                                           "prenet", "ctc_prefix"]
    assert [k.entry_name(s) for k, s in entry_points()] == [
        "logmel", "ffn", "ffn_backward", "relpos_attention",
        "relpos_attention_backward", "convmod", "convmod_backward",
        "flash_attention", "flash_attention_backward", "layer_norm",
        "layer_norm_backward", "prenet_core", "prenet_core_backward",
        "ctc_prefix_score", "ctc_prefix_update"]
