"""Tiles, order of sums and launch geometry of the log-Mel kernel
(``speechain_tpu_torch/csrc/logmel.cu``: ``logmel_tile<TF>``), checked on
the CPU.

No card is needed. The kernel is emulated with numpy, its index formulas
copied from the source:

- the segment: sample i of a block's TT = 8 TF frames belongs to frame
  q = min(i / S, TT - 1) at offset i - q S (S = min(hop, n_fft)), the
  padded signal's position g = (t0 + q) hop + i - q S, reflected into the
  pre-emphasised waveform, zero past the padded end;
- the fill: e / o of basis row j for frame t from the segment (folded:
  n = j + 1, e = x[n] + x[N - n], o = x[n] - x[N - n], e = x[N/2] and o =
  0 at n = N/2; direct: e = o = x[j]) at column 8 (t / TF) + t % TF;
- the micro-tile: warp w, lane l, frame slot i, bin slot k read column
  8 w + i and the staged row's cos at (k / 4) 128 + 4 l + k % 4 and sin
  256 further, for frame w TF + i and bin p 224 + 7 l + k of pass p; each
  re and im one float32 multiply-add chain over the rows in order;
- folded, the low bins 0 .. 6 summed again by the direct DFT, rows in
  order, with the plain version's basis;
- the power re^2 + im^2 (or its root), then each mel filter summed over
  its band in ascending bins, clamp, log, / log(base), zero beyond
  feat_len.

It checks that every (frame, bin) is covered exactly once, that the mel
bands hold every non-zero of ``mel_filterbank``, that :func:`geometry`'s
grid and shared bytes follow the source's constants, and that the
emulated features are within 1e-4 of ``logmel_plain`` and below 1e-4 of
the float64 golden of ``tests/test_frontend.py`` (the frontend contract)
on ``test_logmel_parity``'s configs, and within 1e-4 of the direct DFT's
single chains (the plain version's order on the card) at a frame whose
mel bin 0 holds almost no power, where the fold alone is not.
"""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from speechain_tpu_torch.ops import cuda_logmel as cm
from speechain_tpu_torch.ops import frontend as tfe
from speechain_tpu_torch.ops.cuda_build import CSRC, SMEM_LIMIT

SOURCE = (CSRC / "logmel.cu").read_text()
F32 = np.float32

ASR = tfe.FrontendConfig(n_mels=80, preemphasis=0.97)
TTS = tfe.FrontendConfig(n_mels=80, win_length=0.05, hop_length=0.0125,
                         fmin=125, fmax=7600)
DIRECT = tfe.FrontendConfig(n_mels=80, preemphasis=0.97, win_length=399,
                            n_fft=400)
HTK = tfe.FrontendConfig(n_mels=40, win_length=400, hop_length=160,
                         mel_scale="htk", mag_spec=True, mel_norm=False)
PARITY = (tfe.FrontendConfig(n_mels=80, win_length=0.025, hop_length=0.01,
                             preemphasis=0.97), TTS, HTK)


def cdiv(a, b):
    return -(-a // b)


def fma(a, b, c):
    """float32 a * b + c with one rounding of the exact product's sum
    (float64 holds the product of two float32 values exactly)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def emphasized(w, x, length, pe):
    """The staged sample of waveform row w at index x (the source's
    ``emphasized``: x[i] - p x[i - 1], each rounded, 0 from ``length``)."""
    v = w[x]
    if pe is None:
        return v
    prev = np.where(x > 0, w[np.maximum(x - 1, 0)], F32(0))
    v = (v - (F32(pe) * prev).astype(F32)).astype(F32)
    return np.where(x < length, v, F32(0))


def segment(w, length, cfg, t0, tt, L):
    N, hop = cfg.fft, cfg.hop
    S = min(hop, N)
    pad = N // 2 if cfg.center else 0
    i = np.arange((tt - 1) * S + N)
    q = np.minimum(i // S, tt - 1)
    g = (t0 + q) * hop + (i - q * S)
    x = g - pad
    x = np.where(x < 0, -x, x)
    x = np.where(x >= L, 2 * (L - 1) - x, x)
    inside = g < L + 2 * pad
    v = emphasized(w, np.where(inside, x, 0), length, cfg.preemphasis)
    return np.where(inside, v, F32(0)).astype(F32)


def fill(seg, cfg, geo, tf):
    """e / o (rows padded to KC, 2, 8 WARPS columns) as the fill writes
    them for a block (columns no frame owns: NaN, never read)."""
    N, S = cfg.fft, min(cfg.hop, cfg.fft)
    t = np.arange(geo["frames"])[:, None]
    j = np.arange(cdiv(geo["rows"], cm.KC) * cm.KC)[None, :]
    if geo["variant"] == "folded":
        n = j + 1
        inner, mid = n < N // 2, n == N // 2
        a = seg[t * S + np.minimum(n, N // 2)]
        r = seg[t * S + N - np.minimum(n, N // 2)]
        e = np.where(inner, a + r, np.where(mid, a, F32(0)))
        o = np.where(inner, a - r, F32(0))
    else:
        e = o = np.where(j < N, seg[t * S + np.minimum(j, N - 1)], F32(0))
    eo = np.full((j.shape[1], 2, 8 * cm.WARPS), np.nan, F32)
    col = ((t // tf) * 8 + t % tf)[:, 0]
    eo[:, 0, col], eo[:, 1, col] = e.T, o.T
    return eo


def micro_tile(tf):
    """(warp, lane, i, k) -> frame, bin of pass 0, column read, cos and
    sin offsets in a staged row: arrays of shape (WARPS, 32, TF, TB)."""
    w, l, i, k = np.meshgrid(np.arange(cm.WARPS), np.arange(32),
                             np.arange(tf), np.arange(cm.TB), indexing="ij")
    frame = w * tf + i
    bin_ = cm.TB * l + k
    col = 8 * w + i
    cos = (k // 4) * 128 + 4 * l + k % 4
    return frame, bin_, col, cos, cos + 256


def main_rows(staged):
    """The staged chunks' KC basis rows: (passes, chunks x KC, ROW)."""
    passes, nc, _ = staged.shape
    return staged[:, :, :cm.KC * cm.ROW].reshape(passes, nc * cm.KC, cm.ROW)


def low_rows_of(staged):
    """The staged chunks' LR low-basis rows, pass 0: (chunks x LR,
    LOW_ROW)."""
    return staged[0, :, cm.KC * cm.ROW:].reshape(-1, cm.LOW_ROW)


def low_chains(seg, cfg, tt, low_rows):
    """The low bins' power as the kernel sums it: thread (g, t) reads row
    r of chunk c's low rows at r LOW_ROW + 2 g (and + 1) for cos and
    LOW_ROW / 2 further for sin, and x of frame t, row LR c + r, one chain
    a bin over the rows in order."""
    N, S = cfg.fft, min(cfg.hop, cfg.fft)
    x = seg[np.arange(tt)[:, None] * S + np.arange(N)[None, :]]
    re_ = np.zeros((tt, 8), F32)
    im_ = np.zeros((tt, 8), F32)
    k = np.arange(8)                            # 2 g and 2 g + 1, g < 4
    for n in range(N):
        row = low_rows[n]
        re_ = fma(x[:, n:n + 1], row[k][None], re_)
        im_ = fma(x[:, n:n + 1], row[cm.LOW_ROW // 2 + k][None], im_)
    return power(re_, im_, cfg)[:, :cm.TB]


def direct_power(seg, cfg, tt, bins):
    """Power of ``bins`` for tt frames of a segment by the direct DFT: one
    float32 multiply-add chain over rows n = 0 .. N - 1 in order, with the
    plain version's basis (the kernel's low bins; the plain version's
    order on the card)."""
    N, S = cfg.fft, min(cfg.hop, cfg.fft)
    dft = tfe.dft_filterbank(N, tfe.hann_window(cfg.win), cfg.onesided,
                             cfg.normalized)
    F_ = cfg.n_freqs
    x = seg[np.arange(tt)[:, None] * S + np.arange(N)[None, :]]
    re_ = np.zeros((tt, len(bins)), F32)
    im_ = np.zeros((tt, len(bins)), F32)
    for n in range(N):
        re_ = fma(x[:, n:n + 1], dft[bins, n][None], re_)
        im_ = fma(x[:, n:n + 1], dft[F_ + bins, n][None], im_)
    return power(re_, im_, cfg)


def power(re_, im_, cfg):
    v = (re_ * re_ + im_ * im_).astype(F32)     # each product rounded
    return np.sqrt(v) if cfg.mag_spec else v


def mel_log(pw, cfg):
    """The banded mel product of a power tile (frames, n_freq), then
    clamp / log / log(base), as the kernel's last step."""
    mel_w, mel_lo, mel_off = cm.band_weights(cfg)
    acc = np.zeros((pw.shape[0], cfg.n_mels), F32)
    cnt = np.diff(mel_off)
    for q in range(cnt.max(initial=0)):         # ascending bins
        m = np.nonzero(q < cnt)[0]
        acc[:, m] = fma(pw[:, mel_lo[m] + q], mel_w[mel_off[m] + q],
                        acc[:, m])
    if cfg.logging:
        log_div = math.log(cfg.log_base) if cfg.log_base is not None else 1.0
        acc = (np.log(np.maximum(acc, F32(cfg.clamp)), dtype=F32)
               / F32(log_div)).astype(F32)
    return acc


def emulate(wave, wave_len, cfg, tf=None, sms=cm.SMS, low=True):
    """The kernel's (feat (B, T, n_mels), feat_len) in numpy float32;
    ``low=False`` leaves the folded low bins as the fold summed them."""
    wave = np.asarray(wave, F32)
    B, L = wave.shape
    geo = cm.geometry(cfg, B, L, sms, tf)
    tf, tt = geo["tf"], geo["frames"]
    N, hop, F_ = cfg.fft, cfg.hop, cfg.n_freqs
    T = int(tfe.num_frames(L, N, hop, cfg.center))
    feat_len = tfe.num_frames(np.asarray(wave_len), N, hop, cfg.center)
    staged = cm.staged_basis(cfg)                   # (passes, chunks, CH)
    basis, low_rows = main_rows(staged), low_rows_of(staged)
    frame, bin_, col, cos, sin = micro_tile(tf)
    out = np.zeros((B, T, cfg.n_mels), F32)
    for b in range(B):
        for tile in range(geo["grid"][0]):
            t0 = tile * tt
            seg = segment(wave[b], wave_len[b], cfg, t0, tt, L)
            eo = fill(seg, cfg, geo, tf)
            pw = np.zeros((tt, F_), F32)
            for p in range(geo["passes"]):
                re_ = np.zeros(frame.shape, F32)
                im_ = np.zeros(frame.shape, F32)
                for j in range(basis.shape[1]):
                    row = basis[p, j]
                    re_ = fma(eo[j, 0, col], row[cos], re_)
                    im_ = fma(eo[j, 1, col], row[sin], im_)
                k = p * cm.BINS + bin_
                ok = k < F_
                pw[frame[ok], k[ok]] = power(re_, im_, cfg)[ok]
            if geo["low"] and low:
                pw[:, :geo["low"]] = low_chains(seg, cfg, tt, low_rows)
            nt = min(tt, T - t0)
            valid = (t0 + np.arange(nt) < feat_len[b])[:, None]
            out[b, t0:t0 + nt] = np.where(valid, mel_log(pw[:nt], cfg),
                                          F32(0))
    return out, feat_len


def direct_chain(wave, wave_len, cfg):
    """The log-Mel of one float32 multiply-add chain a bin over every row
    in order (the plain version's order on the card: its product with the
    basis and the mel matrix each one chain a column)."""
    wave = np.asarray(wave, F32)
    B, L = wave.shape
    N, hop = cfg.fft, cfg.hop
    T = int(tfe.num_frames(L, N, hop, cfg.center))
    feat_len = tfe.num_frames(np.asarray(wave_len), N, hop, cfg.center)
    out = np.zeros((B, T, cfg.n_mels), F32)
    for b in range(B):
        seg = segment(wave[b], wave_len[b], cfg, 0, T, L)
        pw = direct_power(seg, cfg, T, np.arange(cfg.n_freqs))
        valid = (np.arange(T) < feat_len[b])[:, None]
        out[b] = np.where(valid, mel_log(pw, cfg), F32(0))
    return out


def source_int(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return eval(m.group(1), {}, {k: source_int(k) for k in
                                 re.findall(r"[A-Z_]{2,}", m.group(1))})


def test_constants_follow_the_source():
    for name in ("WARPS", "TB", "BINS", "ROW", "KC", "STAGES", "EO_ROW",
                 "LOW_ROW", "LR", "XS_ROW", "CH"):
        assert source_int(name) == getattr(cm, name), name
    built = [int(t) for t in re.findall(r"case (\d+): return launch<\1>",
                                        SOURCE)]
    default = int(re.search(r"default: return launch<(\d+)>", SOURCE)
                  .group(1))
    assert tuple(sorted(built + [default])) == cm.FRAMES_PER_WARP
    m = re.search(r"bool built\(int tf\) \{\s*return ([^;]+);", SOURCE)
    assert [tf for tf in range(1, 17) if eval(
        m.group(1).replace("||", " or ").replace("&&", " and "),
        {"tf": tf})] == list(cm.FRAMES_PER_WARP)


@pytest.mark.parametrize("tf", cm.FRAMES_PER_WARP)
@pytest.mark.parametrize("F_", [201, 401, 513])
def test_every_frame_and_bin_once(tf, F_):
    frame, bin_, col, cos, sin = micro_tile(tf)
    tt = cm.WARPS * tf
    seen = np.zeros((tt, cdiv(F_, cm.BINS) * cm.BINS), int)
    for p in range(cdiv(F_, cm.BINS)):
        np.add.at(seen, (frame.ravel(), (p * cm.BINS + bin_).ravel()), 1)
    assert (seen == 1).all()
    # the fill's column of each frame is the column its warp reads
    t = np.arange(tt)
    assert ((t // tf) * 8 + t % tf == col[t // tf, 0, t % tf, 0]).all()
    assert col.max() < 8 * cm.WARPS and (col % 8 < tf).all()
    # cos / sin offsets: 7 distinct of each lane's 16 staged floats, the
    # 4-float group of lane l at g 128 + 4 l (16-byte loads, no overlap)
    assert len(np.unique(np.concatenate([cos[0, :, 0].ravel(),
                                         sin[0, :, 0].ravel()]))) == 32 * 14
    assert ((cos % 128) // 4 == np.arange(32)[None, :, None, None]).all()


@pytest.mark.parametrize("cfg", [ASR, TTS, DIRECT, HTK,
                                 tfe.FrontendConfig(onesided=False),
                                 tfe.FrontendConfig(normalized=True)])
def test_staged_basis_and_bands(cfg):
    """The staged basis holds the plain basis' rows at the source's
    offsets (folded rows 1 .. N/2, else all), zeros elsewhere; each mel
    band covers exactly its filter's non-zeros."""
    plain = tfe.dft_filterbank(cfg.fft, tfe.hann_window(cfg.win),
                               cfg.onesided, cfg.normalized)
    F_ = cfg.n_freqs
    staged = cm.staged_basis(cfg)
    st = main_rows(staged)
    geo = cm.geometry(cfg, 1, 20000)
    assert staged.shape[2] == source_int("CH")
    low = low_rows_of(staged)
    assert not staged[1:, :, cm.KC * cm.ROW:].any()
    if geo["low"]:
        np.testing.assert_array_equal(low[:cfg.fft], cm.low_basis(cfg))
        assert not low[cfg.fft:].any()
    else:
        assert not low.any()
    first = 1 if geo["variant"] == "folded" else 0
    assert geo["variant"] == ("folded" if cfg.win == cfg.fft else "direct")
    _, bin_, _, cos, sin = micro_tile(1)
    got = np.zeros((geo["rows"], 2, geo["passes"] * cm.BINS), F32)
    for p in range(geo["passes"]):
        got[:, 0, p * cm.BINS + bin_] = st[p, :geo["rows"]][:, cos]
        got[:, 1, p * cm.BINS + bin_] = st[p, :geo["rows"]][:, sin]
    n = np.arange(first, first + geo["rows"])
    np.testing.assert_array_equal(got[:, 0, :F_], plain[:F_, n].T)
    np.testing.assert_array_equal(got[:, 1, :F_], plain[F_:, n].T)
    assert not got[:, :, F_:].any() and not st[:, geo["rows"]:].any()
    assert np.count_nonzero(st) == np.count_nonzero(got)
    fb = tfe.mel_filterbank(F_, cfg.n_mels, cfg.sr, cfg.fmin, cfg.fmax,
                            cfg.mel_scale, cfg.mel_norm)
    w, lo, off = cm.band_weights(cfg)
    rebuilt = np.zeros_like(fb)
    for m in range(cfg.n_mels):
        rebuilt[lo[m]:lo[m] + off[m + 1] - off[m], m] = w[off[m]:off[m + 1]]
        if off[m + 1] > off[m]:
            assert w[off[m]] != 0 and w[off[m + 1] - 1] != 0
    np.testing.assert_array_equal(rebuilt, fb)


@pytest.mark.parametrize("cfg,low", [(ASR, 7), (TTS, 0), (DIRECT, 0),
                                     (HTK, 7)])
def test_low_bins(cfg, low):
    """Folded configs whose mel filters weigh a bin below TB redo bins
    0 .. TB - 1 (TTS's filters start at 125 Hz, bin 7); the low basis is
    the plain basis' columns bit for bit."""
    assert cm.band_counts(cfg)[1] == low == cm.geometry(cfg, 2, 9000)["low"]
    plain = tfe.dft_filterbank(cfg.fft, tfe.hann_window(cfg.win),
                               cfg.onesided, cfg.normalized)
    F_ = cfg.n_freqs
    lb = cm.low_basis(cfg)
    assert lb.shape == (cfg.fft, source_int("LOW_ROW"))
    np.testing.assert_array_equal(lb[:, :cm.TB], plain[:cm.TB].T)
    np.testing.assert_array_equal(lb[:, 8:8 + cm.TB], plain[F_:F_ + cm.TB].T)
    assert not lb[:, cm.TB].any() and not lb[:, 8 + cm.TB:].any()


def smem_reckoned(tt, S, N, F_, low, nnz, n_mels):
    """``smem_floats`` as the source writes it, in bytes."""
    def round4(n):
        return (n + 3) & ~3
    return 4 * (source_int("STAGES") * source_int("CH")
                + 2 * source_int("KC") * source_int("EO_ROW")
                + round4(tt * F_) + round4((tt - 1) * S + N)
                + (round4(2 * source_int("LR") * source_int("XS_ROW"))
                   if low else 0) + round4(nnz) + 2 * n_mels + 1)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("cfg,B,L,want", [
    (ASR, 16, 128000, {132: 7, 114: 5}), (TTS, 16, 128000, {132: 6, 114: 6}),
    (ASR, 3, 12345, {132: 2, 114: 2}), (DIRECT, 16, 128000, {132: 7, 114: 5})])
def test_geometry_follows_the_source(cfg, B, L, want, sms):
    geo = cm.geometry(cfg, B, L, sms)
    T = int(tfe.num_frames(L, cfg.fft, cfg.hop, cfg.center))
    tt = source_int("WARPS") * geo["tf"]
    assert geo["tf"] == want[sms] and geo["frames"] == tt
    assert geo["grid"] == (cdiv(T, tt), B)
    assert geo["threads"] == 32 * source_int("WARPS")
    nnz = int(cm.band_weights(cfg)[2][-1])
    assert geo["nnz"] == nnz and geo["low"] == cm.band_counts(cfg)[1]
    assert geo["smem"] == smem_reckoned(
        tt, min(cfg.hop, cfg.fft), cfg.fft, cfg.n_freqs, geo["low"], nnz,
        cfg.n_mels) <= SMEM_LIMIT
    assert geo["passes"] * source_int("BINS") >= cfg.n_freqs
    if geo["low"]:      # the low chains: 4 TT threads, LR rows a chunk
        assert 4 * tt <= geo["threads"] and 8 >= source_int("TB")
        assert source_int("LR") * cdiv(geo["rows"], cm.KC) >= cfg.fft
    # the pick: no other fitting instance takes fewer reckoned cycles
    rows = cdiv(geo["rows"], cm.KC) * cm.KC * geo["passes"]
    for tf in cm.FRAMES_PER_WARP:
        if smem_reckoned(source_int("WARPS") * tf, min(cfg.hop, cfg.fft),
                         cfg.fft, cfg.n_freqs, geo["low"], nnz,
                         cfg.n_mels) > SMEM_LIMIT:
            with pytest.raises(ValueError):
                cm.geometry(cfg, B, L, sms, tf)
            continue
        other = cm.geometry(cfg, B, L, sms, tf)
        assert cm._cycles(B * other["grid"][0], rows, tf, sms) >= \
            cm._cycles(B * geo["grid"][0], rows, geo["tf"], sms)


def test_every_config_the_parent_took_fits():
    """n_fft up to 1024 at any hop: some built instance fits (the parent's
    32 frames of n_fft + n_freq floats fit up to n_fft 1024 onesided)."""
    for n_fft in (256, 400, 512, 800, 1024):
        for hop in (1, 160, n_fft, 3 * n_fft):
            cfg = tfe.FrontendConfig(win_length=n_fft, hop_length=hop)
            assert cm.geometry(cfg, 2, 4 * n_fft)["smem"] <= SMEM_LIMIT


def _wave(B, L, seed, int16=False):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.standard_normal((B, L))).astype(F32)
    lens = np.array([L, L - 1000, 500][:B], np.int32)
    return wave, lens


@pytest.mark.parametrize("cfg,tf", [(ASR, None), (ASR, 2), (TTS, None),
                                    (DIRECT, 5), (HTK, 2)])
def test_emulation_matches_plain(cfg, tf):
    wave, lens = _wave(3, 6000, 7)
    got, got_len = emulate(wave, lens, cfg, tf)
    want, want_len = cm.logmel_plain(torch.from_numpy(wave),
                                     torch.from_numpy(lens), cfg)
    np.testing.assert_array_equal(got_len, want_len.numpy())
    err = np.abs(got - want.numpy()).max()
    assert err < 1e-4, err
    assert not got[2, int(got_len[2]):].any()


@pytest.mark.parametrize("cfg", PARITY)
def test_emulation_meets_the_float64_golden(cfg):
    from tests.test_frontend import _rand_batch, numpy_f64_logmel
    wave, lens = _rand_batch()
    got, _ = emulate(wave, lens, cfg)
    err = np.abs(got - numpy_f64_logmel(wave, lens, cfg)).max()
    assert err < 1e-4, err


def _quiet_bin_one(cfg, frame=20, target=2e-4, seed=3):
    """A noise waveform plus the 40 Hz sinusoid that leaves bin 1 of
    ``frame`` (pre-emphasised, windowed) at magnitude ``target``: mel bin
    0 then sits just above the clamp, where float32 rounding decides it."""
    rng = np.random.default_rng(seed)
    L = 6000
    n = np.arange(L)
    N, hop = cfg.fft, cfg.hop
    w = np.zeros(N)
    w[:cfg.win] = tfe.hann_window(cfg.win)      # centred: n_fft == win

    def bin1(x):
        y = x - cfg.preemphasis * np.concatenate([[0.0], x[:-1]])
        y = np.pad(y, N // 2, mode="reflect")[frame * hop:frame * hop + N]
        return np.sum(y * w * np.exp(-2j * np.pi * np.arange(N) / N))

    noise = 0.1 * rng.standard_normal(L)
    c, s_ = np.cos(2 * np.pi * n / N), np.sin(2 * np.pi * n / N)
    A = np.array([[bin1(c).real, bin1(s_).real], [bin1(c).imag,
                                                  bin1(s_).imag]])
    a, b = np.linalg.solve(A, [target - bin1(noise).real,
                               -bin1(noise).imag])
    wave = (noise + a * c + b * s_).astype(F32)[None]
    return wave, np.array([L], np.int32)


def test_low_bins_follow_the_plain_order():
    wave, lens = _quiet_bin_one(ASR)
    want = direct_chain(wave, lens, ASR)
    assert want[0, 20, 0] > -9.5                 # above the clamp's -10
    got, _ = emulate(wave, lens, ASR)
    assert np.abs(got - want).max() < 1e-4
    folded_only, _ = emulate(wave, lens, ASR, low=False)
    assert np.abs(folded_only - want)[0, 20, 0] > 1e-4


def main(seed: int = 1, B: int = 16, L: int = 128000) -> None:
    """The fold's drift at the smoke run's scale, printed: B utterances of
    L samples of noise (0.1 N(0, 1), utterance 1 12,345 samples short) at
    the ASR config, max |log-Mel| difference of the emulated kernel with
    and without its low bins summed again, against the direct DFT's single
    chains (the plain version's order on the card) and the float64
    golden. ``python -m tests.test_torch_port_logmel_tiles`` from the
    repository's root; ~1 min."""
    from tests.test_frontend import numpy_f64_logmel
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.standard_normal((B, L))).astype(F32)
    lens = np.full(B, L, np.int32)
    lens[1] = L - 12345
    chain = direct_chain(wave, lens, ASR)
    golden = numpy_f64_logmel(wave, lens, ASR)
    for low in (False, True):
        got, _ = emulate(wave, lens, ASR, low=low)
        print(f"low bins summed again: {low}: max |kernel - direct chain| "
              f"{np.abs(got - chain).max():.3e}, max |kernel - float64| "
              f"{np.abs(got - golden).max():.3e}")
    print(f"direct chain: max |direct chain - float64| "
          f"{np.abs(chain - golden).max():.3e}")


if __name__ == "__main__":
    main()
