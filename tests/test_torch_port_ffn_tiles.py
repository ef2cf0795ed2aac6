"""Launch geometry and fragment maps of the bf16 FFN kernels
(``speechain_tpu_torch/csrc/ffn.cu``: ``ffn_fwd_tc``, ``ffn_bwd_rows_tc``,
``ffn_wgrad_tc``), checked on the CPU.

No card is needed: the kernels' index arithmetic (which rows and columns a
block stages, which shared-memory rows each ``ldmatrix`` reads, which
accumulator element of which warp holds which product) is emulated with
numpy, copied from the source's formulas, and the shared-memory and
register reckoning is Python (the smoke run holds it equal to the built
kernels' own). The emulated ``mma.sync`` tiles must give ``ffn_plain``'s
output and its autograd gradients, and the (row, column) of every
accumulator element, fed through ``ops/dropout.py``'s FFN indexing, must
reproduce ``ffn_mask`` with every element visited once. A slip in these
maps passes at dropout 0 and shows only at dropout > 0, or only on the
card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from speechain_tpu_torch.ops import cuda_ffn
from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_build import SMEM_LIMIT
from speechain_tpu_torch.ops.cuda_ffn import (SM_SMEM, TC_TILES,
                                              check_aligned,
                                              check_tc_widths, ffn_plain,
                                              tc_blocks_per_sm,
                                              tc_geometry,
                                              tc_register_budget,
                                              tc_smem_bytes)

TR = TW = 64                       # csrc/ffn.cu TR, TW
LDT = TW + 8
LANE = np.arange(32)
GQ, Q = LANE // 4, 2 * (LANE % 4)
RECIPE_WIDTHS = (256, 384, 512, 768)
RECIPE_F = (1024, 1536, 2048, 3072)


def pad64(n):
    return -(-n // TW) * TW


def tiles64(n):
    return -(-n // TW)


# --------------------------------------- staging, ldmatrix and mma.sync

def stage_rows(X, r0, W):
    """stage_rows: rows [r0, r0 + 64) of X (rows x W) by 16-byte chunks
    into a 64 x (pad64(W) + 8) tile, zeros past the rows and past W; NaN
    where nothing is written (the 8-value pad, never read)."""
    rows = X.shape[0]
    ch, ld = pad64(W) // 8, pad64(W) + 8
    S = np.full((TR, ld), np.nan)
    for e in range(TR * ch):
        r, c = e // ch, (e - (e // ch) * ch) * 8
        ok = r0 + r < rows and c < W
        S[r, c:c + 8] = X[r0 + r, c:c + 8] if ok else 0.0
    return S


def stage_tile(M, row0, col0):
    """stage_tile: the 64 x 64 tile at (row0, col0) of M, zeros past its
    rows and columns, into a 64 x LDT tile (NaN in the pad)."""
    rows, cols = M.shape
    S = np.full((TR, LDT), np.nan)
    for e in range(TR * (TW // 8)):
        r, c = e >> 3, (e & 7) * 8
        ok = row0 + r < rows and col0 + c < cols
        S[r, c:c + 8] = M[row0 + r, col0 + c:col0 + c + 8] if ok else 0.0
    return S


def ldsm(S, rows, cols, trans=False):
    """ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8
    (S[rows[l], cols[l] .. + 8)); returns r[lane, m] (value pairs). Each
    8-lane phase must read 8 distinct 16-byte bank groups."""
    ld = S.shape[1]
    for m in range(4):
        groups = {((rows[8 * m + i] * ld + cols[8 * m + i]) * 2 // 16) % 8
                  for i in range(8)}
        assert len(groups) == 8, "ldmatrix bank conflict"
    mats = S[rows[:, None], cols[:, None] + np.arange(8)].reshape(4, 8, 8)
    e = np.arange(2)
    if trans:
        r = mats[:, Q[:, None] + e, GQ[:, None]]          # (4, 32, 2)
    else:
        r = mats[:, GQ[:, None], Q[:, None] + e]
    assert not np.isnan(r).any(), "ldmatrix read an unwritten element"
    return r.transpose(1, 0, 2)                           # (32, 4, 2)


def mma(acc, a, b0, b1):
    """mma.sync m16n8k16: acc (32, 4) += A B in the PTX fragment layout
    (csrc/mma.cuh) from a (32, 4, 2), b0 and b1 (32, 2)."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for k, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        A[GQ[:, None] + dr, Q[:, None] + dc + np.arange(2)] = a[:, k]
    Bm[Q[:, None] + np.arange(2), GQ[:, None]] = b0
    Bm[Q[:, None] + 8 + np.arange(2), GQ[:, None]] = b1
    C = A @ Bm
    acc += np.stack([C[GQ, Q], C[GQ, Q + 1], C[GQ + 8, Q],
                     C[GQ + 8, Q + 1]], axis=1)


def warp_mma64(acc, A, a_row, ka, B, c0, trans):
    """warp_mma64<TRANS>: acc (4, 32, 4) += A rows [a_row, a_row + 16)
    over K = 64 from column ka, times the staged tile B over its columns
    [c0, c0 + 32)."""
    pa_r = a_row + (LANE & 7) + 8 * ((LANE >> 3) & 1)
    pa_c = ka + 8 * (LANE >> 4)
    for ks in range(TW // 16):
        a = ldsm(A, pa_r, pa_c + 16 * ks)
        for np_ in range(2):
            if trans:
                b = ldsm(B, (LANE & 7) + 8 * ((LANE >> 3) & 1) + 16 * ks,
                         c0 + 8 * (LANE >> 4) + 16 * np_, trans=True)
            else:
                b = ldsm(B, c0 + (LANE & 7) + 8 * (LANE >> 4) + 16 * np_,
                         8 * ((LANE >> 3) & 1) + 16 * ks)
            mma(acc[2 * np_], a, b[:, 0], b[:, 1])
            mma(acc[2 * np_ + 1], a, b[:, 2], b[:, 3])


def frag(w):
    """(row, column) within a 64 x 64 product of warp w's accumulator
    element i of n-tile n in lane l: arrays (4 n, 32 lanes, 4 i)."""
    n = np.arange(4)[:, None, None]
    i = np.arange(4)[None, None, :]
    lane = LANE[None, :, None]
    row = 16 * (w & 3) + lane // 4 + 8 * (i // 2) + 0 * n
    col = 32 * (w >> 2) + 8 * n + 2 * (lane % 4) + i % 2
    return row, col


def keep(rows, cols, C, rate, seed, pick):
    """Drop::keep at (row, column): stream seed + row / pick, element
    (row % pick) * C + col (0 where rate is 0: no site)."""
    if rate == 0.0:
        return np.ones(np.shape(rows))
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    bits = drop.dropout_bits(torch.from_numpy((rows % pick) * C + cols),
                             torch.from_numpy(seed + rows // pick))
    return drop.mask_from_bits(bits, rate).double().numpy()


# -------------------------------------------------- the emulated kernels

def forward_tc(x, w1, b1, w2, b2, res, alpha, nt, rate=0.0, res_rate=0.0,
               seed=0, res_seed=0, act=lambda v: np.maximum(v, 0.0)):
    """ffn_fwd_tc<nt> over its whole grid in float64, index maps as in
    the source; no roundings (the inputs keep every value exact)."""
    N, D = x.shape
    Fd, Do = w1.shape[0], w2.shape[0]
    pick = drop.pick_rows(N)
    out = np.full((N, Do), np.nan)
    KD, nch = tiles64(D), tiles64(Fd)
    for bx in range(tiles64(N)):
        for by in range(-(-tiles64(Do) // nt)):
            r0, o0 = bx * TR, by * nt * TW
            nto = min(nt, tiles64(Do - o0))
            Xs = stage_rows(x, r0, D)
            y = np.zeros((nt, 8, 4, 32, 4))           # [t][warp] acc
            for c in range(nch):
                z = np.zeros((8, 4, 32, 4))
                for kd in range(KD):
                    T = stage_tile(w1, c * TW, kd * TW)
                    for w in range(8):
                        warp_mma64(z[w], Xs, 16 * (w & 3), kd * TW, T,
                                   32 * (w >> 2), False)
                Hs = np.full((TR, LDT), np.nan)
                for w in range(8):
                    rl, cl = frag(w)
                    f, row = c * TW + cl, r0 + rl
                    fz = np.minimum(f, Fd - 1)
                    h = act(z[w] + b1[fz])
                    h = h * keep(row, f, Fd, rate, seed, pick)
                    Hs[rl, cl] = np.where(f < Fd, h, 0.0)
                for t in range(nto):
                    T = stage_tile(w2, o0 + t * TW, c * TW)
                    for w in range(8):
                        warp_mma64(y[t, w], Hs, 16 * (w & 3), 0, T,
                                   32 * (w >> 2), False)
            for t in range(nto):
                for w in range(8):
                    rl, cl = frag(w)
                    row, col = r0 + rl, o0 + t * TW + cl
                    ok = (row < N) & (col < Do)
                    v = y[t, w] + b2[np.minimum(col, Do - 1)]
                    if res is not None:
                        v = v * keep(row, col, Do, res_rate, res_seed, pick)
                        v = res[np.minimum(row, N - 1),
                                np.minimum(col, Do - 1)] + alpha * v
                    assert np.isnan(out[row[ok], col[ok]]).all()  # once
                    out[row[ok], col[ok]] = v[ok]
    return out


def backward_rows_tc(x, w1, b1, w2, g, alpha, nt, rate=0.0, res_rate=0.0,
                     seed=0, res_seed=0):
    """ffn_bwd_rows_tc<nt> (ReLU) over its whole grid: dx, and ht, dz, g_c
    as the lead column group writes them."""
    N, D = x.shape
    Fd, Do = w1.shape[0], w2.shape[0]
    pick = drop.pick_rows(N)
    dx = np.full((N, D), np.nan)
    ht, dz = np.full((N, Fd), np.nan), np.full((N, Fd), np.nan)
    gc = np.full((N, Do), np.nan)
    KD, KO, nch = tiles64(D), tiles64(Do), tiles64(Fd)
    for bx in range(tiles64(N)):
        for by in range(-(-KD // nt)):
            r0, d0, lead = bx * TR, by * nt * TW, by == 0
            ntd = min(nt, tiles64(D - d0))
            Xs = stage_rows(x, r0, D)
            hp = pad64(Do) // 2                      # g_c into Gs
            Gs = np.full((TR, pad64(Do) + 8), np.nan)
            for e in range(TR * hp):
                r, col = e // hp, 2 * (e - (e // hp) * hp)
                row = r0 + r
                v = np.zeros(2)
                if row < N and col < Do:
                    v = alpha * (g[row, col:col + 2] * keep(
                        [row, row], [col, col + 1], Do, res_rate, res_seed,
                        pick))
                    if lead:
                        gc[row, col:col + 2] = v
                Gs[r, col:col + 2] = v
            dxa = np.zeros((nt, 8, 4, 32, 4))
            for c in range(nch):
                acc = np.zeros((8, 4, 32, 4))
                for kd in range(KD):
                    T = stage_tile(w1, c * TW, kd * TW)
                    for w in range(8):
                        warp_mma64(acc[w], Xs, 16 * (w & 3), kd * TW, T,
                                   32 * (w >> 2), False)
                zs = []
                for w in range(8):
                    rl, cl = frag(w)
                    f, row = c * TW + cl, r0 + rl
                    ok = f < Fd
                    z = np.where(ok, acc[w] + b1[np.minimum(f, Fd - 1)], 0)
                    h = np.maximum(z, 0.0) * keep(row, f, Fd, rate, seed,
                                                  pick)
                    wr = ok & (row < N)
                    if lead:
                        assert np.isnan(ht[row[wr], f[wr]]).all()
                        ht[row[wr], f[wr]] = h[wr]
                    zs.append(z)
                acc = np.zeros((8, 4, 32, 4))
                for ko in range(KO):
                    T = stage_tile(w2, ko * TW, c * TW)
                    for w in range(8):
                        warp_mma64(acc[w], Gs, 16 * (w & 3), ko * TW, T,
                                   32 * (w >> 2), True)
                Ds = np.full((TR, LDT), np.nan)
                for w in range(8):
                    rl, cl = frag(w)
                    f, row = c * TW + cl, r0 + rl
                    ok = (f < Fd) & (row < N)
                    d = (zs[w] > 0) * (acc[w] * keep(row, f, Fd, rate, seed,
                                                     pick))
                    d = np.where(ok, d, 0.0)
                    if lead:
                        assert np.isnan(dz[row[ok], f[ok]]).all()
                        dz[row[ok], f[ok]] = d[ok]
                    Ds[rl, cl] = d
                for t in range(ntd):
                    T = stage_tile(w1, c * TW, d0 + t * TW)
                    for w in range(8):
                        warp_mma64(dxa[t, w], Ds, 16 * (w & 3), 0, T,
                                   32 * (w >> 2), True)
            for t in range(ntd):
                for w in range(8):
                    rl, cl = frag(w)
                    row, col = r0 + rl, d0 + t * TW + cl
                    ok = (row < N) & (col < D)
                    assert np.isnan(dx[row[ok], col[ok]]).all()
                    dx[row[ok], col[ok]] = dxa[t, w][ok]
    return dx, ht, dz, gc


def wgrad_blocks(N, D, Fd, Do):
    """ffn_wgrad_tc's blocks: (matrix, i0, j0, M1, M2) of each blockIdx.x,
    and the 64-row stages each sums, in order."""
    T1 = tiles64(Fd) * tiles64(D)
    out = []
    for b in range(T1 + tiles64(Do) * tiles64(Fd)):
        if b < T1:
            m, M1, M2, bb = 1, Fd, D, b
        else:
            m, M1, M2, bb = 2, Do, Fd, b - T1
        out.append((m, bb // tiles64(M2) * TW, bb % tiles64(M2) * TW, M1,
                    M2))
    return out, [s * TW for s in range(tiles64(N))]


def wgrad_tc(A, B, i0, j0, bias=0, gs=None):
    """One ffn_wgrad_tc block: the 64 x 64 tile (i0, j0) of A^T B, warp w
    rows 32 (w % 2), columns 32 (w / 2), both operands read transposed;
    with bias 1 also the column sums of A's staged tiles (db1), with bias
    2 those of gs (db2), over the partial sums of the source's threads."""
    N = A.shape[0]
    acc = np.zeros((4, 2, 4, 32, 4))
    half = np.zeros((2, TW))                  # db1: thread (column, half)
    quad = np.zeros((8, TW))                  # db2: thread (row group, col)
    for s in range(tiles64(N)):
        At, Bt = stage_tile(A, s * TW, i0), stage_tile(B, s * TW, j0)
        if bias == 1:
            for bh in range(2):
                half[bh] += At[32 * bh:32 * bh + 32, :TW].sum(0)
        elif bias == 2:
            for grow in range(8):
                for k in range(8):
                    row = s * TW + grow + 8 * k
                    if row < N:
                        cols = np.arange(i0, i0 + TW)
                        quad[grow] += np.where(cols < gs.shape[1],
                                               gs[row, np.minimum(
                                                   cols, gs.shape[1] - 1)],
                                               0.0)
        for w in range(4):
            mw, nw = 32 * (w & 1), 32 * (w >> 1)
            for ks in range(TW // 16):
                a = [ldsm(At, (LANE & 7) + 8 * (LANE >> 4) + 16 * ks,
                          mw + 8 * ((LANE >> 3) & 1) + 16 * mt, trans=True)
                     for mt in range(2)]
                for np_ in range(2):
                    bv = ldsm(Bt, (LANE & 7) + 8 * ((LANE >> 3) & 1) +
                              16 * ks, nw + 8 * (LANE >> 4) + 16 * np_,
                              trans=True)
                    for mt in range(2):
                        mma(acc[w, mt, 2 * np_], a[mt], bv[:, 0], bv[:, 1])
                        mma(acc[w, mt, 2 * np_ + 1], a[mt], bv[:, 2],
                            bv[:, 3])
    tile = np.full((TW, TW), np.nan)
    for w in range(4):
        for mt in range(2):
            rl, cl = frag(0)           # lane / 4 + 8 (i / 2), 8 n + 2 (l % 4)
            tile[32 * (w & 1) + 16 * mt + rl, 32 * (w >> 1) + cl] = \
                acc[w, mt]
    bsum = half[0] + half[1] if bias == 1 else quad.sum(0)
    return tile, bsum


# ------------------------------------------------- (a) the products

def _ints(rng, *shape, lo=-1, hi=1):
    return rng.integers(lo, hi + 1, shape).astype(np.float64)


def _problem(seed, N=77, D=72, Fd=136, Do=200):
    """Ragged everywhere: 2 row tiles (the second of 13 rows), D in 2 K
    slices (8 of the second's 64 columns), F in 3 chunks (8 of the last's),
    Do in 4 output tiles (8 of the last's). Small integers keep every
    product, sum and bf16 value exact, so any order of summation agrees."""
    rng = np.random.default_rng(seed)
    return dict(x=_ints(rng, N, D), w1=_ints(rng, Fd, D), b1=_ints(
        rng, Fd, lo=-2, hi=2), w2=_ints(rng, Do, Fd), b2=_ints(rng, Do),
        res=_ints(rng, N, Do), g=_ints(rng, N, Do))


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_emulated_forward_tiles_give_ffn_plain(nt):
    """Every instance, with its column groups (Do split 4, 2 and 1 ways):
    the emulated block grid gives ffn_plain's output exactly, each output
    element written once, every ldmatrix conflict-free and reading only
    staged values."""
    p = _problem(nt)
    got = forward_tc(p["x"], p["w1"], p["b1"], p["w2"], p["b2"], p["res"],
                     1.0, nt)
    t = {k: torch.from_numpy(v).float() for k, v in p.items()}
    want = ffn_plain(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], "ReLU",
                     t["res"], 1.0).double().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nt,D", [(1, 72), (2, 72), (4, 264)])
def test_emulated_backward_tiles_give_the_autograd_gradients(nt, D):
    """The row pass (D split 2 ways and 1; at D 264, 5 tiles, split into 4
    and a last tile of 8 columns) and the weight-gradient blocks give
    ffn_plain's autograd gradients exactly: dx, dW1 = dz^T x, dW2 = g_c^T
    ht, and db1 / db2 as the first tile column's blocks sum dz's staged
    tiles and g (here g_c: no rounding in the emulation)."""
    p = _problem(10 + nt, D=D)
    dx, ht, dz, gc = backward_rows_tc(p["x"], p["w1"], p["b1"], p["w2"],
                                      p["g"], 1.0, nt)
    N, D = p["x"].shape
    Fd, Do = p["w1"].shape[0], p["w2"].shape[0]
    dw = {1: np.full((Fd, D), np.nan), 2: np.full((Do, Fd), np.nan)}
    db = {1: np.full(Fd, np.nan), 2: np.full(Do, np.nan)}
    blocks, _ = wgrad_blocks(N, D, Fd, Do)
    for m, i0, j0, M1, M2 in blocks:
        A, B = (dz, p["x"]) if m == 1 else (gc, ht)
        bias = m if j0 == 0 else 0     # the first tile column sums a bias
        tile, bsum = wgrad_tc(A, B, i0, j0, bias, gc)
        r, c = min(TW, M1 - i0), min(TW, M2 - j0)
        assert np.isnan(dw[m][i0:i0 + r, j0:j0 + c]).all()
        dw[m][i0:i0 + r, j0:j0 + c] = tile[:r, :c]
        if bias:
            assert np.isnan(db[m][i0:i0 + r]).all()
            db[m][i0:i0 + r] = bsum[:r]
    t = {k: torch.from_numpy(v).float().requires_grad_(k != "g")
         for k, v in p.items()}
    out = ffn_plain(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], "ReLU")
    want = torch.autograd.grad(out, [t["x"], t["w1"], t["b1"], t["w2"],
                                     t["b2"]], t["g"])
    got = (dx, dw[1], db[1], dw[2], db[2])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.double().numpy())


def test_emulated_tiles_carry_dropout_into_the_products():
    """Rate 0.1 on both sites, forward and backward: the emulated kernels
    equal ffn_plain (float32) and its gradients within float32's summation
    error, so the masks sit at the products' elements, not beside them."""
    p = _problem(21)
    kw = dict(rate=0.1, res_rate=0.1, seed=1234, res_seed=-77)
    got = forward_tc(p["x"], p["w1"], p["b1"], p["w2"], p["b2"], p["res"],
                     0.5, 2, **kw)
    t = {k: torch.from_numpy(v).float().requires_grad_(k != "g")
         for k, v in p.items()}
    out = ffn_plain(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], "ReLU",
                    t["res"], 0.5, 0.1, 0.1, 1234, -77)
    dx, ht, dz, gc = backward_rows_tc(p["x"], p["w1"], p["b1"], p["w2"],
                                      p["g"], 0.5, 1, **kw)
    want = [out, *torch.autograd.grad(out, [t["x"], t["b1"], t["b2"]],
                                      t["g"])]
    # float32 sums of values scaled by 1 / 0.9: 1e-5 of max(1, max|ref|)
    for a, b in zip((got, dx, dz.sum(0), gc.sum(0)), want):
        b = b.detach().double().numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


# --------------------------------------- (b) dropout at the fragment map

def _visits(N, Fd, Do, kind):
    """(row, column) of every element at which a kernel's grid evaluates
    Drop::keep, as its loops run: at the activation (F columns; the h
    epilogue, or the ht / dz epilogues of the lead column group) and at
    the output (Do columns; the forward's residual epilogue over all
    column groups, or the backward's g_c prologue)."""
    nt, groups = tc_geometry(kind, N, Do, Do)
    fsite, osite = [], []
    for bx in range(tiles64(N)):
        r0 = bx * TR
        for c in range(tiles64(Fd)):
            for w in range(8):
                rl, cl = frag(w)
                row, f = r0 + rl, c * TW + cl
                ok = (row < N) & (f < Fd)
                fsite.append(np.stack([row[ok], f[ok]], 1))
        if kind == "backward":
            hp = pad64(Do) // 2
            e = np.arange(TR * hp)
            row, col = r0 + e // hp, 2 * (e - (e // hp) * hp)
            ok = (row < N) & (col < Do)
            for k in range(2):
                osite.append(np.stack([row[ok], col[ok] + k], 1))
            continue
        for by in range(groups):
            o0 = by * nt * TW
            for t in range(min(nt, tiles64(Do - o0))):
                for w in range(8):
                    rl, cl = frag(w)
                    row, col = r0 + rl, o0 + t * TW + cl
                    ok = (row < N) & (col < Do)
                    osite.append(np.stack([row[ok], col[ok]], 1))
    return np.concatenate(fsite), np.concatenate(osite)


@pytest.mark.parametrize("N", [256, 496, 2985, 3184])
@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_fragment_map_reproduces_the_dropout_mask(kind, N):
    """Rate 0.1 at the decode step, the decoders' rows, a ragged N and the
    encoders' N = 3184 (pick = 16, so streams change every 16 rows, inside
    a 64-row tile), with a ragged F = 1032: Drop::keep at each visited
    element rebuilds ffn_mask exactly, for the activation (F columns) and
    the output (256 columns), each element once."""
    Fd, Do, seed, rate = 1032, 256, 99, 0.1
    pick = drop.pick_rows(N)
    if N == 3184:
        assert pick == 16
    fsite, osite = _visits(N, Fd, Do, kind)
    for rc, C in ((fsite, Fd), (osite, Do)):
        count = np.zeros((N, C), np.int64)
        np.add.at(count, (rc[:, 0], rc[:, 1]), 1)
        assert (count == 1).all()
        got = np.zeros((N, C))
        got[rc[:, 0], rc[:, 1]] = keep(rc[:, 0], rc[:, 1], C, rate, seed,
                                       pick)
        want = drop.ffn_mask(N, C, rate, seed).double().numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------ (c) the weight-gradient tiles and rows

@pytest.mark.parametrize("N,D,Fd,Do", [(3184, 256, 1024, 256),
                                       (496, 512, 2048, 512),
                                       (2985, 72, 136, 200)])
def test_weight_gradient_tiles_cover_each_element_once(N, D, Fd, Do):
    """One launch covers every element of dW1 (F x D) and dW2 (Do x F)
    exactly once, each block summing the rows in 64-row stages in one
    fixed order that visits every row once (rows past N are zeros). At
    the paths' widths the tiles alone fill the card (128 blocks at D 256,
    512 at D 512), so N is not split and no partials are summed."""
    blocks, stages = wgrad_blocks(N, D, Fd, Do)
    cover = {1: np.zeros((Fd, D), np.int64), 2: np.zeros((Do, Fd), np.int64)}
    for m, i0, j0, M1, M2 in blocks:
        for w in range(4):
            for mt in range(2):
                rl, cl = frag(0)
                row = i0 + 32 * (w & 1) + 16 * mt + rl
                col = j0 + 32 * (w >> 1) + cl
                ok = (row < M1) & (col < M2)
                np.add.at(cover[m], (row[ok], col[ok]), 1)
    assert (cover[1] == 1).all() and (cover[2] == 1).all()
    rows = np.concatenate([np.arange(s, s + TW) for s in stages])
    assert (rows[:N] == np.arange(N)).all() and len(rows) - N < TW
    if (D, Fd) in ((256, 1024), (512, 2048)):
        assert len(blocks) >= 128


# -------------------------------------- (d) the reckoning of each instance

@pytest.mark.parametrize("D", RECIPE_WIDTHS)
def test_instances_fit_the_card_at_every_recipe_width(D):
    """At every recipe width (D = Do in 256..768) each instance's shared
    memory fits a block's 227 KB, at least one block fits an SM's 228 KB
    beside its 1 KB reserve, the register budget of its launch bounds fits
    the SM's 65,536 registers, and the geometry picks an instance that
    exists; the weight-gradient kernel's 3 blocks fit too."""
    for kind in ("forward", "backward"):
        smem, slots = tc_smem_bytes(kind, D, D)
        assert smem <= SMEM_LIMIT and slots in (2, 3), (kind, D, smem)
        assert SM_SMEM // (smem + 1024) >= 1
        for nt in TC_TILES:
            regs = tc_register_budget(kind, nt)
            assert regs * 256 * tc_blocks_per_sm(kind, nt) <= 65536
            assert regs >= 128 or tc_blocks_per_sm(kind, nt) == 3
        for Fd in RECIPE_F:
            for N in (256, 496, 1600, 3184, 10240):
                nt, groups = tc_geometry(kind, N, D, D)
                assert nt in TC_TILES and groups * nt * TW >= D
    smem, slots = tc_smem_bytes("wgrad")
    assert slots == 4 and 3 * (smem + 1024) <= SM_SMEM
    assert tc_register_budget("wgrad") * 128 * 3 <= 65536


def test_geometry_at_the_paths_shapes():
    """The instance the wrapper takes at each path shape (the tile sweep
    of chip_smoke.py phase 2b times every instance there): the decode step
    and the decoders split the output 4-8 ways, the encoders 2 ways."""
    want = {("forward", 256, 256): (1, 4), ("forward", 3184, 256): (2, 2),
            ("forward", 3184, 512): (4, 2), ("forward", 496, 512): (1, 8),
            ("forward", 10240, 384): (4, 2), ("forward", 1600, 384): (2, 3),
            ("backward", 3184, 256): (2, 2), ("backward", 496, 256): (1, 4),
            ("backward", 3184, 512): (4, 2), ("backward", 496, 512): (1, 8)}
    for (kind, N, D), geo in want.items():
        assert tc_geometry(kind, N, D, D) == geo, (kind, N, D)


# --------------------------------- (e) the widths the wrapper takes

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its CUDA branch up to the first launch (which needs nvcc)."""

    @property
    def is_cuda(self):
        return True


def _on_card(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(_OnCard,
                                       torch.zeros(*shape, dtype=dtype))


class _Launched(Exception):
    pass


def _no_launch(*args):
    raise _Launched


def test_wrappers_take_exactly_the_built_widths(monkeypatch):
    """The bf16 CUDA branch of cuda_ffn and ffn_backward accepts D, F and
    Do exactly when each is a positive multiple of 8 whose staged tiles
    fit the shared memory, and raises a ValueError naming the width
    otherwise, before anything is built. The CPU branch (the plain
    version) takes any width."""
    monkeypatch.setattr(cuda_ffn.KERNEL, "launch", _no_launch)
    monkeypatch.setattr(cuda_ffn, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(cuda_ffn, "_sm_count", lambda dev: 132)
    for D in range(1, 1601, 1):
        ok = D % 8 == 0 and tc_smem_bytes("forward", D)[0] <= SMEM_LIMIT
        if ok:
            check_tc_widths("t", D, 64, 64, backward=False)
        else:
            with pytest.raises(ValueError, match=f"D={D}"):
                check_tc_widths("t", D, 64, 64, backward=False)
    assert tc_smem_bytes("forward", 1536)[0] <= SMEM_LIMIT
    assert tc_smem_bytes("forward", 1544)[0] > SMEM_LIMIT
    for D, Do in ((768, 768), (1024, 512), (1024, 576)):
        fits = tc_smem_bytes("backward", D, Do)[0] <= SMEM_LIMIT
        assert fits == (pad64(D) + pad64(Do) <= 1536)
    N = 5
    for D, Fd, Do, good in ((64, 136, 200, True), (72, 8, 8, True),
                            (20, 64, 64, False), (64, 60, 64, False),
                            (64, 64, 12, False), (768, 3072, 768, True),
                            (1600, 64, 64, False)):
        x, w1, w2 = _on_card(N, D), _on_card(Fd, D), _on_card(Do, Fd)
        b1 = _on_card(Fd, dtype=torch.float32)
        b2 = _on_card(Do, dtype=torch.float32)
        g = _on_card(N, Do)
        calls = (lambda: cuda_ffn.cuda_ffn(x, w1, b1, w2, b2),  # noqa: E731
                 lambda: cuda_ffn.ffn_backward(  # noqa: E731
                     x, w1, b1, w2, g, "GELU", 1.0, 0.1, 0.0, 1, 2))
        for call in calls:
            if good:
                with pytest.raises(_Launched):
                    call()
            else:
                with pytest.raises(ValueError, match="width"):
                    call()
        plain = [t.as_subclass(torch.Tensor) for t in (x, w1, b1, w2, b2)]
        assert cuda_ffn.cuda_ffn(*plain).shape == (N, Do)


def test_wrappers_raise_on_a_misaligned_pointer(monkeypatch):
    """A bf16 operand whose data does not start on a 16-byte boundary (a
    view into a larger tensor) is refused, naming the pointer; an aligned
    view is taken."""
    monkeypatch.setattr(cuda_ffn.KERNEL, "launch", _no_launch)
    monkeypatch.setattr(cuda_ffn, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(cuda_ffn, "_sm_count", lambda dev: 132)
    N, D, Fd = 4, 64, 128
    flat = _on_card(N * D + 8)
    w1, w2 = _on_card(Fd, D), _on_card(D, Fd)
    b1 = _on_card(Fd, dtype=torch.float32)
    b2 = _on_card(D, dtype=torch.float32)
    assert flat.data_ptr() % 16 == 0
    for off, bad in ((1, True), (8, False)):
        x = flat[off:off + N * D].view(N, D)
        assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bad
        if bad:
            with pytest.raises(ValueError, match="pointer x "):
                cuda_ffn.cuda_ffn(x, w1, b1, w2, b2)
            with pytest.raises(ValueError, match="pointer residual "):
                cuda_ffn.cuda_ffn(flat[8:8 + N * D].view(N, D), w1, b1, w2,
                                  b2, residual=x)
        else:
            with pytest.raises(_Launched):
                cuda_ffn.cuda_ffn(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="pointer g "):
        check_aligned("t", x=flat[:8], g=flat[3:11])
