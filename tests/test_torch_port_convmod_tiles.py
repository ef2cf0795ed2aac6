"""Fragment maps and launch geometry of the bf16 conv-module forward and
backward (``speechain_tpu_torch/csrc/convmod.cu``: ``convmod_fwd_tc``,
``convmod_bwd_rows_tc``, ``convmod_bwd_dx_tc``, ``convmod_bwd_wgrad_tc``),
checked on the CPU.

No card is needed. The kernels' index arithmetic is emulated with numpy,
copied from the source's formulas: the rows and W1 rows the row pass
stages for its z = x W1^T + b1 product over a tile and its K - 1 halo
frames, which shared-memory rows each ``ldmatrix`` reads, which
accumulator element of which warp holds which product; the FMA-unit tail
(GLU backward, the transposed depthwise sum, the ddwk / ddwb / db1
partials); the dx tiles; and dW1's partial tiles over WG_SPLIT row ranges.

- The emulated forward (the shared z recompute, then the GLU, the
  depthwise sum and the s / ss partials) gives ``conv_glu_dw_plain``'s u,
  s and ss at T = 77 and 199 with K = 31, at K = 7 and at T = 5, each u
  element written once and the partials summed in order.
- The emulated tiles, in float64 without roundings, give
  ``conv_glu_dw_plain``'s autograd gradients (x, W1, b1, the depthwise
  kernel and bias; cotangents on u, s and ss) at T = 77 and 199 with K =
  31 (and T 5; T 64 with K 33), within 1e-5 of each reference's largest
  magnitude.
- Every dW1 element is written once by each row range's partial, the row
  ranges cover N once, and the partials are summed in a fixed order.
- The weight gradient runs at least 128 blocks at the path shape (16,
  199, 256), and the row pass's shared memory lets two blocks share an SM.
- The wrapper's copies of the source's tile constants equal the source's
  own (the smoke run holds the built layout, shared memory and grids
  equal to the wrapper's reckoning on the card).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from speechain_tpu_torch.ops import cuda_convmod
from speechain_tpu_torch.ops.cuda_build import CSRC, SMEM_LIMIT
from speechain_tpu_torch.ops.cuda_convmod import (CHANNEL_BLOCK, KC, LDK,
                                                  LDZ, MAX_K, RZP, TILE_T,
                                                  WG_SPLIT, bwd_tc_grids,
                                                  conv_glu_dw_plain,
                                                  fwd_tc_grids, part_floats,
                                                  tc_smem_bytes)

CB, TT = CHANNEL_BLOCK, TILE_T
LANE = np.arange(32)
GQ, Q = LANE // 4, 2 * (LANE % 4)
SM_SMEM = 228 * 1024            # shared memory of an SM (1 KB a block kept)


# ------------------------------------------- ldmatrix and mma.sync

def ldsm(S, rows, cols, trans=False):
    """ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8
    (S[rows[l], cols[l] .. + 8)); returns r[lane, m] (value pairs). Each
    8-lane phase must read 8 distinct 16-byte bank groups, and nothing
    unwritten (NaN)."""
    ld = S.shape[1]
    for m in range(4):
        groups = {((rows[8 * m + i] * ld + cols[8 * m + i]) * 2 // 16) % 8
                  for i in range(8)}
        assert len(groups) == 8, "ldmatrix bank conflict"
    M = S[rows[:, None], cols[:, None] + np.arange(8)].reshape(4, 8, 8)
    e = np.arange(2)
    if trans:
        r = M[:, Q[:, None] + e, GQ[:, None]]
    else:
        r = M[:, GQ[:, None], Q[:, None] + e]
    assert not np.isnan(r).any(), "ldmatrix read an unwritten element"
    return r.transpose(1, 0, 2)


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


def sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


# ------------------------------------------------- the emulated kernels

def z_tile(x, w1, b1, K, b, tile, cbk):
    """z_tile_tc for block (tile, channel block cbk, utterance b): z = x
    W1^T + b1 on the emulated tensor cores over the tile's RZ rows and
    the block's 2 CB columns; returns the (RZP, LDZ) z tile (NaN where
    unwritten) and its reader zat(r, j)."""
    B, T, C = x.shape
    RZ, P = TT + K - 1, (K - 1) // 2
    t0, c0 = tile * TT, cbk * CB
    acc = np.zeros((8, 3, 4, 32, 4))
    for j in range(C // KC):                    # the ring's chunks
        S = np.full((RZP + 2 * CB, LDK), np.nan)
        for r in range(RZP + 2 * CB):
            for ch in range(0, KC, 8):
                if r < RZP:
                    t = t0 - P + r
                    ok = r < RZ and 0 <= t < T
                    S[r, ch:ch + 8] = x[b, t, j * KC + ch:j * KC + ch + 8] \
                        if ok else 0.0
                else:
                    jj = r - RZP
                    wr = c0 + jj if jj < CB else C + c0 + jj - CB
                    S[r, ch:ch + 8] = w1[wr, j * KC + ch:j * KC + ch + 8]
        for w in range(8):
            mg, ng = w >> 2, w & 3
            pa_r = 48 * mg + (LANE & 7) + 8 * ((LANE >> 3) & 1)
            pb_r = RZP + 32 * ng + (LANE & 7) + 8 * (LANE >> 4)
            for ks in range(KC // 16):
                a = [ldsm(S, pa_r + 16 * mt, 8 * (LANE >> 4) + 16 * ks)
                     for mt in range(3)]
                for npr in range(2):
                    bq = ldsm(S, pb_r + 16 * npr,
                              8 * ((LANE >> 3) & 1) + 16 * ks)
                    for mt in range(3):
                        mma(acc[w, mt, 2 * npr], a[mt], bq[:, 0], bq[:, 1])
                        mma(acc[w, mt, 2 * npr + 1], a[mt], bq[:, 2],
                            bq[:, 3])
    zs = np.full((RZP, LDZ), np.nan)
    for w in range(8):
        mg, ng = w >> 2, w & 3
        for mt in range(3):
            for n in range(4):
                jc = 32 * ng + 8 * n + Q
                wr = np.where(jc < CB, c0 + jc, C + c0 + jc - CB)
                for hr in range(2):
                    r = 48 * mg + 16 * mt + GQ + 8 * hr
                    assert np.isnan(zs[r, jc]).all()           # once
                    zs[r, jc] = acc[w, mt, n, :, 2 * hr] + b1[wr]
                    zs[r, jc + 1] = acc[w, mt, n, :, 2 * hr + 1] + b1[wr + 1]
    assert not np.isnan(zs[:, :2 * CB]).any()

    def zat(r, jj):
        v = zs[r, jj]
        assert not np.isnan(v).any()
        return v
    return zs, zat


def rows_tc(x, w1, b1, dk_all, u, du, ds, dss, dz, part, b, tile, cbk):
    """convmod_bwd_rows_tc block (tile, channel block cbk, utterance b): z
    on the emulated tensor cores (z_tile), then bwd_rows_tail; writes dz's
    rows and the block's partial row [db1 | ddwk | ddwb]."""
    B, T, C = x.shape
    K = dk_all.shape[1]
    RZ, P = TT + K - 1, (K - 1) // 2
    Qh = K - 1 - P
    t0, c0 = tile * TT, cbk * CB
    _, zat = z_tile(x, w1, b1, K, b, tile, cbk)

    # bwd_rows_tail: a and du_tot over the halo rows
    r = np.arange(RZ)[:, None]
    c = np.arange(CB)[None, :]
    t = t0 - P + r
    okt = (t >= 0) & (t < T)
    a_s = np.where(okt, zat(r, c) * sigmoid(zat(r, CB + c)), 0.0)
    t2 = t0 - Qh + r
    ok2 = (t2 >= 0) & (t2 < T)
    t2c = np.clip(t2, 0, T - 1)
    g_s = np.where(ok2, du[b, t2c, c0 + c] + ds[c0 + c]
                   + 2.0 * u[b, t2c, c0 + c] * dss[c0 + c], 0.0)
    dk = dk_all[c0:c0 + CB].T                               # [K][CB]
    nt = min(TT, T - t0)
    sa, sg = np.zeros(CB), np.zeros(CB)
    for tt in range(nt):
        da = sum(dk[kk] * g_s[tt + K - 1 - kk] for kk in range(K))
        ag = zat(tt + P, np.arange(CB))
        gate = sigmoid(zat(tt + P, CB + np.arange(CB)))
        dag, dgate = da * gate, da * ag * gate * (1.0 - gate)
        row = b * T + t0 + tt
        assert np.isnan(dz[row, c0:c0 + CB]).all()
        dz[row, c0:c0 + CB] = dag
        dz[row, C + c0:C + c0 + CB] = dgate
        sa += dag
        sg += dgate
    prow = part[b * -(-T // TT) + tile]
    prow[c0:c0 + CB] = sa
    prow[C + c0:C + c0 + CB] = sg
    for kk in range(K):
        prow[2 * C + (c0 + np.arange(CB)) * K + kk] = (
            a_s[kk:kk + nt] * g_s[Qh:Qh + nt]).sum(0)
    prow[2 * C + C * K + c0:2 * C + C * K + c0 + CB] = g_s[Qh:Qh + nt].sum(0)


def fwd_tc(x, w1, b1, dk_all, dwb, u, part, visits, b, tile, cbk):
    """convmod_fwd_tc block (tile, channel block cbk, utterance b): z on
    the emulated tensor cores (z_tile), a = GLU(z) zero outside [0, T),
    then fwd_tail: thread (channel c, group g) sums the 'SAME' depthwise
    taps of frames t0 + 16 g .. + 16 in order, writes u (float64 here,
    no rounding) and adds its s / ss; group 0 adds the 4 groups' sums in
    order into the block's partial row b * tiles + tile of part (.., 2,
    C)."""
    B, T, C = x.shape
    K = dk_all.shape[1]
    RZ, P = TT + K - 1, (K - 1) // 2
    t0, c0 = tile * TT, cbk * CB
    zs, zat = z_tile(x, w1, b1, K, b, tile, cbk)
    r = np.arange(RZ)[:, None]
    c = np.arange(CB)[None, :]
    t = t0 - P + r
    a_s = np.where((t >= 0) & (t < T),
                   zat(r, c) * sigmoid(zat(r, CB + c)), 0.0)
    dk = dk_all[c0:c0 + CB].T                               # [K][CB]
    red = np.zeros((4, 2, CB))
    for g in range(4):                        # THREADS / CB groups of 16
        for m in range(16):
            tt = 16 * g + m
            if t0 + tt >= T:
                break
            o = a_s[tt] * dk[0]
            for kk in range(1, K):
                o = o + a_s[tt + kk] * dk[kk]
            uo = o + dwb[c0:c0 + CB]
            assert np.isnan(u[b, t0 + tt, c0:c0 + CB]).all()     # once
            u[b, t0 + tt, c0:c0 + CB] = uo
            visits[b, t0 + tt, c0:c0 + CB] += 1
            red[g, 0] += uo
            red[g, 1] += uo * uo
    prow = b * -(-T // TT) + tile
    for what in range(2):
        assert np.isnan(part[prow, what, c0:c0 + CB]).all()
        acc = np.zeros(CB)
        for g in range(4):
            acc = acc + red[g, what]
        part[prow, what, c0:c0 + CB] = acc


def forward_tc(x, w1, b1, dwk, dwb):
    """The bf16 forward's launches over their grids (launch_fwd_tc): (u,
    s, ss), and how often each (frame, channel) of u was written."""
    B, T, C = x.shape
    grids = fwd_tc_grids(B, T, C)
    u = np.full((B, T, C), np.nan)
    visits = np.zeros((B, T, C), int)
    part = np.full((B * -(-T // TT), 2, C), np.nan)
    gx, gy, gz = grids["fwd"]
    for bb in range(gz):
        for tile in range(gx):
            for cbk in range(gy):
                fwd_tc(x, w1, b1, dwk, dwb, u, part, visits, bb, tile, cbk)
    assert not np.isnan(part).any()
    assert grids["fwd_sums"][0] * 128 >= C
    s, ss = np.zeros(C), np.zeros(C)
    for p in range(part.shape[0]):          # stats_reduce_kernel, in order
        s = s + part[p, 0]
        ss = ss + part[p, 1]
    return u, s, ss, visits


def stage64(M, row0, col0):
    """stage64: the 64 x 64 tile at (row0, col0) of M, zeros past its rows
    (cols is a multiple of 64), into a 64 x LDK tile (NaN in the pad)."""
    S = np.full((64, LDK), np.nan)
    for e in range(64 * 8):
        r, cc = e >> 3, (e & 7) * 8
        S[r, cc:cc + 8] = M[row0 + r, col0 + cc:col0 + cc + 8] \
            if row0 + r < M.shape[0] else 0.0
    return S


def dx_tc(dz, w1, dx, bx, by):
    """convmod_bwd_dx_tc block (bx, by): dx's 64 x 64 tile (by, bx)."""
    N, C = dx.shape
    i0, j0 = by * 64, bx * 64
    acc = np.zeros((4, 2, 4, 32, 4))
    for s in range(2 * C // 64):
        At, Bt = stage64(dz, i0, 64 * s), stage64(w1, 64 * s, j0)
        for w in range(4):
            mw, nw = 32 * (w & 1), 32 * (w >> 1)
            for ks in range(4):
                a = [ldsm(At, mw + (LANE & 7) + 8 * ((LANE >> 3) & 1)
                          + 16 * mt, 8 * (LANE >> 4) + 16 * ks)
                     for mt in range(2)]
                for npr in range(2):
                    bq = ldsm(Bt, (LANE & 7) + 8 * ((LANE >> 3) & 1)
                              + 16 * ks, nw + 8 * (LANE >> 4) + 16 * npr,
                              trans=True)
                    for mt in range(2):
                        mma(acc[w, mt, 2 * npr], a[mt], bq[:, 0], bq[:, 1])
                        mma(acc[w, mt, 2 * npr + 1], a[mt], bq[:, 2],
                            bq[:, 3])
    for w in range(4):
        mw, nw = 32 * (w & 1), 32 * (w >> 1)
        for mt in range(2):
            for hr in range(2):
                row = i0 + mw + 16 * mt + GQ + 8 * hr
                for n in range(4):
                    col = j0 + nw + 8 * n + Q
                    ok = row < N
                    for e in range(2):
                        assert np.isnan(dx[row[ok], col[ok] + e]).all()
                        dx[row[ok], col[ok] + e] = acc[w, mt, n][ok, 2 * hr
                                                                 + e]


def wgrad_rows(N):
    """The 64-row steps each of WG_SPLIT partials sums: [s per, (s + 1) per)
    of ceil(N / 64), per = ceil(steps / WG_SPLIT)."""
    steps = -(-N // 64)
    per = -(-steps // WG_SPLIT)
    return [range(s * per, max(s * per, min(steps, s * per + per)))
            for s in range(WG_SPLIT)]


def wgrad_tc(dz, x2, wpart, bx, by, bz):
    """convmod_bwd_wgrad_tc block (bx, by, bz): dW1 partial bz's tile (by,
    bx), both operands read transposed."""
    N, C = x2.shape
    i0, j0 = by * 64, bx * 64
    acc = np.zeros((4, 2, 4, 32, 4))
    for st in wgrad_rows(N)[bz]:
        At, Bt = stage64(dz, 64 * st, i0), stage64(x2, 64 * st, j0)
        for w in range(4):
            mw, nw = 32 * (w & 1), 32 * (w >> 1)
            for ks in range(4):
                a = [ldsm(At, (LANE & 7) + 8 * (LANE >> 4) + 16 * ks,
                          mw + 8 * ((LANE >> 3) & 1) + 16 * mt, trans=True)
                     for mt in range(2)]
                for npr in range(2):
                    bq = ldsm(Bt, (LANE & 7) + 8 * ((LANE >> 3) & 1)
                              + 16 * ks, nw + 8 * (LANE >> 4) + 16 * npr,
                              trans=True)
                    for mt in range(2):
                        mma(acc[w, mt, 2 * npr], a[mt], bq[:, 0], bq[:, 1])
                        mma(acc[w, mt, 2 * npr + 1], a[mt], bq[:, 2],
                            bq[:, 3])
    out = wpart[bz]
    for w in range(4):
        mw, nw = 32 * (w & 1), 32 * (w >> 1)
        for mt in range(2):
            for hr in range(2):
                row = i0 + mw + 16 * mt + GQ + 8 * hr
                for n in range(4):
                    col = j0 + nw + 8 * n + Q
                    for e in range(2):
                        assert np.isnan(out[row, col + e]).all()   # once
                        out[row, col + e] = acc[w, mt, n][:, 2 * hr + e]


def backward_tc(x, w1, b1, dwk, u, du, ds, dss):
    """The bf16 backward's launches over their whole grids (launch_bwd_tc):
    (dx, dW1, db1, ddwk, ddwb)."""
    B, T, C = x.shape
    K = dwk.shape[1]
    N = B * T
    grids = bwd_tc_grids(B, T, C, K)
    W = 2 * C + C * K + C
    dz = np.full((N, 2 * C), np.nan)
    part = np.full((B * -(-T // TT), W), np.nan)
    gx, gy, gz = grids["rows"]
    for bb in range(gz):
        for tile in range(gx):
            for cbk in range(gy):
                rows_tc(x, w1, b1, dwk, u, du, ds, dss, dz, part, bb, tile,
                        cbk)
    assert not np.isnan(dz).any() and not np.isnan(part).any()
    dx = np.full((N, C), np.nan)
    gx, gy, _ = grids["dx"]
    for by in range(gy):
        for bx in range(gx):
            dx_tc(dz, w1, dx, bx, by)
    wpart = np.full((WG_SPLIT, 2 * C, C), np.nan)
    gx, gy, gz = grids["wgrad"]
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                wgrad_tc(dz, x.reshape(N, C), wpart, bx, by, bz)
    assert not np.isnan(wpart).any()
    dw1 = np.zeros((2 * C, C))
    for s in range(WG_SPLIT):                   # convmod_bwd_sums, in order
        dw1 = dw1 + wpart[s]
    sums = part.sum(0)
    return (dx.reshape(B, T, C), dw1, sums[:2 * C],
            sums[2 * C:2 * C + C * K].reshape(C, K), sums[2 * C + C * K:])


@pytest.mark.parametrize("T,K", [(77, 31), (199, 31), (5, 31), (64, 33)])
def test_emulated_tiles_give_the_plain_gradients(T, K):
    """x, W1, b1, the depthwise kernel and bias: the emulated bf16
    backward (float64, no roundings) against autograd of
    conv_glu_dw_plain (float32) with cotangents on u, s and ss, B 2, C
    128 (two channel blocks): K 31 at T 77 and 199 (the path's), at T 5
    (a halo longer than the utterance), and the largest K, 33, on one
    whole tile; within 1e-5 of each reference's largest magnitude."""
    B, C = 2, 128
    rng = np.random.default_rng(T)
    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    x = f32(rng.standard_normal((B, T, C)))
    x[1, T - min(9, T - 1):] = 0.0                   # padded frames
    w1 = f32(rng.standard_normal((2 * C, C)) / np.sqrt(C))
    b1 = f32(0.1 * rng.standard_normal(2 * C))
    dwk = f32(rng.standard_normal((C, K)) / np.sqrt(K))
    dwb = f32(0.1 * rng.standard_normal(C))
    gu = f32(rng.standard_normal((B, T, C)))
    gs, gss = f32(0.01 * rng.standard_normal(C)), f32(
        0.01 * rng.standard_normal(C))
    ts = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
          for a in (x, w1, b1, dwk, dwb)]
    u, s, ss = conv_glu_dw_plain(*ts)
    want = torch.autograd.grad(
        (u, s, ss), ts, [torch.from_numpy(a.astype(np.float32))
                         for a in (gu, gs, gss)])
    got = backward_tc(x, w1, b1, dwk, u.detach().double().numpy(), gu, gs,
                      gss)
    for name, a, w in zip(("dx", "dw1", "db1", "ddwk", "ddwb"), got, want):
        w = w.double().numpy()
        tol = 1e-5 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(a, w, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("T,K", [(77, 31), (199, 31), (77, 7), (5, 31)])
def test_emulated_forward_gives_the_plain_outputs(T, K):
    """u, s and ss of the emulated bf16 forward (z on the emulated tensor
    cores, float64 without roundings, then the FMA-unit tail) against
    conv_glu_dw_plain (float32): B 2, C 128 (two channel blocks), K 31 at
    T 77 and 199 (the path's), K 7, and T 5 (a halo longer than the
    utterance); padded frames of utterance 1 stay unmasked, as the
    reference's. Within 1e-5 of each reference's largest magnitude; each
    (frame, channel) of u written once; each partial written once and
    the partials summed in order."""
    B, C = 2, 128
    rng = np.random.default_rng(T + K)
    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    x = f32(rng.standard_normal((B, T, C)))
    x[1, T - min(9, T - 1):] = 0.0                   # padded frames
    w1 = f32(rng.standard_normal((2 * C, C)) / np.sqrt(C))
    b1 = f32(0.1 * rng.standard_normal(2 * C))
    dwk = f32(rng.standard_normal((C, K)) / np.sqrt(K))
    dwb = f32(0.1 * rng.standard_normal(C))
    want = conv_glu_dw_plain(*(torch.from_numpy(a.astype(np.float32))
                               for a in (x, w1, b1, dwk, dwb)))
    *got, visits = forward_tc(x, w1, b1, dwk, dwb)
    assert (visits == 1).all()
    for name, a, w in zip(("u", "s", "ss"), got, want):
        w = w.double().numpy()
        tol = 1e-5 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(a, w, rtol=0, atol=tol, err_msg=name)


def test_forward_geometry_and_shared_memory():
    """The bf16 forward at conformer-small (B 16, T 199, C 256): one block
    per (64 frames, 64 channels, utterance), 256 blocks, and C 512's
    (conformer-large) 512; its shared memory is the row pass's (the same
    ring, z tile, taps and sums; a alone replaces the ring), two blocks an
    SM."""
    assert fwd_tc_grids(16, 199, 256) == {"fwd": (4, 4, 16),
                                          "fwd_sums": (2, 1, 1)}
    assert fwd_tc_grids(16, 199, 512)["fwd"] == (4, 8, 16)
    sm = tc_smem_bytes()
    assert sm["fwd"] == sm["rows"] and 2 * (sm["fwd"] + 1024) <= SM_SMEM
    assert RZP * CB * 4 <= 2 * (RZP + 2 * CB) * LDK * 2


@pytest.mark.parametrize("B,T,C", [(16, 199, 256), (3, 77, 256),
                                   (2, 600, 512), (1, 5, 64)])
def test_wgrad_partials_cover_each_element_once(B, T, C):
    """dW1's WG_SPLIT partials: the row ranges cover the N rows' 64-row
    steps once, in order (empty ranges write zeros), and each partial's
    (2C, C) elements are written by exactly one (block, warp, fragment)
    element; convmod_bwd_sums adds partial 0, 1, ... in that order."""
    N = B * T
    steps = -(-N // 64)
    seen = [st for rng_ in wgrad_rows(N) for st in rng_]
    assert seen == list(range(steps))
    gx, gy, gz = bwd_tc_grids(B, T, C, 31)["wgrad"]
    assert (gx, gy, gz) == (C // 64, 2 * C // 64, WG_SPLIT)
    count = np.zeros((2 * C, C), int)
    for by in range(gy):
        for bx in range(gx):
            for w in range(4):
                mw, nw = 32 * (w & 1), 32 * (w >> 1)
                for mt in range(2):
                    for hr in range(2):
                        row = by * 64 + mw + 16 * mt + GQ + 8 * hr
                        for n in range(4):
                            col = bx * 64 + nw + 8 * n + Q
                            for e in range(2):
                                np.add.at(count, (row, col + e), 1)
    assert (count == 1).all()
    assert part_floats(B, T, C, 31, torch.bfloat16) == (
        part_floats(B, T, C, 31, torch.float32) + WG_SPLIT * 2 * C * C)


def test_geometry_fills_the_card_at_the_path_shape():
    """At conformer-small training (B 16, T 199, C 256, K 31): the weight
    gradient runs (C / 64) (2C / 64) WG_SPLIT = 256 blocks (the unsplit
    tiles alone were 32), dx 200, the row pass 256; the row pass's shared
    memory lets two blocks share an SM and stays under the card's limit,
    and its z rows cover the widest halo (K <= 33)."""
    g = bwd_tc_grids(16, 199, 256, 31)
    blocks = {k: v[0] * v[1] * v[2] for k, v in g.items()}
    assert blocks["wgrad"] >= 128 and blocks["wgrad"] == 256
    assert blocks["dx"] == 200 and blocks["rows"] == 256
    sm = tc_smem_bytes()
    assert sm["rows"] <= SMEM_LIMIT and 2 * (sm["rows"] + 1024) <= SM_SMEM
    assert 3 * (sm["dx"] + 1024) <= SM_SMEM
    assert RZP >= TT + MAX_K - 1
    # a and du_tot (RZP x CB float32 each) fit the ring they replace
    assert 2 * RZP * CB * 4 <= 2 * (RZP + 2 * CB) * LDK * 2
    assert sm["rows"] == 2 * (96 + 128) * 72 * 2 + 96 * 136 * 2 \
        + 33 * 64 * 4 + 4 * 128 * 4


def source_ints(path):
    """Every ``constexpr int`` of a source that is integer arithmetic on
    the ones before it, by name."""
    vals = {}
    for decl in re.findall(r"constexpr int ([^;]+);", path.read_text()):
        for part in decl.split(","):
            name, _, expr = (x.strip() for x in part.partition("="))
            try:
                vals[name] = int(eval(expr.replace("/", "//"),
                                      {"__builtins__": {}}, dict(vals)))
            except (NameError, SyntaxError):
                pass
    return vals


@pytest.mark.parametrize("name,source", [
    ("TILE_T", "TT"), ("CHANNEL_BLOCK", "CB"), ("MAX_K", "KMAX"),
    ("RZP", "RZP"), ("KC", "KC"), ("LDK", "LDK"), ("LDZ", "LDZ"),
    ("WG_SPLIT", "WG_SPLIT")])
def test_wrapper_constants_are_the_sources(name, source):
    """ops/cuda_convmod.py's copy of each tile constant that sizes the
    scratch, the shared memory and the grids equals csrc/convmod.cu's."""
    assert getattr(cuda_convmod, name) == \
        source_ints(CSRC / "convmod.cu")[source]
