"""Fragment maps, rings and launch geometry of the bf16 fused prenet core
(``speechain_tpu_torch/csrc/prenet.cu``: ``prenet_fwd_tc``,
``prenet_bwd_dy_tc``, ``prenet_bwd_dw2_tc``), checked on the CPU.

No card is needed. The kernels' index arithmetic is emulated with numpy,
copied from the source's formulas: conv1 on the tensor cores (the 16-lane
patch fragment, w1's fragment, one product from zero); the forward's four
stride-phase planes of h and each tap's shifted rows, read by ``ldmatrix``
with an address per lane; the three-stage ``cp.async`` rings of w2 and du
tiles, each slot holding the step that reads it; ``ldmatrix(.trans)`` and
``mma.sync`` fragments, and ``movmatrix``'s transposes that turn the patch
and the rounded dy tile into the operands of A += patch^T dy; the dy
pass's items (one stride phase each) and its step walk across items; the
dw2 pass's split of the output positions and its partial sums.

- The emulated forward, dy and dw2 passes, in float64 without roundings,
  give ``prenet_core_plain``'s output and its autograd's gradients (dw1 =
  A g1, dg1 = sum dy z, db1 = sum dy, dw2) at (3, 37, 21) with C 128 (the
  reference test's shape), (2, 101, 80) with C 256 and C 384 (the path's
  mel width; C 384 has a half channel tile), and F2 63 (C 128), within
  1e-5 of each reference's largest magnitude.
- Each output element and each dw2 element is written once, and every
  real conv1 position counts once in A for each channel tile.
- The shared-memory reckoning (``tc_smem_bytes``) is the emulation's
  buffers' and stays under the card's limit at every F2 the kernels take
  (1-64) and every gate-admitted C up to 512; the grids (``tc_grids``)
  fit one wave of one block an SM where they split, at the card's own
  count of streaming multiprocessors.
- The forward's mel rows are staged behind a barrier before conv1 reads
  them (a fact of the source that a lock-step emulation cannot see).
- The wrapper's copies of the source's tile constants equal the
  source's own (the smoke run holds the built kernels' shared memory and
  grids equal to the wrapper's reckoning on the card).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from speechain_tpu_torch.ops import cuda_prenet
from speechain_tpu_torch.ops.cuda_build import CSRC, SMEM_LIMIT
from speechain_tpu_torch.ops.cuda_prenet import (CKF, DS, HSF, HSW, KP, KQ,
                                                 MW, NB, NQ, NSUM, S2_MAX,
                                                 SMS,
                                                 STAGES, TILE, TM, TQ, WSF,
                                                 backward_splits, dy_tiles,
                                                 fwd_rows, geom,
                                                 prenet_core_plain,
                                                 tc_grids, tc_smem_bytes)

LANE = np.arange(32)
GQ, Q = LANE // 4, 2 * (LANE % 4)
E2 = np.arange(2)
WARP = np.arange(8)[:, None]                  # (8, 1) against LANE (32,)
SLOPE = 0.01                                  # LeakyReLU


def act(y):
    return np.where(y >= 0, y, SLOPE * y)


def act_grad(y):
    return np.where(y >= 0, 1.0, SLOPE)


# ------------------------------------ ldmatrix, mma.sync and movmatrix

def ldsm(S, rows, cols, trans=False, conflict_free=True):
    """ldmatrix.x4 for every warp at once: rows / cols (..., 32), lane l
    giving the address of row l % 8 of matrix l / 8 (S[row, col .. + 8),
    16-byte aligned); returns r (..., 32, 4, 2), the value pairs of each
    lane's 4 registers. conflict_free: each 8-lane phase reads 8 distinct
    16-byte bank groups. Nothing unwritten (NaN) may be read."""
    ld = S.shape[1]
    assert (cols % 8 == 0).all() and (ld * 2) % 16 == 0
    if conflict_free:
        units = ((rows * ld + cols) * 2 // 16) % 8
        ph = units.reshape(*units.shape[:-1], 4, 8)
        assert (np.sort(ph, -1) == np.arange(8)).all(), "bank conflict"
    M = S[rows[..., None], cols[..., None] + np.arange(8)]
    M = M.reshape(*rows.shape[:-1], 4, 8, 8)
    if trans:
        r = M[..., Q[:, None] + E2, GQ[:, None]]       # (..., 4, 32, 2)
    else:
        r = M[..., GQ[:, None], Q[:, None] + E2]
    assert not np.isnan(r).any(), "ldmatrix read an unwritten element"
    return np.moveaxis(r, -3, -2)


def a_tile(a):
    """The 16 x 16 A operand of mma.sync from its fragments a (..., 32, 4,
    2): a0 = A[g][q..], a1 = A[g + 8][q..], a2 = A[g][q + 8..], a3 = A[g +
    8][q + 8..]."""
    A = np.zeros((*a.shape[:-3], 16, 16))
    for k, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        A[..., GQ[:, None] + dr, Q[:, None] + dc + E2] = a[..., k, :]
    return A


def b_tile(b0, b1):
    """The 16 x 8 B operand from b0 = B[q..][g], b1 = B[q + 8..][g], each
    (..., 32, 2)."""
    Bm = np.zeros((*b0.shape[:-2], 16, 8))
    Bm[..., Q[:, None] + E2, GQ[:, None]] = b0
    Bm[..., Q[:, None] + 8 + E2, GQ[:, None]] = b1
    return Bm


def lanes(D):
    """A 16 x 8 accumulator (..., 16, 8) as each lane's 4 elements (...,
    32, 4): (g, q), (g, q + 1), (g + 8, q), (g + 8, q + 1)."""
    return np.stack([D[..., GQ, Q], D[..., GQ, Q + 1], D[..., GQ + 8, Q],
                     D[..., GQ + 8, Q + 1]], axis=-1)


def movmatrix(v):
    """movmatrix.m8n8.trans: v (..., 32, 2), lane l holding M[l / 4][2 (l
    % 4) ..]; returns the same lanes' pairs of M^T."""
    M = np.zeros((*v.shape[:-2], 8, 8))
    M[..., GQ[:, None], Q[:, None] + E2] = v
    return M[..., Q[:, None] + E2, GQ[:, None]]


# ------------------------------------------------- conv1 on tensor cores

def patch_frag(mel_flat, lo, hi, rs):
    """patch_frag: the A fragment (..., 32, 4, 2) of 16 patch rows from
    the per-lane offsets lo (row g) and hi (row g + 8) into mel_flat (-1:
    a zero row); k = 3 a + c reads mel[a rs + c], k = 8 the last tap, k >
    8 zero."""
    q = Q
    o0 = (q // 3) * rs + q % 3
    o1 = ((q + 1) // 3) * rs + (q + 1) % 3
    a = np.zeros((*lo.shape, 4, 2))
    for i, base in ((0, lo), (1, hi)):
        ok = base >= 0
        b = np.where(ok, base, 0)
        a[..., i, 0] = np.where(ok, mel_flat[b + o0], 0.0)
        a[..., i, 1] = np.where(ok, mel_flat[b + o1], 0.0)
        a[..., 2 + i, 0] = np.where(ok & (q == 0), mel_flat[b + 2 * rs + 2],
                                    0.0)
    return a


def w1_frag(w1, c):
    """w1_frag for output column c (..., 32): b0 = (w1[q][c], w1[q + 1][c]),
    b1 = (w1[8][c] if q == 0, 0)."""
    b0 = np.stack([w1[Q, c], w1[Q + 1, c]], -1)
    b1 = np.stack([np.where(Q == 0, w1[8, c], 0.0), np.zeros(c.shape)], -1)
    return b0, b1


def conv1_z_tc(pa, b0, b1):
    """conv1_z_tc: one product from zero; (..., 32, 4) lane values."""
    return lanes(a_tile(pa) @ b_tile(b0, b1))


class Ring:
    """A STAGES-deep cp.async ring: load(step) stages into slot step %
    STAGES; the step that reads a slot must find its own tile there."""

    def __init__(self, shape):
        self.slots = [(None, np.full(shape, np.nan)) for _ in range(STAGES)]

    def load(self, step, tile):
        self.slots[step % STAGES] = (step, tile)

    def read(self, step):
        tag, tile = self.slots[step % STAGES]
        assert tag == step, "a ring slot was overwritten before its read"
        return tile


# --------------------------------------------------------- the forward

def forward_block(mel, w1, g1, b1, w2, out, bx, by, bz):
    """prenet_fwd_tc block (row tile bx, channel tile by, utterance bz)."""
    Bq, Tm, F = mel.shape
    C = w1.shape[1]
    _, _, T2, F2 = geom(Tm, F)
    RT, Vp = fwd_rows(F2), F2 + 1
    PL = (RT + 1) * Vp
    NPR = -(-4 * PL // 16) * 16
    t2_0, cb = bx * RT, by * NB
    ncols = min(NB, C - cb)
    wm, wn = WARP >> 2, WARP & 3
    active = (64 * wn < ncols)[:, 0]
    mel_rows = min(4 * RT + 3, Tm - 4 * t2_0)
    mel_s = np.zeros((4 * RT + 3) * F)
    mel_s[:mel_rows * F] = mel[bz, 4 * t2_0:4 * t2_0 + mel_rows].ravel()
    abase = np.zeros((8, 4, 32), int)
    for mt in range(4):
        r = 64 * wm + 16 * mt + (LANE & 7) + 8 * ((LANE >> 3) & 1)
        lt, f2 = r // F2, r % F2
        abase[:, mt] = np.where((r < RT * F2) & (t2_0 + lt < T2),
                                lt * Vp + f2, 0)
    h_s = np.full((NPR, HSF), np.nan)
    ring = Ring((CKF, WSF))
    nsteps = C // CKF * 9

    def load(s):
        cc, t = divmod(s, 9)
        tile = np.full((CKF, WSF), np.nan)
        for k in range(CKF):
            for c in range(0, ncols, 8):
                tile[k, c:c + 8] = w2[t, cc * CKF + k, cb + c:cb + c + 8]
        ring.load(s, tile)

    load(0)
    if nsteps > 1:
        load(1)
    acc = np.zeros((8, 4, 8, 16, 8))
    for s in range(nsteps):
        cc, t = divmod(s, 9)
        if t == 0:                      # h for the chunk, all m-tiles
            ci0 = cc * CKF
            mts = np.arange(NPR // 16)[:, None]
            offs = []
            for hr in range(2):
                R = 16 * mts + GQ + 8 * hr
                pl, rem = R // PL, R % PL
                u, v = rem // Vp, rem % Vp
                t1, f1 = 2 * u + (pl >> 1), 2 * v + (pl & 1)
                ok = (R < 4 * PL) & (t1 <= 2 * RT) & (f1 <= 2 * F2)
                offs.append((np.where(ok, 2 * t1 * F + 2 * f1, -1), ok))
            pa = patch_frag(mel_s, offs[0][0], offs[1][0], F)
            for n in range(CKF // 8):
                b0, b1_ = w1_frag(w1, ci0 + 8 * n + GQ)
                z = conv1_z_tc(pa, b0, b1_)
                c = ci0 + 8 * n + Q
                for hr in range(2):
                    for e in range(2):
                        h = act(z[..., 2 * hr + e] * g1[c + e] + b1[c + e])
                        h = np.where(offs[hr][1], h, 0.0)
                        h_s[16 * mts + GQ + 8 * hr, 8 * n + Q + e] = h
        wt = ring.read(s)               # after the barrier
        if s + 2 < nsteps:
            load(s + 2)
        dt, df = divmod(t, 3)
        shift = (2 * (dt & 1) + (df & 1)) * PL + (dt >> 1) * Vp + (df >> 1)
        for ks in range(CKF // 16):
            a = ldsm(h_s, abase + shift,
                     np.broadcast_to(16 * ks + 8 * (LANE >> 4), (8, 4, 32)),
                     conflict_free=False)
            A = a_tile(a)                                    # (8, 4, 16, 16)
            act_w = np.flatnonzero(active)
            rows = np.broadcast_to(
                16 * ks + (LANE & 7) + 8 * ((LANE >> 3) & 1), (len(act_w), 32))
            for np_ in range(4):
                cols = 64 * wn[act_w] + 16 * np_ + 8 * (LANE >> 4)
                bq = ldsm(wt, rows, cols, trans=True)
                for j in range(2):
                    Bm = b_tile(bq[:, :, 2 * j], bq[:, :, 2 * j + 1])
                    acc[act_w, :, 2 * np_ + j] += A[act_w] @ Bm[:, None]
    for w in np.flatnonzero(active):
        for mt in range(4):
            L = lanes(acc[w, mt])                            # (8, 32, 4)
            for hr in range(2):
                r = 64 * (w >> 2) + 16 * mt + GQ + 8 * hr
                lt, f2 = r // F2, r % F2
                ok = (r < RT * F2) & (t2_0 + lt < T2)
                for nt in range(8):
                    for e in range(2):
                        col = cb + 64 * (w & 3) + 8 * nt + Q + e
                        sel = (bz, t2_0 + lt[ok], f2[ok], col[ok])
                        assert np.isnan(out[sel]).all()      # once
                        out[sel] = L[nt, ok, 2 * hr + e]


def forward_tc(mel, w1, g1, b1, w2):
    """The bf16 forward's launch over its grid (tc_grids["fwd"])."""
    Bq, Tm, F = mel.shape
    C = w1.shape[1]
    _, _, T2, F2 = geom(Tm, F)
    out = np.full((Bq, T2, F2, C), np.nan)
    gx, gy, gz = tc_grids(Bq, Tm, F, C)["fwd"]
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                forward_block(mel, w1, g1, b1, w2, out, bx, by, bz)
    return out


# ------------------------------------------------------- the dy pass

class DyWalk:
    """The dy pass's items and step walk (dy_item, dy_next_item,
    dy_advance): items (utterance, tile, phase), phase fastest; a step is
    (item, tap j, du column chunk kc)."""

    def __init__(self, U1, F1, C, tiles, hi):
        self.U1, self.F1, self.tiles, self.hi = U1, F1, tiles, hi
        self.nkc = C // KQ

    def item(self, item):
        p, tile = item % 4, (item // 4) % self.tiles
        pt, pf = p >> 1, p & 1
        Vq = (self.F1 - pf + 1) // 2
        return dict(b=item // (4 * self.tiles), pt=pt, pf=pf, Vq=Vq,
                    nq=(self.U1 - pt + 1) // 2 * Vq, q0=tile * TQ)

    @staticmethod
    def taps(p):
        return (1 if p & 2 else 2) * (1 if p & 1 else 2)

    def next_item(self, item):
        while item < self.hi and self.item(item)["q0"] >= \
                self.item(item)["nq"]:
            item += 1
        return item

    def advance(self, st):
        item, j, kc = st
        kc += 1
        if kc < self.nkc:
            return [item, j, kc]
        j += 1
        if j < self.taps(item % 4):
            return [item, j, 0]
        return [self.next_item(item + 1), 0, 0]


def dy_block(mel, w1, g1, b1, w2, du, part, visits, s, by, S):
    """prenet_bwd_dy_tc block (split s of S, input channel tile by)."""
    Bq, Tm, F = mel.shape
    C = w1.shape[1]
    U1, F1, T2, F2 = geom(Tm, F)
    tiles = dy_tiles(U1, F1)
    n_items = Bq * tiles * 4
    lo, hi = n_items * s // S, n_items * (s + 1) // S
    walk = DyWalk(U1, F1, C, tiles, hi)
    ci0 = by * NQ
    wm, wn = WARP & 3, WARP >> 2
    mel_flat = mel.ravel()
    ring = Ring((TQ + NQ, DS))

    def load(st, step):
        item, j, kc = st
        it = walk.item(item)
        nf = 1 if it["pf"] else 2
        dt, df = it["pt"] + 2 * (j // nf), it["pf"] + 2 * (j % nf)
        sht, shf = (dt - it["pt"]) // 2, (df - it["pf"]) // 2
        tile = np.full((TQ + NQ, DS), np.nan)
        qq = it["q0"] + np.arange(TQ)
        u, v = qq // it["Vq"], qq % it["Vq"]
        t2, f2 = u - sht, v - shf
        ok = (qq < it["nq"]) & (t2 >= 0) & (t2 < T2) & (f2 >= 0) & (f2 < F2)
        rows = du[it["b"], np.clip(t2, 0, T2 - 1), np.clip(f2, 0, F2 - 1),
                  kc * KQ:(kc + 1) * KQ]
        tile[:TQ, :KQ] = np.where(ok[:, None], rows, 0.0)
        tile[TQ:, :KQ] = w2[3 * dt + df, ci0:ci0 + NQ, kc * KQ:(kc + 1) * KQ]
        ring.load(step, tile)

    ld = [walk.next_item(lo), 0, 0]
    cu = list(ld)
    for pre in range(2):
        if ld[0] < hi:
            load(ld, pre)
            ld = walk.advance(ld)
    dh = np.zeros((8, 2, 8, 16, 8))
    accA = np.zeros((8, 8, 16, 8))
    asdy, asdyz = np.zeros((8, 32, 8, 2)), np.zeros((8, 32, 8, 2))
    n = 0
    while cu[0] < hi:
        tile = ring.read(n)
        if ld[0] < hi:
            load(ld, n + 2)
            ld = walk.advance(ld)
        dd, dw = tile[:TQ], tile[TQ:]
        for ks in range(KQ // 16):
            rows = 32 * wm[:, :, None] + 16 * np.arange(2)[:, None] + \
                (LANE & 7) + 8 * ((LANE >> 3) & 1)              # (8, 2, 32)
            cols = np.broadcast_to(16 * ks + 8 * (LANE >> 4), rows.shape)
            A = a_tile(ldsm(dd, rows, cols))                    # (8, 2, ..)
            for np_ in range(4):
                rows_b = 64 * wn + 16 * np_ + (LANE & 7) + 8 * (LANE >> 4)
                cols_b = np.broadcast_to(16 * ks + 8 * ((LANE >> 3) & 1),
                                         rows_b.shape)
                bq = ldsm(dw, rows_b, cols_b)
                for j in range(2):
                    Bm = b_tile(bq[:, :, 2 * j], bq[:, :, 2 * j + 1])
                    dh[:, :, 2 * np_ + j] += A @ Bm[:, None]
        if cu[2] == walk.nkc - 1 and cu[1] == walk.taps(cu[0] % 4) - 1:
            it = walk.item(cu[0])
            for mt in range(2):
                offs, oks = [], []
                for hr in range(2):
                    qq = it["q0"] + 32 * wm + 16 * mt + GQ + 8 * hr
                    u, v = qq // it["Vq"], qq % it["Vq"]
                    t1, f1 = 2 * u + it["pt"], 2 * v + it["pf"]
                    ok = qq < it["nq"]
                    offs.append(np.where(
                        ok, (it["b"] * Tm + 2 * t1) * F + 2 * f1, -1))
                    oks.append(ok)
                    first = ok & (Q == 0)           # one lane a row
                    for w in range(8):
                        sel = first[w]
                        np.add.at(visits[by, w >> 2],
                                  (it["b"], t1[w][sel], f1[w][sel]), 1)
                pa = patch_frag(mel_flat, offs[0], offs[1], F)
                pT = np.stack([movmatrix(pa[..., k, :]) for k in
                               (0, 2, 1, 3)], axis=-2)
                A = a_tile(pT)
                dhl = lanes(dh[:, mt])                     # (8, 8, 32, 4)
                for nt in range(8):
                    b0, b1_ = w1_frag(w1, ci0 + 64 * wn + 8 * nt + GQ)
                    z = conv1_z_tc(pa, b0, b1_)
                    c = ci0 + 64 * wn + 8 * nt + Q
                    dy = np.zeros((8, 32, 4))
                    for e in range(4):
                        cc = c + (e & 1)
                        y = z[..., e] * g1[cc] + b1[cc]
                        dy[..., e] = np.where(oks[e >> 1], act_grad(y) *
                                              dhl[:, nt, :, e], 0.0)
                        asdy[:, :, nt, e & 1] += dy[..., e]
                        asdyz[:, :, nt, e & 1] += dy[..., e] * z[..., e]
                    Bm = b_tile(movmatrix(dy[..., 0:2]),
                                movmatrix(dy[..., 2:4]))
                    accA[:, nt] += A @ Bm
                dh[:, mt] = 0.0
        cu = walk.advance(cu)
        n += 1
    # the lanes of a column (lane % 4), then the 4 row warps, in order
    sdy = asdy.reshape(8, 8, 4, 8, 2).sum(1)              # (8, 4, 8, 2)
    sdyz = asdyz.reshape(8, 8, 4, 8, 2).sum(1)
    red = np.full((4, NSUM, NQ), np.nan)
    for w in range(8):
        for nt in range(8):
            L = lanes(accA[w, nt])                          # (32, 4)
            for e in range(2):
                c = 64 * (w >> 2) + 8 * nt + Q + e
                red[w & 3, GQ, c] = L[:, e]
                first = GQ == 0
                red[w & 3, 8, c[first]] = L[first, 2 + e]
                red[w & 3, 9, c[first]] = sdy[w, :, nt, e]
                red[w & 3, 10, c[first]] = sdyz[w, :, nt, e]
    assert not np.isnan(red).any()
    assert np.isnan(part[s, :, ci0:ci0 + NQ]).all()
    acc = red[0].copy()
    for w in range(1, 4):
        acc = acc + red[w]
    part[s, :, ci0:ci0 + NQ] = acc


# ------------------------------------------------------ the dw2 pass

def dw2_block(mel, w1, g1, b1, du, part, s, by, t, S):
    """prenet_bwd_dw2_tc block (split s of S, channel tiles by, tap t)."""
    Bq, Tm, F = mel.shape
    C = w1.shape[1]
    _, _, T2, F2 = geom(Tm, F)
    nci = C // MW
    dt, df = divmod(t, 3)
    ci0, cb = (by % nci) * MW, (by // nci) * NB
    ncols = min(NB, C - cb)
    wm, wn = WARP >> 2, WARP & 3
    hm, hn = WARP & 3, WARP >> 2
    act_w = np.flatnonzero((64 * wn < ncols)[:, 0])
    per_b = T2 * F2
    n = Bq * per_b
    lo, hi = n * s // S, n * (s + 1) // S
    nsteps = -(-(hi - lo) // KP)
    du_flat = du.reshape(-1, C)
    mel_flat = mel.ravel()
    ring = Ring((KP, WSF))

    def load(j):
        tile = np.full((KP, WSF), np.nan)
        p = lo + j * KP + np.arange(KP)
        rows = du_flat[np.minimum(p, n - 1), cb:cb + ncols]
        tile[:, :ncols] = np.where((p < hi)[:, None], rows, 0.0)
        ring.load(j, tile)

    def h_step(j):
        """h of step j (patches, conv1_z_tc, affine, activation) into the
        buffer j & 1, which must hold a step already read (j - 2)."""
        tag, _ = hbuf[j & 1]
        assert tag is None or tag == j - 2, "h overwritten before its read"
        hb = np.full((KP, HSW), np.nan)
        offs, oks = [], []
        for hr in range(2):
            p = lo + j * KP + 16 * hm + GQ + 8 * hr              # (8, 32)
            bb, rem = p // per_b, p % per_b
            t1, f1 = 2 * (rem // F2) + dt, 2 * (rem % F2) + df
            ok = p < hi
            offs.append(np.where(ok, (bb * Tm + 2 * t1) * F + 2 * f1, -1))
            oks.append(ok)
        pa = patch_frag(mel_flat, offs[0], offs[1], F)
        for nt in range(8):
            b0, b1_ = w1_frag(w1, ci0 + 64 * hn + 8 * nt + GQ)
            z = conv1_z_tc(pa, b0, b1_)
            c = 64 * hn + 8 * nt + Q
            for hr in range(2):
                for e in range(2):
                    h = act(z[..., 2 * hr + e] * g1[ci0 + c + e]
                            + b1[ci0 + c + e])
                    hb[16 * hm + GQ + 8 * hr, c + e] = np.where(oks[hr], h,
                                                                0.0)
        hbuf[j & 1] = (j, hb)

    if nsteps > 0:
        load(0)
    if nsteps > 1:
        load(1)
    hbuf = [(None, None), (None, None)]
    acc = np.zeros((8, 4, 8, 16, 8))
    for j in range(nsteps):
        h_step(j)
        dts = ring.read(j)                  # after the barrier
        tag, hb = hbuf[j & 1]
        assert tag == j
        if j + 2 < nsteps:
            load(j + 2)
        for ks in range(KP // 16):
            rows = np.broadcast_to(16 * ks + (LANE & 7) + 8 * (LANE >> 4),
                                   (8, 4, 32))
            cols = 64 * wm[:, :, None] + 16 * np.arange(4)[:, None] + \
                8 * ((LANE >> 3) & 1)
            A = a_tile(ldsm(hb, rows, cols, trans=True))   # (8, 4, 16, 16)
            rows_b = np.broadcast_to(
                16 * ks + (LANE & 7) + 8 * ((LANE >> 3) & 1), (len(act_w), 32))
            for np_ in range(4):
                cols_b = 64 * wn[act_w] + 16 * np_ + 8 * (LANE >> 4)
                bq = ldsm(dts, rows_b, cols_b, trans=True)
                for jj in range(2):
                    Bm = b_tile(bq[:, :, 2 * jj], bq[:, :, 2 * jj + 1])
                    acc[act_w, :, 2 * np_ + jj] += A[act_w] @ Bm[:, None]
    for w in act_w:
        for mt in range(4):
            L = lanes(acc[w, mt])                               # (8, 32, 4)
            for hr in range(2):
                row = ci0 + 64 * (w >> 2) + 16 * mt + GQ + 8 * hr
                for nt in range(8):
                    for e in range(2):
                        col = cb + 64 * (w & 3) + 8 * nt + Q + e
                        assert np.isnan(part[s, t, row, col]).all()  # once
                        part[s, t, row, col] = L[nt, :, 2 * hr + e]


def backward_tc(mel, w1, g1, b1, w2, du):
    """The bf16 backward's launches over their grids: (dw2, A, sum dy, sum
    dy z) and the visits of each conv1 position per (channel tile, column
    warp)."""
    Bq, Tm, F = mel.shape
    C = w1.shape[1]
    U1, F1, _, _ = geom(Tm, F)
    grids = tc_grids(Bq, Tm, F, C)
    s1, s2 = backward_splits(Bq, Tm, F, C)
    assert grids["dy"] == (s1, C // NQ, 1)
    part1 = np.full((s1, NSUM, C), np.nan)
    visits = np.zeros((C // NQ, 2, Bq, U1, F1), int)
    for by in range(C // NQ):
        for s in range(s1):
            dy_block(mel, w1, g1, b1, w2, du, part1, visits, s, by, s1)
    assert not np.isnan(part1).any()
    gx, gy, gz = grids["dw2"]
    assert gx == s2
    part2 = np.full((s2, 9, C, C), np.nan)
    for t in range(gz):
        for by in range(gy):
            for s in range(gx):
                dw2_block(mel, w1, g1, b1, du, part2, s, by, t, s2)
    assert not np.isnan(part2).any()
    sums, dw2 = part1[0].copy(), part2[0].copy()     # prenet_sum_parts
    for s in range(1, s1):
        sums = sums + part1[s]
    for s in range(1, s2):
        dw2 = dw2 + part2[s]
    return dw2, sums[:9], sums[9], sums[10], visits


# ----------------------------------------------------------------- tests

CASES = [(3, 37, 21, 128), (2, 101, 80, 256), (2, 101, 80, 384),
         (1, 21, 255, 128)]


def _inputs(Bq, Tm, F, C, seed):
    rng = np.random.default_rng(seed)
    _, _, T2, F2 = geom(Tm, F)
    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    mel = f32(rng.standard_normal((Bq, Tm, F)))
    w1 = f32(rng.standard_normal((9, C)) / 3)
    g1 = f32(1 + 0.2 * rng.standard_normal(C))
    b1 = f32(0.1 * rng.standard_normal(C))
    w2 = f32(rng.standard_normal((9, C, C)) / np.sqrt(9 * C))
    g = f32(rng.standard_normal((Bq, T2, F2, C)))
    return mel, w1, g1, b1, w2, g


def _close(got, want, name):
    want = want.detach().double().numpy() if torch.is_tensor(want) else want
    tol = 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("Bq,Tm,F,C", CASES)
def test_emulated_forward_gives_the_plain_output(Bq, Tm, F, C):
    """The emulated prenet_fwd_tc over its grid (float64, no roundings)
    against prenet_core_plain (float32): every output element written
    once, within 1e-5 of the largest magnitude. (3, 37, 21): the
    reference test's shape; (2, 101, 80): the path's mel width, F2 19, a
    partial last row tile, C 384's half channel tile; (1, 21, 255): F2 63,
    two output rows a tile."""
    mel, w1, g1, b1, w2, _ = _inputs(Bq, Tm, F, C, seed=Tm + C)
    want = prenet_core_plain(*(torch.from_numpy(a.astype(np.float32))
                               for a in (mel, w1, g1, b1, w2)), "LeakyReLU")
    got = forward_tc(mel, w1, g1, b1, w2)
    assert not np.isnan(got).any()
    _close(got, want, "out")


@pytest.mark.parametrize("Bq,Tm,F,C", CASES)
def test_emulated_backward_gives_the_plain_gradients(Bq, Tm, F, C):
    """The emulated dy and dw2 passes over their grids (float64, no
    roundings) against autograd of prenet_core_plain (float32): dw1 = A
    g1, dg1 = sum dy z, db1 = sum dy and dw2, within 1e-5 of each
    reference's largest magnitude; every dw2 element written once by each
    split's partial; every real conv1 position in A once for each channel
    tile and column warp, positions past U1 x F1 never."""
    mel, w1, g1, b1, w2, g = _inputs(Bq, Tm, F, C, seed=Tm + C + 1)
    ts = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
          for a in (w1, g1, b1, w2)]
    out = prenet_core_plain(torch.from_numpy(mel.astype(np.float32)), *ts,
                            "LeakyReLU")
    want = torch.autograd.grad(out, ts, torch.from_numpy(
        g.astype(np.float32)))
    dw2, A, sdy, sdyz, visits = backward_tc(mel, w1, g1, b1, w2, g)
    assert (visits == 1).all()
    for name, got, w in zip(("dw1", "dg1", "db1", "dw2"),
                            (A * g1, sdyz, sdy, dw2), want):
        _close(got, w, name)


def test_movmatrix_turns_fragments_into_the_a_sums_operands():
    """A += patch^T dy from the fragments alone: the patch's A fragment
    with its 8 x 8 blocks transposed (0, 2, 1, 3) is patch^T's A fragment,
    and the transposed dy pairs of rows g and g + 8 are dy's B fragment."""
    rng = np.random.default_rng(5)
    P, Dy = rng.standard_normal((16, 16)), rng.standard_normal((16, 8))
    pa = np.zeros((32, 4, 2))
    for k, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        pa[:, k] = P[GQ[:, None] + dr, Q[:, None] + dc + E2]
    pT = np.stack([movmatrix(pa[:, k]) for k in (0, 2, 1, 3)], axis=-2)
    dl = lanes(Dy)
    got = a_tile(pT) @ b_tile(movmatrix(dl[:, 0:2]), movmatrix(dl[:, 2:4]))
    np.testing.assert_allclose(got, P.T @ Dy, rtol=1e-12)


@pytest.mark.parametrize("C", [128, 256, 384, 512])
def test_shared_memory_and_grids_at_every_admitted_shape(C):
    """At every F2 the kernels take (1-64, with F the smallest and the
    largest mel width giving it) and the path's mel (801, 80): each bf16
    kernel's shared memory (tc_smem_bytes) is the emulation's buffers' and
    under the card's limit for one block an SM; the forward tiles hold at
    least 2 output rows and all 128 positions at F2 64; the dy pass keeps
    one wave of SMS blocks; the dw2 pass takes the split count up to
    S2_MAX whose waves take the least time (one wave of 126 blocks at C
    256)."""
    for F2 in range(1, TILE + 1):
        for F in (4 * F2 + 3, 4 * F2 + 6):
            _, F1, _, f2 = geom(801, F)
            assert f2 == F2
            RT = fwd_rows(F2)
            assert 2 <= RT <= 32 and RT * F2 <= TM
            sm = tc_smem_bytes(801, F)
            h_rows = -(-4 * (RT + 1) * (F2 + 1) // 16) * 16
            assert sm["fwd"] == 2 * (STAGES * CKF * WSF + h_rows * HSF
                                     + -(-(4 * RT + 3) * F // 8) * 8)
            assert max(sm.values()) <= SMEM_LIMIT
    sm = tc_smem_bytes(801, 80)
    assert sm["dy"] == 2 * STAGES * (TQ + NQ) * DS + 40 * NQ
    assert sm["dw2"] == 2 * (STAGES * KP * WSF + 2 * KP * HSW) + 8 * MW
    # the dy pass's partial reduction reuses the ring
    assert 4 * NSUM * NQ * 4 <= 2 * STAGES * (TQ + NQ) * DS
    g = tc_grids(16, 801, 80, C)
    assert g["fwd"] == (34, -(-C // NB), 16)      # 6 rows, 114 positions
    dy_blocks = g["dy"][0] * g["dy"][1]
    per_split = g["dw2"][1] * g["dw2"][2]
    assert SMS - C // NQ < dy_blocks <= SMS
    waves = [-(-s * per_split // SMS) / s for s in range(1, S2_MAX + 1)]
    assert 1 <= g["dw2"][0] <= S2_MAX
    assert waves[g["dw2"][0] - 1] == min(waves)
    if C == 256:
        assert g["dy"] == (66, 2, 1) and g["dw2"] == (7, 2, 9)


def test_reuse_of_w2_and_du_is_what_the_design_claims():
    """At the path shape (16, 801, 80), C 256: each forward block serves
    114 output positions (a 64-row tile of 3 output rows: 57) and reads
    all of w2 once: 544 blocks x 1.18 MB = 0.64 GB from L2 in all, 1.97x
    less than 64-row tiles' 1072 blocks (the last of 34 row tiles holds 1
    row of 6); the dw2 pass stages du 9 C / MW = 18 times (36 with 64
    input channels a block); its partials are 7 x 9 C^2 float32, 16.5 MB
    (75.5 MB at 32 splits)."""
    _, _, T2, F2 = geom(801, 80)
    RT = fwd_rows(F2)
    assert RT * F2 == 2 * (64 // F2) * F2 == 114
    blocks = np.prod(tc_grids(16, 801, 80, 256)["fwd"])
    old_blocks = -(-T2 // (64 // F2)) * 16
    assert blocks == 544 and old_blocks == 1072
    assert old_blocks / blocks > 1.95
    s2 = backward_splits(16, 801, 80, 256)[1]
    assert 9 * 256 // MW == 18
    assert s2 * 9 * 256 * 256 * 4 < 19e6



@pytest.mark.parametrize("sms", [78, 114, 132])
def test_splits_follow_the_cards_sm_count(sms):
    """The bf16 backward's split counts follow the card's streaming
    multiprocessors (132 on the H100 SXM, 114 on the PCIe card): the dy
    pass keeps one wave and dw2 takes the split count whose waves take
    the least time at every gate-admitted C up to 512. With no card the
    reckoning takes SMS."""
    assert cuda_prenet.sm_count(torch.device("cpu")) == SMS
    for C in (128, 256, 384, 512):
        g = tc_grids(16, 801, 80, C, sms)
        assert backward_splits(16, 801, 80, C, sms=sms) == \
            (g["dy"][0], g["dw2"][0])
        assert sms - C // NQ < g["dy"][0] * g["dy"][1] <= sms
        per_split = g["dw2"][1] * g["dw2"][2]
        waves = [-(-s * per_split // sms) / s for s in range(1, S2_MAX + 1)]
        assert waves[g["dw2"][0] - 1] == min(waves)


def test_forward_fills_the_mel_rows_before_conv1_reads_them():
    """prenet_fwd_tc's threads each stage part of the block's mel rows,
    and conv1's patch fragments read rows that other warps wrote: an
    unconditional barrier stands between the fill and the first read.
    (The emulation runs all threads in step and cannot see it missing.)"""
    src = (CSRC / "prenet.cu").read_text()
    body = src[re.search(r"\nprenet_fwd_tc\(", src).start():]
    between = body[body.index("mel_s[i] ="):body.index("patch_frag(pa")]
    assert re.search(r"^\s*__syncthreads\(\);", between, re.M)

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
    ("TILE", "TILE"), ("CHANNELS", "CO"), ("NSUM", "NSUM"),
    ("STAGES", "STAGES"), ("TM", "TM"), ("RTMAX", "RTMAX"), ("NB", "NB"),
    ("CKF", "CKF"),
    ("HSF", "HSF"), ("WSF", "WSF"), ("TQ", "TQ"), ("NQ", "NQ"),
    ("KQ", "KQ"), ("DS", "DS"), ("MW", "MW"), ("KP", "KP"),
    ("HSW", "HSW")])
def test_wrapper_constants_are_the_sources(name, source):
    """ops/cuda_prenet.py's copy of each tile constant that sizes the
    scratch, the shared memory and the grids equals csrc/prenet.cu's."""
    assert getattr(cuda_prenet, name) == \
        source_ints(CSRC / "prenet.cu")[source]
