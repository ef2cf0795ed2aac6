"""Index maps and fragment maps of the bf16 rel-pos attention backward
(``speechain_tpu_torch/csrc/relpos_attention.cu``: ``relpos_bwd_dq_tc``,
``relpos_bwd_dkdv_tc``, ``relpos_bwd_band_sums_tc``), checked on the CPU.

No card is needed. The kernels' index arithmetic is emulated with numpy,
copied from the source's formulas: which rows each block stages, which
shared-memory rows each ``ldmatrix`` reads, which accumulator element of
which warp holds which product, where the Transformer-XL shift puts each
position score (``SB[r][c - r + 15]`` in the dq pass, ``Ps[c][r]`` in the
dk/dv pass), where ``ds_c`` lands in the band layout of ``dW``, which band
rows each warp's rolling ``dph`` accumulator holds and flushes, and which
partial rows the band sums read.

- The tile-level shift and un-shift equal the JAX package's
  ``_rel_shift_band`` / ``_rel_unshift_band`` for every (query tile, key
  tile) pair at T = 77, 199 and 600 (and 1, 64, 65: one frame, one whole
  tile, one row past it).
- The emulated ``mma.sync`` tiles, in float64 without roundings, give
  ``relpos_attention_plain``'s autograd cotangents (all six) at dropout 0
  and 0.1 with an empty key row, within 1e-5 of the largest magnitude
  (float32 reference, other summation order).
- Each accumulator's (query, key), fed through ``ops/dropout.py``'s
  attention indexing, reproduces the kernel's mask, and every (query, key)
  of every (utterance, head) is visited once by each pass.
- The shared-memory reckoning stays under the card's limit for T <= 2000
  at widths 32-128 (two blocks an SM at 64).
- The wrapper's copies of the source's tile constants equal the source's
  own (the smoke run holds the built scratch and shared memory equal to
  the wrapper's reckoning on the card).
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops.pallas_attention import (_rel_shift_band,
                                                _rel_unshift_band)
from speechain_tpu_torch.ops import cuda_attention
from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_attention import (
    NEG_FILL, RELPOS_HEAD_WIDTHS, SUM_ROWS, TC_TILE, head_instance,
    relpos_attention_plain, relpos_bwd_scratch, relpos_kernel_smem,
    tc_geometry)
from speechain_tpu_torch.ops.cuda_build import CSRC, SMEM_LIMIT

LANE = np.arange(32)
GQ, Q = LANE // 4, 2 * (LANE % 4)
SM_SMEM = 228 * 1024            # shared memory of an SM (1 KB a block kept)


# ------------------------------------------- the shift at tile level (C1)

@pytest.mark.parametrize("T", [77, 199, 600, 1, 64, 65])
def test_tile_shift_and_unshift_are_the_jax_band_maps(T):
    """For every (query tile q0, key tile k0) of BT rows: the dq pass's
    per-warp map (row 16 w + r, key column c -> SB_w[r][c - r + 15],
    SB_w's column e = staged band row eb + e, eb = BT - 16 - 16 w, of the
    window mb = k0 - q0 + T - BT), the dk/dv pass's (key r, query c ->
    Ps[c][r] = P[r - c + BT - 1][c]) and the scatter of ds_c into dW (e =
    c - i + BT - 1) agree with _rel_shift_band / _rel_unshift_band on
    random input."""
    geo, BT = tc_geometry(), TC_TILE
    NBAND, SBW, LDP = geo["band"], geo["sbw"], geo["ldp"]
    rng = np.random.default_rng(T)
    L = 2 * T - 1
    W = rng.standard_normal((T, L)).astype(np.float32)
    ds = rng.standard_normal((T, T)).astype(np.float32)
    want = np.asarray(_rel_shift_band(jnp.asarray(W), T))
    want_un = np.asarray(_rel_unshift_band(jnp.asarray(ds), T, L))
    got = np.full((T, T), np.nan)
    got_t = np.full((T, T), np.nan)
    un = np.zeros((T, L))
    r16, c64 = np.arange(16)[:, None], np.arange(BT)[None, :]   # c < BT
    for q0 in range(0, T, BT):
        for k0 in range(0, T, BT):
            mb = k0 - q0 + T - BT
            band = np.arange(mb, mb + NBAND)            # staged band rows
            okb = (band >= 0) & (band < L)
            for w in range(geo["warps"]):               # dq pass, per warp
                eb = BT - 16 - 16 * w
                i = q0 + 16 * w + r16
                rows = np.minimum(i, T - 1)
                el = c64 - r16 + 15                      # SB_w's column
                assert el.min() >= 0 and el.max() < BT + 16 <= SBW
                m = band[eb + el]
                sb = np.where(okb[eb + el], W[rows, np.clip(m, 0, L - 1)],
                              0.0)
                j = k0 + c64
                ok = (i < T) & (j < T)
                got[np.broadcast_to(i, ok.shape)[ok],
                    np.broadcast_to(j, ok.shape)[ok]] = sb[ok]
                # dW: row 16 w + r, column c - (16 w + r) + BT - 1
                e = c64 - (16 * w + r16) + BT - 1
                assert (e >= eb).all() and (e < eb + BT + 16).all()
                dsv = np.where(ok, ds[np.minimum(i, T - 1),
                                      np.minimum(j, T - 1)], 0.0)
                mm = band[e]
                keep = ok & okb[e]
                np.add.at(un, (np.broadcast_to(i, ok.shape)[keep],
                               mm[keep]), dsv[keep])
            # dk/dv pass: P[e][c] = W[i0 + c][mb + e] lands at Ps[c][e + c
            # - BT + 1] when that is a key row r of the tile
            e, c = np.arange(NBAND)[:, None], c64
            r = e + c - (BT - 1)
            land = (r >= 0) & (r < BT)
            Ps = np.full((BT, LDP), np.nan)
            P = np.where(okb[e] & (q0 + c < T),
                         W[np.minimum(q0 + c, T - 1),
                           np.clip(band[e], 0, L - 1)], 0.0)
            Ps[np.broadcast_to(c, land.shape)[land], r[land]] = P[land]
            assert not np.isnan(Ps[:, :BT]).any()     # every (c, r) once
            kr, qc = np.arange(BT)[:, None], c64
            ok = (k0 + kr < T) & (q0 + qc < T)
            val = Ps[qc, kr]
            got_t[(q0 + qc + 0 * kr)[ok], (k0 + kr + 0 * qc)[ok]] = val[ok]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_t, want)
    np.testing.assert_allclose(un, want_un, rtol=0, atol=0)


# ------------------------------------------- ldmatrix and mma.sync (C2)

def ldsm(S, rows, cols, trans=False, mats=4):
    """ldmatrix (.x4, or .x2 from lanes 0-15): lane l gives the address of
    row l % 8 of matrix l / 8 (S[rows[l], cols[l] .. + 8)); returns r[lane,
    m] (value pairs). Each 8-lane phase must read 8 distinct 16-byte bank
    groups, and nothing unwritten (NaN)."""
    ld = S.shape[1]
    for m in range(mats):
        groups = {((rows[8 * m + i] * ld + cols[8 * m + i]) * 2 // 16) % 8
                  for i in range(8)}
        assert len(groups) == 8, "ldmatrix bank conflict"
    idx = np.arange(8 * mats)
    M = S[rows[idx, None], cols[idx, None] + np.arange(8)].reshape(
        mats, 8, 8)
    e = np.arange(2)
    if trans:
        r = M[:, Q[:, None] + e, GQ[:, None]]
    else:
        r = M[:, GQ[:, None], Q[:, None] + e]
    assert not np.isnan(r).any(), "ldmatrix read an unwritten element"
    return r.transpose(1, 0, 2)                           # (32, mats, 2)


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


def warp_scores(A, a0, Bm, b0, nt, DH):
    """warp_scores<DH, nt>: A's rows a0 .. + 16 times B's rows b0 .. + 8 nt,
    transposed, over the head width: (nt, 32, 4) accumulators."""
    s = np.zeros((nt, 32, 4))
    pa_r = a0 + (LANE & 7) + 8 * ((LANE >> 3) & 1)
    pb_r = b0 + (LANE & 7) + 8 * (LANE >> 4)
    for ks in range(DH // 16):
        a = ldsm(A, pa_r, 8 * (LANE >> 4) + 16 * ks)
        for npr in range(nt // 2):
            bq = ldsm(Bm, pb_r + 16 * npr, 8 * ((LANE >> 3) & 1) + 16 * ks)
            mma(s[2 * npr], a, bq[:, 0], bq[:, 1])
            mma(s[2 * npr + 1], a, bq[:, 2], bq[:, 3])
    return s


def warp_acc(acc, pf, V, v0, DH):
    """warp_acc<DH, len(pf)>: acc (DH / 8, 32, 4) += A V, A's k-step
    fragments pf, V's rows v0 .. (K) read transposed."""
    pr = v0 + (LANE & 7) + 8 * ((LANE >> 3) & 1)
    for ks, a in enumerate(pf):
        for npr in range(DH // 16):
            bq = ldsm(V, pr + 16 * ks, 8 * (LANE >> 4) + 16 * npr,
                      trans=True)
            mma(acc[2 * npr], a, bq[:, 0], bq[:, 1])
            mma(acc[2 * npr + 1], a, bq[:, 2], bq[:, 3])


def to_a(s):
    """mma.cuh to_a: the 16 x 32 accumulators (4, 32, 4) as two k-steps
    of A fragments (32, 4, 2)."""
    return [np.stack([s[2 * ks][:, 0:2], s[2 * ks][:, 2:4],
                      s[2 * ks + 1][:, 0:2], s[2 * ks + 1][:, 2:4]], axis=1)
            for ks in range(2)]


def dph_rows(acc, Ws, e0, Qv, DH):
    """dph_rows<DH, BT>: acc (2, DH / 8 + 1, 32, 4) += dW^T qv over the
    tile's BT queries, dW's columns e0 .. + 32 read transposed, the last
    n-tile Qv's column DH (ones) by ldmatrix.x2.trans."""
    for ks in range(Ws.shape[0] // 16):
        a = [ldsm(Ws, (LANE & 7) + 8 * (LANE >> 4) + 16 * ks,
                  e0 + 8 * ((LANE >> 3) & 1) + 16 * mt, trans=True)
             for mt in range(2)]
        pr = (LANE & 7) + 8 * ((LANE >> 3) & 1) + 16 * ks
        for npr in range(DH // 16):
            bq = ldsm(Qv, pr, 8 * (LANE >> 4) + 16 * npr, trans=True)
            for mt in range(2):
                mma(acc[mt][2 * npr], a[mt], bq[:, 0], bq[:, 1])
                mma(acc[mt][2 * npr + 1], a[mt], bq[:, 2], bq[:, 3])
        b1 = ldsm(Qv, pr, np.full(32, DH), trans=True, mats=2)
        for mt in range(2):
            mma(acc[mt][DH // 8], a[mt], b1[:, 0], b1[:, 1])


def quad_sum(v):
    """(32, ...) lanes summed over each group of 4 (mma.cuh quad_sum)."""
    return np.repeat(v.reshape(8, 4, *v.shape[1:]).sum(1), 4, axis=0)


# ------------------------------------------------- the emulated kernels

class Inputs:
    """One call's arrays (float64) and launch constants."""

    def __init__(self, q, k, v, ph, bu, bv, km, g, scale, H, rate, seed):
        self.q, self.k, self.v, self.ph, self.g = q, k, v, ph, g
        self.bu, self.bv, self.km = bu, bv, km
        self.B, self.T, self.D = q.shape
        self.H, self.dh = H, self.D // H
        self.DH = head_instance("test", self.dh, RELPOS_HEAD_WIDTHS)
        self.scale, self.rate, self.seed = scale, rate, seed
        self.L = 2 * self.T - 1
        self.BT, self.geo = TC_TILE, tc_geometry()
        self.nk = -(-self.T // TC_TILE)
        # the forward's row maximum and denominator (what the backward
        # reads), from the same float64 scores
        s = self.scores()
        self.M = s.max(-1)
        self.Lsum = np.exp(s - self.M[..., None]).sum(-1)
        self.visits = {p: np.zeros((self.B, H, self.T, self.T), int)
                       for p in ("dq_B", "dkdv")}

    def scores(self):
        B, T, H, dh = self.B, self.T, self.H, self.dh
        qu = (self.q + self.bu) * self.scale
        qv = (self.q + self.bv) * self.scale
        out = np.zeros((B, H, T, T))
        i, j = np.arange(T)[:, None], np.arange(T)[None, :]
        for h in range(H):
            sl = slice(h * dh, (h + 1) * dh)
            ac = qu[:, :, sl] @ self.k[:, :, sl].transpose(0, 2, 1)
            W = qv[:, :, sl] @ self.ph[:, sl].T
            bd = W[:, i, j - i + T - 1]
            out[:, h] = np.where(self.km[:, None, :], ac + bd, NEG_FILL)
        return out

    def keep(self, b, h, row, col):
        """Drop::keep at (query row, key col) of (b, h): stream seed + b H
        + h, element row T + col."""
        if self.rate == 0.0:
            return np.ones(np.shape(row))
        lin = torch.from_numpy(np.asarray(row, np.int64) * self.T
                               + np.asarray(col, np.int64))
        bits = drop.dropout_bits(lin, self.seed + b * self.H + h)
        return drop.mask_from_bits(bits, self.rate).double().numpy()


def stage(X, b, t0, nr, Tn, h, dh, DH):
    """stage_tc<DH, nr>: rows t0 .. + nr of head h of X (rows of D; row t
    of utterance b), zeros outside [0, Tn) and past dh; NaN in the pad."""
    S = np.full((nr, DH + 8), np.nan)
    S[:, :DH] = 0.0
    for r in range(nr):
        t = t0 + r
        if 0 <= t < Tn:
            S[r, :dh] = X[b, t, h * dh:(h + 1) * dh] if X.ndim == 3 else \
                X[t, h * dh:(h + 1) * dh]
    return S


def fold_quqv(Qu, inp, q0, h):
    """fold_quqv<DH>: Qu, Qv from the staged q; Qv's column DH is 1."""
    DH, dh = inp.DH, inp.dh
    Qv = np.full_like(Qu, np.nan)
    rows = (q0 + np.arange(inp.BT) < inp.T)[:, None]
    cols = (np.arange(DH) < dh)[None, :]
    ok = rows & cols
    bu = np.zeros(DH)
    bv = np.zeros(DH)
    bu[:dh], bv[:dh] = inp.bu[h * dh:(h + 1) * dh], inp.bv[h * dh:(h + 1) * dh]
    qf = Qu[:, :DH]
    Qv[:, :DH] = np.where(ok, (qf + bv) * inp.scale, 0.0)
    Qu = Qu.copy()
    Qu[:, :DH] = np.where(ok, (qf + bu) * inp.scale, 0.0)
    Qv[:, DH] = 1.0
    Qv[:, DH + 1:] = 0.0
    return Qu, Qv


def frag(nt):
    """(row within the warp's 16, column within its 8 nt, i) of every
    accumulator element: arrays (nt, 32, 4)."""
    n = np.arange(nt)[:, None, None]
    i = np.arange(4)[None, None, :]
    lane = LANE[None, :, None]
    return lane // 4 + 8 * (i // 2) + 0 * n, 8 * n + 2 * (lane % 4) + i % 2


def dq_pass(inp, b, h, qt, dq, Do, part, rsum):
    """relpos_bwd_dq_tc<DH, P_DQ | P_DPH> for block (qt, h, b): dq rows,
    D_i, and the query tile's dph partial (part[b, qt]) and band-row sums
    of dW (rsum[b, qt, h]) as the source writes them."""
    T, D, DH, dh, L, nk = inp.T, inp.D, inp.DH, inp.dh, inp.L, inp.nk
    BT, NW, NBAND = inp.BT, inp.geo["warps"], inp.geo["band"]
    q0 = qt * BT
    Qu, Qv = fold_quqv(stage(inp.q, b, q0, BT, T, h, dh, DH), inp, q0, h)
    Gs = stage(inp.g, b, q0, BT, T, h, dh, DH)
    Ws = np.zeros((BT, inp.geo["ldw"]))
    SB = np.full((NW, 16, inp.geo["sbw"]), np.nan)
    st = (b, h)
    rr4, cc4 = frag(4)

    def load(j):
        k0 = j * BT
        kv = np.arange(k0, k0 + BT)
        bits = (kv < T) & inp.km[b, np.minimum(kv, T - 1)]
        return (stage(inp.k, b, k0, BT, T, h, dh, DH),
                stage(inp.v, b, k0, BT, T, h, dh, DH),
                stage(inp.ph, 0, k0 - q0 + T - BT, NBAND, L, h, dh, DH),
                bits)

    def pos_scores(w, Bs):
        eb = BT - 16 - 16 * w
        sb = warp_scores(Qv, 16 * w, Bs, eb, (BT + 16) // 8, DH)
        r, c = frag((BT + 16) // 8)
        SB[w][r, c] = sb

    def probs(w, j, c, Ks, Vs, bits, Mrow, Lrow):
        s = warp_scores(Qu, 16 * w, Ks, 32 * c, 4, DH)
        dp = warp_scores(Gs, 16 * w, Vs, 32 * c, 4, DH)
        kc = 32 * c + cc4
        kg, row = j * BT + kc, q0 + 16 * w + rr4
        ok = (kg < T) & (row < T)
        sbv = SB[w][rr4, kc - rr4 + 15]
        assert not np.isnan(sbv).any()
        sc = np.where(bits[kc], s + sbv, NEG_FILL)
        rowc = np.minimum(row, T - 1)
        p = np.exp(sc - Mrow[rowc]) / Lrow[rowc]
        d = dp * inp.keep(b, h, rowc, np.minimum(kg, T - 1))
        return np.where(ok, p, 0.0), np.where(ok, d, 0.0), ok, row, kg

    Mrow, Lrow = inp.M[b, h], inp.Lsum[b, h]
    live = [q0 + 16 * w < T for w in range(NW)]
    di = np.zeros((NW, 32, 2))
    for j in range(nk):                                   # sweep A
        Ks, Vs, Bs, bits = load(j)
        for w in range(NW):
            if not live[w]:
                continue
            pos_scores(w, Bs)
            for c in range(BT // 32):
                p, d, *_ = probs(w, j, c, Ks, Vs, bits, Mrow, Lrow)
                di[w, :, 0] += (d[..., 0] * p[..., 0]
                                + d[..., 1] * p[..., 1]).sum(0)
                di[w, :, 1] += (d[..., 2] * p[..., 2]
                                + d[..., 3] * p[..., 3]).sum(0)
    di = np.stack([quad_sum(di[w]) for w in range(NW)])
    acc = np.zeros((NW, DH // 8, 32, 4))
    pacc = np.zeros((NW, 2, DH // 8 + 1, 32, 4))

    def flush(w, j, e0):
        mb = j * BT - q0 + T - BT
        for mt in range(2):
            for hr in range(2):
                e = e0 + 16 * mt + GQ + 8 * hr                  # per lane
                m = mb + e
                for lane in range(32):
                    if not 0 <= m[lane] < L:
                        continue
                    sr = e[lane] + BT * j
                    for n in range(DH // 8):
                        d0 = 8 * n + Q[lane]
                        if d0 < dh:
                            sl = part[b, qt, sr, h * dh + d0:h * dh + d0 + 2]
                            assert np.isnan(sl).all()            # once
                            sl[:] = pacc[w, mt, n, lane, 2 * hr:2 * hr + 2]
                    if Q[lane] == 0:
                        assert np.isnan(rsum[b, qt, h, sr])
                        rsum[b, qt, h, sr] = pacc[w, mt, DH // 8, lane,
                                                  2 * hr]

    for j in range(nk):                                   # sweep B
        Ks, Vs, Bs, bits = load(j)
        for w in range(NW):
            if not live[w]:
                continue
            pos_scores(w, Bs)
            for c in range(BT // 32):
                p, d, ok, row, kg = probs(w, j, c, Ks, Vs, bits, Mrow, Lrow)
                inp.visits["dq_B"][b, h][row[ok], kg[ok]] += 1
                ds = p * (d - di[w][:, [0, 0, 1, 1]][None])
                il = 16 * w + rr4
                kc = 32 * c + cc4
                Ws[il, kc - il + BT - 1] = ds
                warp_acc(acc[w], to_a(ds), Ks, 32 * c, DH)
            eb = BT - 16 - 16 * w
            af = [ldsm(Ws, 16 * w + (LANE & 7) + 8 * ((LANE >> 3) & 1),
                       eb + 8 * (LANE >> 4) + 16 * ks)
                  for ks in range((BT + 16) // 16)]
            warp_acc(acc[w], af, Bs, eb, DH)
        for w in range(NW):                # after the block barrier
            e0 = (32 * w + BT * (j & 1)) & (NBAND - 1)
            dph_rows(pacc[w], Ws, e0, Qv, DH)
            if e0 < BT:
                flush(w, j, e0)
                pacc[w] = 0.0
    for w in range(NW):
        e0 = (32 * w + BT * ((nk - 1) & 1)) & (NBAND - 1)
        if e0 >= BT:
            flush(w, nk - 1, e0)
    for w in range(NW):
        for r in range(2):
            rows = q0 + 16 * w + GQ + 8 * r
            for lane in range(32):
                if rows[lane] >= T:
                    continue
                for n in range(DH // 8):
                    d0 = 8 * n + Q[lane]
                    if d0 < dh:
                        dq[b, rows[lane], h * dh + d0:h * dh + d0 + 2] = \
                            acc[w, n, lane, 2 * r:2 * r + 2] * inp.scale
                if Q[lane] == 0:
                    Do[b, h, rows[lane]] = di[w, lane, r]


def dkdv_pass(inp, b, h, kt, Do, dk, dv, dbu_part):
    """relpos_bwd_dkdv_tc<DH> for block (kt, h, b)."""
    T, D, DH, dh, L = inp.T, inp.D, inp.DH, inp.dh, inp.L
    BT, NW, NBAND, LDP = (inp.BT, inp.geo["warps"], inp.geo["band"],
                          inp.geo["ldp"])
    k0 = kt * BT
    Ks = stage(inp.k, b, k0, BT, T, h, dh, DH)
    Vs = stage(inp.v, b, k0, BT, T, h, dh, DH)
    kr = k0 + np.arange(BT)
    kok = kr < T
    kmasked = kok & ~inp.km[b, np.minimum(kr, T - 1)]
    dka = np.zeros((NW, DH // 8, 32, 4))
    dva = np.zeros((NW, DH // 8, 32, 4))
    colsum = np.zeros((NW, 32, 2))
    rr4, cc4 = frag(4)
    for t in range(inp.nk):
        i0 = t * BT
        Qu, Qv = fold_quqv(stage(inp.q, b, i0, BT, T, h, dh, DH), inp, i0, h)
        Gs = stage(inp.g, b, i0, BT, T, h, dh, DH)
        Bs = stage(inp.ph, 0, k0 - i0 + T - BT, NBAND, L, h, dh, DH)
        qv_ok = i0 + np.arange(BT) < T
        qrow = np.minimum(i0 + np.arange(BT), T - 1)
        Ms = np.where(qv_ok, inp.M[b, h, qrow], 0.0)
        Ls = np.where(qv_ok, 1.0 / inp.Lsum[b, h, qrow], 1.0)
        Ds = np.where(qv_ok, Do[b, h, qrow], 0.0)
        Ps = np.full((BT, LDP), np.nan)
        r8, c8 = frag(BT // 8)
        for w in range(NW):
            for mt in range(2):
                ps = warp_scores(Bs, 32 * w + 16 * mt, Qv, 0, BT // 8, DH)
                e = 32 * w + 16 * mt + r8
                r = e + c8 - (BT - 1)
                land = (r >= 0) & (r < BT)
                assert np.isnan(Ps[c8[land], r[land]]).all()
                Ps[c8[land], r[land]] = ps[land]
        for w in range(NW):
            if k0 + 16 * w >= T:
                continue
            for c2 in range(BT // 32):
                s = warp_scores(Ks, 16 * w, Qu, 32 * c2, 4, DH)
                dp = warp_scores(Vs, 16 * w, Gs, 32 * c2, 4, DH)
                qc = 32 * c2 + cc4
                qg = i0 + qc
                krl = 16 * w + rr4
                kg = k0 + krl
                ok = (qg < T) & kok[krl]
                inp.visits["dkdv"][b, h][qg[ok], kg[ok]] += 1
                psv = Ps[qc, krl]
                assert not np.isnan(psv).any()
                sc = np.where(kmasked[krl], NEG_FILL, s + psv)
                with np.errstate(over="ignore"):     # rows past T: unused
                    p = np.exp(sc - Ms[qc]) * Ls[qc]
                kp = inp.keep(b, h, np.minimum(qg, T - 1),
                              np.minimum(kg, T - 1))
                with np.errstate(invalid="ignore"):
                    pt = np.where(ok, p * kp, 0.0)
                    ds = np.where(ok, p * (dp * kp - Ds[qc]), 0.0)
                colsum[w, :, 0] += ds[..., 0:2].sum((0, 2))
                colsum[w, :, 1] += ds[..., 2:4].sum((0, 2))
                warp_acc(dva[w], to_a(pt), Gs, 32 * c2, DH)
                warp_acc(dka[w], to_a(ds), Qu, 32 * c2, DH)
    wts = np.zeros(BT)
    for w in range(NW):
        cs = quad_sum(colsum[w])
        for r in range(2):
            krows = 16 * w + GQ + 8 * r
            for lane in range(32):
                kg = k0 + krows[lane]
                if kg >= T:
                    continue
                for n in range(DH // 8):
                    d0 = 8 * n + Q[lane]
                    if d0 < dh:
                        sl = slice(h * dh + d0, h * dh + d0 + 2)
                        dk[b, kg, sl] = dka[w, n, lane, 2 * r:2 * r + 2]
                        dv[b, kg, sl] = dva[w, n, lane, 2 * r:2 * r + 2]
                if Q[lane] == 0:
                    wts[krows[lane]] = inp.scale * cs[lane, r]
    dbu_part[b, kt, h * dh:(h + 1) * dh] = wts @ Ks[:, :dh]


def band_sums(inp, part, rsum):
    """relpos_bwd_band_sums_tc then the two fixed-order sums: dph, dbv."""
    B, T, D, H, dh, L, nk, BT = (inp.B, inp.T, inp.D, inp.H, inp.dh, inp.L,
                                 inp.nk, inp.BT)
    Lq = (nk + 1) * BT
    dph = np.zeros((L, D))
    dbv_part = np.zeros((-(-L // SUM_ROWS), D))
    for blk in range(dbv_part.shape[0]):
        for m in range(blk * SUM_ROWS, min(blk * SUM_ROWS + SUM_ROWS, L)):
            # the query tiles whose slice holds m, as the source reckons
            lo = -(-(T - BT - m) // BT) if T - BT - m > 0 else 0
            hi = min(nk, (Lq - 1 - m + T - BT) // BT + 1)
            assert [qt for qt in range(nk)
                    if 0 <= m + qt * BT - T + BT < Lq] == list(range(lo, hi))
            for bb in range(B):
                rs = np.zeros(H)
                for qt in range(lo, hi):
                    sr = m + qt * BT - T + BT
                    row = part[bb, qt, sr]
                    assert not np.isnan(row).any(), (m, bb, qt)
                    dph[m] += row
                    rs += rsum[bb, qt, :, sr]
                dbv_part[blk] += np.repeat(inp.scale * rs, dh) * inp.ph[m]
    return dph, dbv_part.sum(0)


def emulate(inp):
    """The bf16 backward's launches over their whole grids: (dq, dk, dv,
    dph, dbu, dbv); the partials' unwritten rows stay NaN."""
    B, T, D, H, nk = inp.B, inp.T, inp.D, inp.H, inp.nk
    Lq = (nk + 1) * inp.BT
    dq = np.full((B, T, D), np.nan)
    dk, dv = np.full((B, T, D), np.nan), np.full((B, T, D), np.nan)
    Do = np.full((B, H, T), np.nan)
    part = np.full((B, nk, Lq, D), np.nan)
    rsum = np.full((B, nk, H, Lq), np.nan)
    dbu_part = np.full((B, nk, D), np.nan)
    for b in range(B):
        for h in range(H):
            for qt in range(nk):
                dq_pass(inp, b, h, qt, dq, Do, part, rsum)
    for b in range(B):
        for h in range(H):
            for kt in range(nk):
                dkdv_pass(inp, b, h, kt, Do, dk, dv, dbu_part)
    dph, dbv = band_sums(inp, part, rsum)
    return dq, dk, dv, dph, dbu_part.sum((0, 1)), dbv


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [77, 5, 64, 129])
def test_emulated_tiles_give_the_plain_cotangents(T, rate):
    """All six cotangents of the emulated bf16 backward (float64, no
    roundings) against autograd of relpos_attention_plain (float32): T
    77 (a partial second tile), 5 (shorter than a tile), 64 (one whole
    tile) and 129 (a third tile of one row), 2 heads of 32, utterance 1's
    keys all masked (an empty key row: uniform rows), utterance 0's past
    60 (T > 60) or 3; within 1e-5 of each
    reference's largest magnitude. Dropout 0.1 also checks each pass's
    (query, key) of every accumulator against attention_mask and that
    each pair is visited once."""
    B, H, dh, seed = 2, 2, 32, 1234
    D = H * dh
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((B, T, D)) for _ in range(4))
    ph = rng.standard_normal((2 * T - 1, D))
    bu, bv = 0.3 * rng.standard_normal(D), 0.3 * rng.standard_normal(D)
    km = np.arange(T)[None] < np.array([[60 if T > 60 else 3], [0]])
    scale = D ** -0.5
    cast = [a.astype(np.float32).astype(np.float64)
            for a in (q, k, v, ph, bu, bv, g)]
    inp = Inputs(*cast[:6], km, cast[6], scale, H, rate, seed)
    got = emulate(inp)
    ts = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
          for a in cast[:6]]
    out = relpos_attention_plain(*ts, scale, H, torch.from_numpy(km), rate,
                                 seed)
    want = torch.autograd.grad(out, ts, torch.from_numpy(
        cast[6].astype(np.float32)))
    for name, a, w in zip(("dq", "dk", "dv", "dph", "dbu", "dbv"), got,
                          want):
        w = w.double().numpy()
        assert not np.isnan(a).any(), name
        tol = 1e-5 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(a, w, rtol=0, atol=tol, err_msg=name)
    for name, n in inp.visits.items():
        assert (n == 1).all(), name
    if rate > 0.0:
        mask = drop.attention_mask(B, H, T, T, rate, seed).double().numpy()
        for b in range(B):
            for h in range(H):
                i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
                np.testing.assert_array_equal(inp.keep(b, h, i, j),
                                              mask[b, h])


# ------------------------------------------------------ shared memory (C4)

@pytest.mark.parametrize("inst", RELPOS_HEAD_WIDTHS)
def test_tc_shared_memory_fits_at_every_width_and_length(inst):
    """The bf16 passes' shared memory (relpos_kernel_smem) is under the
    card's limit at every width 8-128 (each case: the widths that
    instance ``inst`` runs) and T <= 2000 (it does not depend on T: the
    tiles stream), the padded widths reckon as their instance, and two
    blocks of 64 rows share an SM at the recipes' 64."""
    for dh in range(8, 129, 8):
        if head_instance("test", dh, RELPOS_HEAD_WIDTHS) != inst:
            continue
        got = relpos_kernel_smem(torch.bfloat16, dh)
        assert got == relpos_kernel_smem(torch.bfloat16, inst)
        assert max(got.values()) <= SMEM_LIMIT, (dh, got)
    if inst == 64:
        at64 = relpos_kernel_smem(torch.bfloat16, 64)
        blocks = 128 // TC_TILE                  # the launch bounds' ask
        for kernel in ("dq", "dkdv"):
            assert blocks * (at64[kernel] + 1024) <= SM_SMEM, at64
        # the source's reckoning, term by term: five 64-row tiles and 128
        # band rows of 72 bf16; dW 64 x 136 bf16; 4 warps' 16 x 84 float32
        assert at64["dq"] == 2 * (5 * 64 + 128) * 72 + 2 * 64 * 136 \
            + 4 * 4 * 16 * 84 + 8 == 103432
        assert at64["dkdv"] == 2 * (5 * 64 + 128) * 72 + 4 * 64 * 68 \
            + 4 * 192


def test_tc_scratch_at_the_path_shape():
    """The bf16 backward's float32 scratch at conformer-small training (B
    16, T 199, D 256, 4 heads) at 64-row tiles: the dq pass's partials
    over 64 (nk + 1) = 320 band rows of each of nk = 4 query tiles (with
    the H band-row sums beside them) instead of the FMA route's
    per-utterance (2T - 1) rows; the band sums' dbv partials every
    SUM_ROWS rows."""
    assert TC_TILE == 64
    tc = relpos_bwd_scratch(16, 199, 256, 4, torch.bfloat16)
    assert tc == {"dph_part": 16 * 4 * 320 * 260, "dbu_part": 16 * 4 * 256,
                  "dbv_part": 50 * 256}
    fp = relpos_bwd_scratch(16, 199, 256, 4, torch.float32)
    assert fp == {"dph_part": 16 * 397 * 256, "dbu_part": 16 * 7 * 256,
                  "dbv_part": 16 * 13 * 256}
    assert 4 * tc["dph_part"] < 22e6        # 21.3 MB


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
    ("TILE", "TS"), ("TC_TILE", "BT"), ("SUM_ROWS", "SUM_ROWS"),
    ("warps", "NW"), ("threads", "TC"), ("band", "NBAND"), ("sbw", "SBW"),
    ("ldw", "LDW"), ("ldp", "LDP")])
def test_wrapper_constants_are_the_sources(name, source):
    """ops/cuda_attention.py's copy of each tile constant and of ``Geo``
    that sizes the scratch and the shared memory equals
    csrc/relpos_attention.cu's."""
    mine = tc_geometry().get(name, getattr(cuda_attention, name, None))
    assert mine == source_ints(CSRC / "relpos_attention.cu")[source]
