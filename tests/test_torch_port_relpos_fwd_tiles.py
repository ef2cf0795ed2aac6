"""Fragment maps of the bf16 rel-pos attention forward
(``speechain_tpu_torch/csrc/relpos_attention.cu``: ``relpos_fwd_tc``),
checked on the CPU.

No card is needed. The kernel's index arithmetic is emulated with numpy,
copied from the source's formulas, with the ``ldmatrix`` / ``mma.sync``
emulation of ``test_torch_port_relpos_tiles.py``: which rows a block
stages (its query tile, then each key tile, value tile and the 2 BT band
rows from mb = k0 - q0 + T - BT; BT = 64, as the backward), each warp's
position block (the shared
``pos_block``: 16 x (BT + 16) of qv ph^T read back at SB[r][c - r + 15]),
which accumulator element holds which (query, key), the two sweeps (the
exact row maximum, then p, its sum and round(p keep) v) and where each
output, M and L land.

- The emulated two-sweep forward, in float64 without roundings, gives
  ``relpos_attention_plain``'s output at dropout 0 and 0.1 at T = 77
  (with an empty key row), 199 and 600, within 1e-5 of its largest
  magnitude (float32 reference, other summation order).
- It gives the JAX package's ``flash_relpos_attention`` forward in
  interpret mode at T = 13 with an empty key row.
- Its M and L are the plain scores' row maximum and sum of exp(s - M).
- Each accumulator's (query, key), fed through ``ops/dropout.py``'s
  attention indexing, reproduces the kernel's mask, and every (query,
  key) of every (utterance, head) is visited once a sweep.
- The forward's shared-memory reckoning does not depend on T and stays
  under the card's limit at widths 32-128.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.ops.pallas_attention import flash_relpos_attention
from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_attention import (
    NEG_FILL, RELPOS_HEAD_WIDTHS, TC_TILE, head_instance,
    relpos_attention_plain, relpos_kernel_smem, relpos_scores_plain,
    relpos_smem_bytes, tc_geometry)
from speechain_tpu_torch.ops.cuda_build import SMEM_LIMIT
from test_torch_port_relpos_tiles import (GQ, Q, Inputs, fold_quqv, frag,
                                          quad_sum, stage, to_a, warp_acc,
                                          warp_scores)

SM_SMEM = 228 * 1024            # shared memory of an SM (1 KB a block kept)


def fwd_block(inp, b, h, qt, out, Mo, Lo, visits):
    """relpos_fwd_tc<DH> for block (qt, h, b): the output rows of its
    query tile, M and L, as the source writes them; visits[s] counts each
    (query, key) that sweep s takes."""
    T, DH, dh, L, BT = inp.T, inp.DH, inp.dh, inp.L, inp.BT
    geo = inp.geo
    NW, NBAND, SBW = geo["warps"], geo["band"], geo["sbw"]
    nk = -(-T // BT)
    q0 = qt * BT
    Qu, Qv = fold_quqv(stage(inp.q, b, q0, BT, T, h, dh, DH), inp, q0, h)
    rr4, cc4 = frag(4)

    def load(j):
        k0 = j * BT
        kv = np.arange(k0, k0 + BT)
        bits = (kv < T) & inp.km[b, np.minimum(kv, T - 1)]
        return (stage(inp.k, b, k0, BT, T, h, dh, DH),
                stage(inp.v, b, k0, BT, T, h, dh, DH),
                stage(inp.ph, 0, k0 - q0 + T - BT, NBAND, L, h, dh, DH),
                bits)

    def pos_block(w, Bs):
        """SB = qv ph[mb + eb ..]^T, eb = BT - 16 - 16 w, into the warp's
        16 x SBW block (NaN where unwritten)."""
        SB = np.full((16, SBW), np.nan)
        nt = (BT + 16) // 8
        r, c = frag(nt)
        SB[r, c] = warp_scores(Qv, 16 * w, Bs, BT - 16 - 16 * w, nt, DH)
        return SB

    def scores(w, j, c, Ks, bits, SB):
        """The scores of key columns 32 c .. + 32 of tile j: content +
        SB[r][c - r + 15], finfo.min where the key is masked; with each
        element's (query row, key)."""
        s = warp_scores(Qu, 16 * w, Ks, 32 * c, 4, DH)
        kc = 32 * c + cc4
        pos = SB[rr4, kc - rr4 + 15]
        assert not np.isnan(pos).any()
        return (np.where(bits[kc], s + pos, NEG_FILL),
                q0 + 16 * w + rr4, j * BT + kc)

    live = [q0 + 16 * w < T for w in range(NW)]
    m = np.full((NW, 32, 2), -np.inf)
    for j in range(nk):                                   # sweep 1
        Ks, _, Bs, bits = load(j)
        for w in range(NW):
            if not live[w]:
                continue
            SB = pos_block(w, Bs)
            for c in range(BT // 32):
                sc, row, kg = scores(w, j, c, Ks, bits, SB)
                visits[0][b, h][row[(kg < T) & (row < T)],
                                kg[(kg < T) & (row < T)]] += 1
                sc = np.where(kg < T, sc, -np.inf)
                m[w, :, 0] = np.maximum(m[w, :, 0], sc[..., :2].max((0, 2)))
                m[w, :, 1] = np.maximum(m[w, :, 1], sc[..., 2:].max((0, 2)))
    m = np.stack([np.repeat(mw.reshape(8, 4, 2).max(1), 4, axis=0)
                  for mw in m])                           # quad_max
    acc = np.zeros((NW, DH // 8, 32, 4))
    lsum = np.zeros((NW, 32, 2))
    for j in range(nk):                                   # sweep 2
        Ks, Vs, Bs, bits = load(j)
        for w in range(NW):
            if not live[w]:
                continue
            SB = pos_block(w, Bs)
            for c in range(BT // 32):
                sc, row, kg = scores(w, j, c, Ks, bits, SB)
                ok = kg < T
                visits[1][b, h][row[ok & (row < T)],
                                kg[ok & (row < T)]] += 1
                mrow = m[w][:, [0, 0, 1, 1]][None]
                p = np.where(ok, np.exp(np.where(ok, sc, mrow) - mrow), 0.0)
                lsum[w, :, 0] += p[..., :2].sum((0, 2))
                lsum[w, :, 1] += p[..., 2:].sum((0, 2))
                pk = p * inp.keep(b, h, row, np.minimum(kg, T - 1))
                warp_acc(acc[w], to_a(pk), Vs, 32 * c, DH)
    for w in range(NW):
        den = quad_sum(lsum[w])
        for r in range(2):
            rows = q0 + 16 * w + GQ + 8 * r
            okr = rows < T
            for n in range(DH // 8):
                for e in range(2):
                    col = 8 * n + Q + e
                    okc = okr & (col < dh)
                    dst = (b, rows[okc], h * dh + col[okc])
                    assert np.isnan(out[dst]).all()               # once
                    out[dst] = acc[w, n, okc, 2 * r + e] / den[okc, r]
            for lane in np.flatnonzero(okr & (Q == 0)):
                assert np.isnan(Mo[b, h, rows[lane]])
                Mo[b, h, rows[lane]] = m[w, lane, r]
                Lo[b, h, rows[lane]] = den[lane, r]


def emulate(inp):
    """The forward's launch over its whole grid: (out, M, L, visits)."""
    B, T, D, H = inp.B, inp.T, inp.D, inp.H
    out = np.full((B, T, D), np.nan)
    Mo, Lo = np.full((B, H, T), np.nan), np.full((B, H, T), np.nan)
    visits = [np.zeros((B, H, T, T), int) for _ in range(2)]
    for b in range(B):
        for h in range(H):
            for qt in range(-(-T // TC_TILE)):
                fwd_block(inp, b, h, qt, out, Mo, Lo, visits)
    return out, Mo, Lo, visits


def make_case(B, T, H, dh, lens, rate, seed=1234):
    """float32-valued inputs (float64 arrays) and the emulator's Inputs."""
    D = H * dh
    rng = np.random.default_rng(T)
    cast = [a.astype(np.float32).astype(np.float64) for a in (
        *(rng.standard_normal((B, T, D)) for _ in range(3)),
        rng.standard_normal((2 * T - 1, D)),
        0.3 * rng.standard_normal(D), 0.3 * rng.standard_normal(D))]
    km = np.arange(T)[None] < np.asarray(lens)[:, None]
    g = np.zeros((B, T, D))
    return cast, km, Inputs(*cast, km, g, D ** -0.5, H, rate, seed)


FWD_CASES = {
    # name: (B, T, H, dh, key lengths)
    "T77_empty_row": (2, 77, 2, 32, [60, 0]),
    "T199": (2, 199, 2, 32, [199, 150]),
    "T600": (1, 600, 2, 32, [511]),
}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_emulated_forward_gives_the_plain_output(case, rate):
    """The emulated two-sweep forward (float64, no roundings) against
    relpos_attention_plain (float32): the output within 1e-5 of its
    largest magnitude, M and L those of the plain
    scores (relpos_scores_plain), each (query, key) taken once a sweep;
    at dropout 0.1 also each (query, key)'s keep value against
    attention_mask."""
    B, T, H, dh, lens = FWD_CASES[case]
    cast, km, inp = make_case(B, T, H, dh, lens, rate)
    ts = [torch.from_numpy(a.astype(np.float32)) for a in cast]
    want = relpos_attention_plain(*ts, inp.scale, H, torch.from_numpy(km),
                                  rate, inp.seed).double().numpy()
    s = relpos_scores_plain(ts[0], ts[1], ts[3], ts[4], ts[5], inp.scale, H,
                            torch.from_numpy(km)).double().numpy()
    m_ref = s.max(-1)
    l_ref = np.exp(s - m_ref[..., None]).sum(-1)
    out, M, L, visits = emulate(inp)
    tol = 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(out, want, rtol=0, atol=tol, err_msg="out")
    np.testing.assert_allclose(M, m_ref, rtol=1e-6, atol=1e-6, err_msg="M")
    np.testing.assert_allclose(L, l_ref, rtol=1e-5, atol=0, err_msg="L")
    for n in visits:
        assert (n == 1).all()
    if 0 in lens:                                  # the empty row: uniform
        b = lens.index(0)
        assert (M[b] == NEG_FILL).all() and (L[b] == T).all()
    if rate > 0.0:
        mask = drop.attention_mask(B, H, T, T, rate, inp.seed).double()
        i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
        for b in range(B):
            for h in range(H):
                np.testing.assert_array_equal(inp.keep(b, h, i, j),
                                              mask[b, h].numpy())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_emulated_forward_gives_the_jax_kernel(rate):
    """The emulated forward against the JAX package's
    flash_relpos_attention (its Pallas forward in interpret mode) at T 13
    with an empty key row, 2 heads of 32: within 1e-5 of the largest
    magnitude."""
    B, T, H, dh = 2, 13, 2, 32
    D = H * dh
    cast, km, inp = make_case(B, T, H, dh, [13, 0], rate, seed=-123457)
    q, k, v, ph, bu, bv = (jnp.asarray(a.astype(np.float32)) for a in cast)
    want = np.asarray(flash_relpos_attention(
        q, k, v, ph, bu.reshape(1, D), bv.reshape(1, D),
        jnp.array([inp.seed], jnp.int32), inp.scale, H, rate,
        jnp.asarray(km.astype(np.int32)))).astype(np.float64)
    got = emulate(inp)[0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_forward_shared_memory_fits_at_every_width():
    """relpos_fwd_tc's shared memory (relpos_kernel_smem's bf16
    "forward") at every width 8-128 equals its instance's and is under the
    card's limit, for every T up to 2000 (the tiles stream). At the
    recipes' 64 two blocks share an SM, and the count is the source's,
    term by term."""
    for dh in range(8, 129, 8):
        inst = head_instance("test", dh, RELPOS_HEAD_WIDTHS)
        got = relpos_kernel_smem(torch.bfloat16, dh)["forward"]
        assert got == relpos_kernel_smem(torch.bfloat16, inst)["forward"]
        assert got <= SMEM_LIMIT, dh
    assert len({relpos_smem_bytes(T, torch.bfloat16, 128)
                for T in range(1, 2001)}) == 1
    at64 = relpos_kernel_smem(torch.bfloat16, 64)["forward"]
    # qu, qv; two slots of k, v and 128 band rows of 72 bf16; 4 warps'
    # 16 x 84 float32 position scores; two slots of key bits
    assert tc_geometry()["sbw"] == 84
    assert at64 == 2 * (2 + 4) * 64 * 72 + 2 * 128 * 72 * 2 \
        + 4 * 4 * 16 * 84 + 16 == 113680
    assert 2 * (at64 + 1024) <= SM_SMEM
