"""Launch geometry and fragment maps of the bf16 flash-attention kernels
(``speechain_tpu_torch/csrc/flash_attention.cu``), checked on the CPU.

No card is needed: the shared-memory reckoning is Python (the smoke run
holds it equal to the built kernels' own count), and the kernels' index
arithmetic (which accumulator element of which warp holds which score,
and which shared-memory rows each ``ldmatrix`` reads) is emulated with
numpy, copied from the source's formulas. The emulated
``mma.sync`` products must give q k^T and p v, and the (row, column) of
every accumulator element, fed through ``ops/dropout.py``'s attention
indexing, must reproduce the plain version's dropout mask with every
score visited exactly once. A slip in these maps passes at dropout 0 and
shows only at dropout > 0, or only on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_attention import (FLASH_HEAD_WIDTHS,
                                                    RELPOS_HEAD_WIDTHS,
                                                    flash_smem_bytes,
                                                    head_instance,
                                                    relpos_smem_bytes)
from speechain_tpu_torch.ops.cuda_build import SMEM_LIMIT

DH, BT, LDS = 64, 64, 72          # csrc/flash_attention.cu DH, BT, LDS
LANE = np.arange(32)
SM_SMEM = 228 * 1024              # an SM's shared memory, 1 KB per block
WIDE = [w for w in FLASH_HEAD_WIDTHS if w != 64]


def blocks_per_sm(kernel: str, dh: int) -> int:
    """The blocks an SM the bf16 kernels' launch bounds ask for at
    instance width dh (csrc/flash_attention.cu fwd_blocks / bwd_blocks)."""
    if kernel == "forward":
        return 4 if dh <= 64 else 3 if dh <= 96 else 2 if dh <= 128 else 1
    return 4 if dh <= 64 else 2 if dh <= 128 else 1


# ------------------------------------------------------------ the reckoning

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_smem_fits_the_card_up_to_2000_keys(dtype):
    for Tk in range(1, 2001):
        need = flash_smem_bytes(Tk, dtype)
        assert max(need.values()) <= SMEM_LIMIT, (Tk, need)


@pytest.mark.parametrize("kernel", ["forward", "dq", "dkdv"])
def test_four_bf16_blocks_fit_an_sm_up_to_2000_keys(kernel):
    """The bf16 kernels' launch bounds ask for 4 blocks of 4 warps an SM:
    their shared memory, with the 1 KB the card reserves for each block,
    must let 4 blocks share an SM's 228 KB at every Tk <= 2000."""
    for Tk in range(1, 2001):
        need = flash_smem_bytes(Tk, torch.bfloat16)[kernel]
        assert 4 * (need + 1024) <= 228 * 1024, (Tk, need)


# --------------------------------------- ldmatrix and mma.sync, emulated

def ldmatrix_x4(S, rows, cols, trans=False):
    """ldmatrix.x4 over shared tile S: lane l points at row l % 8 of matrix
    l / 8 (rows[l], cols[l] .. + 8); returns r[lane, m] as value pairs."""
    mats = np.stack([np.stack([S[rows[8 * m + i], cols[8 * m + i]:
                                 cols[8 * m + i] + 8] for i in range(8)])
                     for m in range(4)])                    # (4, 8, 8)
    r = np.zeros((32, 4, 2))
    for lane in LANE:
        for m in range(4):
            for e in range(2):
                r[lane, m, e] = (mats[m, 2 * (lane % 4) + e, lane // 4]
                                 if trans else
                                 mats[m, lane // 4, 2 * (lane % 4) + e])
    return r


def bank_conflict_free(rows, cols, lds=LDS):
    """Each 8-lane phase of an ldmatrix reads 8 rows of 16 bytes: with the
    padded stride they must fall in 8 distinct 16-byte bank groups."""
    for m in range(4):
        addr = [(rows[8 * m + i] * lds + cols[8 * m + i]) * 2
                for i in range(8)]
        if len({(a // 16) % 8 for a in addr}) != 8:
            return False
    return True


def mma(acc, a, b0, b1):
    """mma.sync m16n8k16: acc (32, 4) += A B with A from a (32, 4, 2) and B
    from b0, b1 (32, 2), in the PTX fragment layout (csrc/mma.cuh)."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in LANE:
        g, c = lane // 4, 2 * (lane % 4)
        A[g, c:c + 2], A[g + 8, c:c + 2] = a[lane, 0], a[lane, 1]
        A[g, c + 8:c + 10], A[g + 8, c + 8:c + 10] = a[lane, 2], a[lane, 3]
        Bm[c:c + 2, g], Bm[c + 8:c + 10, g] = b0[lane], b1[lane]
    C = A @ Bm
    for lane in LANE:
        g, c = lane // 4, 2 * (lane % 4)
        acc[lane] += [C[g, c], C[g, c + 1], C[g + 8, c], C[g + 8, c + 1]]


def scores(At, w, Bt, c0, dh=DH):
    """scores: the 16 x 32 chunk (warp w's rows of At) Bt[c0 .. c0 + 32)^T
    as s[n] (32, 4) over dh / 16 k-steps; the A fragment of each k-step
    read just before use."""
    s = np.zeros((4, 32, 4))
    arows = 16 * w + (LANE & 7) + 8 * ((LANE >> 3) & 1)
    lds = dh + 8
    for ks in range(dh // 16):
        acols = 8 * (LANE >> 4) + 16 * ks
        assert bank_conflict_free(arows, acols, lds)
        a = ldmatrix_x4(At, arows, acols)
        for np_ in range(2):
            rows = c0 + (LANE & 7) + 8 * (LANE >> 4) + 16 * np_
            cols = 8 * ((LANE >> 3) & 1) + 16 * ks
            assert bank_conflict_free(rows, cols, lds)
            bq = ldmatrix_x4(Bt, rows, cols)
            mma(s[2 * np_], a, bq[:, 0], bq[:, 1])
            mma(s[2 * np_ + 1], a, bq[:, 2], bq[:, 3])
    return s


def to_a(s):
    """to_a: accumulators of a 16 x 32 chunk as 2 k-steps of A fragments."""
    return [np.stack([s[2 * ks][:, 0:2], s[2 * ks][:, 2:4],
                      s[2 * ks + 1][:, 0:2], s[2 * ks + 1][:, 2:4]], axis=1)
            for ks in range(2)]


def acc_pv(acc, pf, Vt, c0, dh=DH):
    """acc_pv: acc (dh / 8, 32, 4) += P Vt[c0 .. c0 + 32), Vt read
    transposed."""
    for ks in range(2):
        for np_ in range(dh // 16):
            rows = c0 + (LANE & 7) + 8 * ((LANE >> 3) & 1) + 16 * ks
            cols = 8 * (LANE >> 4) + 16 * np_
            assert bank_conflict_free(rows, cols, dh + 8)
            bv = ldmatrix_x4(Vt, rows, cols, trans=True)
            mma(acc[2 * np_], pf[ks], bv[:, 0], bv[:, 1])
            mma(acc[2 * np_ + 1], pf[ks], bv[:, 2], bv[:, 3])


def frag_rc(w, c0):
    """(row, column) of accumulator element i of n-tile n in lane l:
    arrays (4 n, 32 lanes, 4 i)."""
    n = np.arange(4)[:, None, None]
    i = np.arange(4)[None, None, :]
    lane = LANE[None, :, None]
    row = 16 * w + lane // 4 + 8 * (i // 2) + 0 * n
    col = c0 + 8 * n + 2 * (lane % 4) + i % 2
    return row, col


def test_emulated_fragments_give_the_products():
    """A 64 x 64 tile of q, k and v (padded rows as staged): every warp's
    score chunks equal q k^T at their fragment map, and p v accumulated
    from the chunks' registers equals the product."""
    rng = np.random.default_rng(0)
    stage = lambda x: np.pad(x, ((0, 0), (0, LDS - DH)))  # noqa: E731
    q, k, v = (rng.integers(-4, 5, (BT, DH)).astype(np.float64)
               for _ in range(3))
    Qs, Ks, Vs = stage(q), stage(k), stage(v)
    want_s = q @ k.T
    p = rng.integers(-3, 4, (BT, BT)).astype(np.float64)
    want_o = p @ v
    for w in range(4):
        acc = np.zeros((8, 32, 4))
        for c in range(2):
            s = scores(Qs, w, Ks, 32 * c)
            row, col = frag_rc(w, 32 * c)
            np.testing.assert_array_equal(s, want_s[row, col])
            acc_pv(acc, to_a(p[row, col]), Vs, 32 * c)
        row, col = frag_rc(w, 0)
        rows8 = np.concatenate([row, row])
        cols8 = np.concatenate([col, col + 32])
        np.testing.assert_array_equal(acc, want_o[rows8, cols8])


# --------------------------------------------- dropout at the fragment map

def _visit(B, H, Tq, Tk, kernel):
    """Every (b, h, query, key) of the accumulator elements a kernel's
    loops produce, as in the source: the forward and the dq pass hold
    query rows and key columns, the dk/dv pass key rows and query
    columns. Elements past Tq or Tk are skipped, as the kernels skip
    them."""
    rows_n, cols_n = (Tq, Tk) if kernel != "dkdv" else (Tk, Tq)
    nt_r, nt_c = -(-rows_n // BT), -(-cols_n // BT)
    out = []
    for tr in range(nt_r):                      # blockIdx.x
        for w in range(4):
            for tc in range(nt_c):                # the sweep's tiles
                for c in range(2):
                    row, col = frag_rc(w, 32 * c)
                    row, col = tr * BT + row, tc * BT + col
                    ok = (row < rows_n) & (col < cols_n)
                    out.append(np.stack([row[ok], col[ok]], axis=1))
    rc = np.concatenate(out)
    if kernel == "dkdv":
        rc = rc[:, ::-1]
    bh = np.arange(B * H)
    qk = np.broadcast_to(rc[None], (B * H,) + rc.shape)
    return bh[:, None].repeat(len(rc), 1), qk[..., 0], qk[..., 1]


@pytest.mark.parametrize("B,H,Tq,Tk", [(3, 2, 77, 77), (2, 2, 31, 199),
                                       (2, 3, 1, 1)])
@pytest.mark.parametrize("kernel", ["forward", "dq", "dkdv"])
def test_fragment_map_reproduces_the_dropout_mask(kernel, B, H, Tq, Tk):
    """Rate 0.1 on a ragged (3, 77, 77) problem, a (2, 31, 199)
    cross-attention tile set and one query and key: the kernels'
    keep(q * Tk + k, seed + b * H + h) at each visited element rebuilds
    ``attention_mask`` exactly, each score once."""
    seed, rate = 1234, 0.1
    bh, qq, kk = _visit(B, H, Tq, Tk, kernel)
    count = np.zeros((B * H, Tq, Tk), np.int64)
    np.add.at(count, (bh, qq, kk), 1)
    assert (count == 1).all()
    lin = torch.from_numpy((qq * Tk + kk).astype(np.int64))
    bits = drop.dropout_bits(lin, torch.from_numpy(
        (seed + bh).astype(np.int64)))
    got = np.zeros((B * H, Tq, Tk), np.float32)
    got[bh, qq, kk] = drop.mask_from_bits(bits, rate).numpy()
    want = drop.attention_mask(B, H, Tq, Tk, rate, seed).reshape(
        B * H, Tq, Tk).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------ the other head widths (C1)

def stage(x, dh_inst):
    """stage<DH>: a (rows, DH) head slice into a 64 x (DH + 8) tile by
    16-byte chunks, element e -> row e / (DH / 8), column (e % (DH / 8)) *
    8, zeros past the rows; returns the tile and how often each chunk of
    it was written."""
    rows_n, dh = x.shape
    assert dh == dh_inst            # the kernels take their own width only
    ch = dh_inst // 8
    S = np.full((BT, dh_inst + 8), np.nan)
    hits = np.zeros((BT, ch), np.int64)
    for e in range(BT * ch):
        r, c = e // ch, (e % ch) * 8
        S[r, c:c + 8] = x[r, c:c + 8] if r < rows_n else 0.0
        hits[r, c // 8] += 1
    return S, hits


@pytest.mark.parametrize("dh", WIDE + [80, 40, 136])
def test_emulated_fragments_give_the_products_at_every_width(dh):
    """Every new instance (and a padded width run by the next one up: 80
    by 96, 40 by 64, 136 by 192, its heads zero-padded by the wrapper's
    ``pad_heads``): the staging writes each 16-byte chunk of the tile
    once, zeros past dh; every warp's score chunks equal q k^T at their
    fragment map, p v accumulated from the chunks equals the product in
    its first dh columns and zero past them, and every ldmatrix is free
    of bank conflicts at the padded stride."""
    from speechain_tpu_torch.ops.cuda_flash_attention import pad_heads
    w_inst = head_instance("test", dh, FLASH_HEAD_WIDTHS)
    assert w_inst >= dh and w_inst % 16 == 0
    assert ((w_inst + 8) // 8) % 2 == 1      # odd stride in 16-byte units
    rng = np.random.default_rng(dh)
    q, k, v = (rng.integers(-4, 5, (BT, dh)).astype(np.float64)
               for _ in range(3))
    (Qs, hq), (Ks, _), (Vs, _) = (
        stage(pad_heads(torch.from_numpy(x)[None], 1, w_inst)[0].numpy(),
              w_inst) for x in (q, k, v))
    assert (hq == 1).all() and not np.isnan(Qs[:, :w_inst]).any()
    assert (Qs[:, dh:w_inst] == 0).all()
    want_s = q @ k.T
    p = rng.integers(-3, 4, (BT, BT)).astype(np.float64)
    want_o = np.pad(p @ v, ((0, 0), (0, w_inst - dh)))
    for w in range(4):
        acc = np.zeros((w_inst // 8, 32, 4))
        for c in range(2):
            s = scores(Qs, w, Ks, 32 * c, w_inst)
            row, col = frag_rc(w, 32 * c)
            np.testing.assert_array_equal(s, want_s[row, col])
            acc_pv(acc, to_a(p[row, col]), Vs, 32 * c, w_inst)
        row, col = frag_rc(w, 0)
        nt = w_inst // 32
        rows = np.concatenate([row] * nt)
        cols = np.concatenate([col + 32 * t for t in range(nt)])
        np.testing.assert_array_equal(acc, want_o[rows, cols])


@pytest.mark.parametrize("dh", WIDE)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_smem_fits_the_card_at_every_width(dtype, dh):
    """Every instance's blocks fit the card's 227 KB at every Tk up to
    2000, and in bf16 as many blocks as the launch bounds ask for share
    an SM's 228 KB, 1 KB reserved for each."""
    for Tk in (1, 64, 65, 640, 768, 2000):
        need = flash_smem_bytes(Tk, dtype, dh)
        assert max(need.values()) <= SMEM_LIMIT, (Tk, need)
        if dtype == torch.bfloat16:
            for kernel, n in need.items():
                assert blocks_per_sm(kernel, dh) * (n + 1024) <= SM_SMEM, (
                    kernel, Tk, n)


@pytest.mark.parametrize("dh", [40, 80, 136])
def test_padded_heads_give_the_same_attention(dh):
    """The wrapper's padded path: attention over heads zero-padded to the
    next instance's width, sliced back, equals attention at the width
    itself, forward and gradients (causal, key-masked, dropout 0.1), in
    float32 on the plain version, within 1e-5 x max(1, max|ref|): only
    the order of the float32 sums over the head width differs."""
    from speechain_tpu_torch.ops.cuda_flash_attention import (
        flash_attention_plain, pad_heads)
    w, H, B, T = head_instance("test", dh, FLASH_HEAD_WIDTHS), 2, 2, 9
    gen = torch.Generator().manual_seed(dh)
    q, k, v = (torch.randn(B, T, H * dh, generator=gen, dtype=torch.float64
                           ).float().requires_grad_() for _ in range(3))
    km = torch.arange(T)[None] < torch.tensor([[T], [5]])
    g = torch.randn(B, T, H * dh, generator=gen)
    args = (0.3, H, True, 0.1, 11, km)
    want = flash_attention_plain(q, k, v, *args)
    got = flash_attention_plain(*(pad_heads(x, H, w) for x in (q, k, v)),
                                *args).reshape(B, T, H, w)
    assert (got[..., dh:] == 0).all()
    got = got[..., :dh].reshape(B, T, H * dh)
    for a, b in zip((got, *torch.autograd.grad(got, (q, k, v), g)),
                    (want, *torch.autograd.grad(want, (q, k, v), g))):
        tol = 1e-5 * max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


def test_padded_widths_reckon_as_their_instance():
    for dh, inst in ((8, 32), (40, 64), (72, 96), (80, 96), (104, 128),
                     (136, 192), (200, 256), (256, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            assert flash_smem_bytes(640, dtype, dh) == flash_smem_bytes(
                640, dtype, inst)
    assert relpos_smem_bytes(100, dh=48) == relpos_smem_bytes(100, dh=64)
    assert relpos_smem_bytes(100, dh=128) <= SMEM_LIMIT


# --------------------------------- the widths the wrappers take (C1)

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its CUDA branch up to the first launch (which needs nvcc)."""

    @property
    def is_cuda(self):
        return True


def _on_card(*shape):
    return torch.Tensor._make_subclass(_OnCard, torch.zeros(*shape))


class _Launched(Exception):
    pass


def _no_launch(*args):
    raise _Launched


@pytest.mark.parametrize("kind", ["flash", "relpos"])
def test_wrappers_take_exactly_the_built_widths(kind, monkeypatch):
    """The CUDA branch of each wrapper accepts a head width exactly when
    it is a multiple of 8 up to 256 (flash) or 128 (rel-pos), and raises a
    ValueError naming the width otherwise, before anything is built: the
    record that the kernels no longer take 64 alone. The CPU branch (the
    plain version) takes any width, as the reference does."""
    from speechain_tpu_torch.ops import cuda_attention, cuda_flash_attention
    from speechain_tpu_torch.ops.cuda_attention import cuda_relpos_attention
    from speechain_tpu_torch.ops.cuda_flash_attention import flash_attention
    for mod in (cuda_attention, cuda_flash_attention):   # stop at launch
        monkeypatch.setattr(mod.KERNEL, "launch", _no_launch)
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
    widths = FLASH_HEAD_WIDTHS if kind == "flash" else RELPOS_HEAD_WIDTHS
    top = max(widths)
    for dh in range(1, top + 25):
        ok = dh % 8 == 0 and dh <= top
        if ok:
            inst = head_instance(kind, dh, widths)
            assert inst == min(w for w in widths if w >= dh)
        else:
            with pytest.raises(ValueError, match=f"head width {dh} "):
                head_instance(kind, dh, widths)
    B, T, H = 1, 3, 2
    for dh in (20, 64, 40, top + 8):
        D = H * dh
        q = _on_card(B, T, D)
        if kind == "flash":
            call = lambda: flash_attention(q, q, q, 0.1, H)  # noqa: E731
        else:
            call = lambda: cuda_relpos_attention(  # noqa: E731
                q, q, q, _on_card(2 * T - 1, D), _on_card(D), _on_card(D),
                0.1, H)
        if dh in (64, 40):
            with pytest.raises(_Launched):       # past the width check
                call()
        else:
            with pytest.raises(ValueError, match=f"head width {dh} "):
                call()
        plain = torch.zeros(B, T, D)
        if kind == "flash":
            assert flash_attention(plain, plain, plain, 0.1, H).shape == (
                B, T, D)
