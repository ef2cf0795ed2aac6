"""Launch geometry and sum order of the LayerNorm kernels
(``speechain_tpu_torch/csrc/layernorm.cu``: ``ln_fwd_rows``,
``ln_bwd_rows``, ``ln_bwd_sums``), checked on the CPU.

No card is needed. The kernels' index arithmetic is emulated with numpy,
copied from the source's formulas, at the shapes and SM counts the
wrapper (``ops/cuda_layernorm.py``) sizes them for:

- the forward: warp gw of the grid takes row gw, FWD_WARPS warps a
  block; lane l keeps the 16-byte vectors j < NV at columns (32 j + l) VN;
  each row's sum and sum of squares reduced by the xor butterfly;
- the backward: P blocks, block p a run of rpb = ceil(N / P) rows, warp w
  of W its rows w, w + W, ... in order, R at a time; each warp's dscale /
  dbias sums in row order, the block's partial the warps' sums in warp
  order, laid out (dscale (D), dbias (D)); the partials' sum: SUM_COLS
  columns a block, warp w the partials of its segment in order, then the
  SUM_WARPS segment sums in order.

Every row (and every column of it) is covered exactly once, every partial
counts once, and the emulated results in float32 equal
``layer_norm_plain`` and its autograd within 1e-5 of max(1, max|ref|) in
float32 and 2^-6 in bf16 (whose inputs and outputs round to bf16), at the
path's N 3184, 496 and 256, ragged N 2985, 77 and 1, D 256, 512 and 1024,
at 132 and 114 SMs. The wrapper's grid and scratch reckoning
(``layout``) and its copies of the source's constants are held to the
source's rules too (the smoke run holds them equal to the built host
code's on the card).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from speechain_tpu_torch.ops import cuda_layernorm as cl
from speechain_tpu_torch.ops.cuda_build import CSRC

LANE = np.arange(32)
EPS = 1e-6
F32 = np.float32


def cdiv(a, b):
    return -(-a // b)


def round_to(a, dtype):
    """float32 values rounded to ``dtype`` and widened back."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def lane_columns(D, dtype):
    """(NV, 32, VN) column of each lane's vector elements, -1 past D."""
    vn = 16 // dtype.itemsize
    nv = cl.vectors(D, dtype)
    c = ((32 * np.arange(nv)[:, None] + LANE) * vn)[..., None] \
        + np.arange(vn)
    first = c[..., :1]
    return np.where(first < D, c, -1), nv, vn


def butterfly(s):
    """The xor-shuffle sum of (..., 32) lane values, in float32: lane l
    adds lane l ^ o for o = 16, 8, 4, 2, 1 (every lane ends equal)."""
    for o in (16, 8, 4, 2, 1):
        s = (s + s[..., LANE ^ o]).astype(F32)
    return s[..., 0]


def lane_sums(v, cols):
    """Each lane's sum over its vectors j and elements e, in that order,
    of v (rows, D) float32: (rows, 32)."""
    s = np.zeros((v.shape[0], 32), F32)
    nv, _, vn = cols.shape
    for j in range(nv):
        for e in range(vn):
            c = cols[j, :, e]
            on = c >= 0
            s[:, on] = (s[:, on] + v[:, c[on]]).astype(F32)
    return s


def inputs(N, D, dtype, seed):
    rng = np.random.default_rng(seed)
    x = round_to((3 * rng.standard_normal((N, D)) + 1).astype(F32), dtype)
    scale = (1 + 0.5 * rng.standard_normal(D)).astype(F32)
    bias = (0.1 * rng.standard_normal(D)).astype(F32)
    g = round_to(rng.standard_normal((N, D)).astype(F32), dtype)
    return x, scale, bias, g


def emulate_forward(x, scale, bias, dtype, sms):
    """ln_fwd_rows at the wrapper's launch: (y, mu, rstd, rows seen)."""
    N, D = x.shape
    grid, threads = cl.layout(N, D, dtype, sms)["fwd"]
    rows = np.arange(grid * (threads // 32))  # blockIdx.x * W + warp
    seen = np.bincount(rows[rows < N], minlength=N)
    cols, _, _ = lane_columns(D, dtype)
    s = butterfly(lane_sums(x, cols))
    ss = butterfly(lane_sums((x * x).astype(F32), cols))
    mu = (s / F32(D)).astype(F32)
    rstd = (1 / np.sqrt((ss / F32(D) - mu * mu + F32(EPS)).astype(F32))
            ).astype(F32)
    y = ((x - mu[:, None]) * rstd[:, None] * scale + bias).astype(F32)
    return round_to(y, dtype), mu, rstd, seen


def emulate_backward(x, scale, mu, rstd, g, dtype, sms):
    """ln_bwd_rows and ln_bwd_sums at the wrapper's (P, W, R): (dx,
    dscale, dbias, rows seen, partials counted)."""
    N, D = x.shape
    P, W, R = cl.backward_geometry(N, D, dtype, sms)
    lay = cl.layout(N, D, dtype, sms)
    assert lay["bwd"] == (P, 32 * W, 4 * W * D)
    cols, _, _ = lane_columns(D, dtype)
    xh = ((x - mu[:, None]) * rstd[:, None]).astype(F32)
    gs = (g * scale).astype(F32)
    m1 = (butterfly(lane_sums(gs, cols)) / F32(D)).astype(F32)
    m2 = (butterfly(lane_sums((gs * xh).astype(F32), cols)) / F32(D)
          ).astype(F32)
    dx = round_to((rstd[:, None] * (gs - m1[:, None] - xh * m2[:, None])
                   ).astype(F32), dtype)
    gx = (g * xh).astype(F32)
    rpb = cdiv(N, P)
    seen = np.zeros(N, int)
    part = np.zeros((P, 2 * D), F32)
    for p in range(P):
        lo, hi = p * rpb, min(N, p * rpb + rpb)
        red = np.zeros((W, 2, D), F32)
        for w in range(W):
            for k0 in range(lo + w, hi, W * R):        # R rows at a time
                for r in range(R):
                    row = k0 + W * r
                    if row >= hi:
                        break
                    seen[row] += 1
                    red[w, 0] = (red[w, 0] + gx[row]).astype(F32)
                    red[w, 1] = (red[w, 1] + g[row]).astype(F32)
        for w in range(W):                             # warp order
            part[p] = (part[p] + red[w].ravel()).astype(F32)
    # the partials' sum: SUM_WARPS segments of ceil(P / SUM_WARPS), each in
    # order, then the segments in order (every column alike)
    ps = cdiv(P, cl.SUM_WARPS)
    counted = np.zeros(P, int)
    sums = np.zeros(2 * D, F32)
    for w in range(cl.SUM_WARPS):
        seg = np.zeros(2 * D, F32)
        for p in range(w * ps, min(P, w * ps + ps)):
            counted[p] += 1
            seg = (seg + part[p]).astype(F32)
        sums = (sums + seg).astype(F32)
    grid, threads = lay["sum"]
    assert grid * cl.SUM_COLS >= 2 * D and threads == \
        cl.SUM_COLS * cl.SUM_WARPS
    return dx, sums[:D], sums[D:], seen, counted


def close(got, want, tol_rel, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol_rel * max(1.0, float(np.abs(want).max())), (what, err)


SHAPES = [(N, D) for N in (3184, 496, 256, 2985, 77, 1)
          for D in (256, 512, 1024)]


@pytest.mark.parametrize("N,D", SHAPES)
def test_emulated_kernels_are_layer_norm_and_its_gradients(N, D):
    """Forward and backward, bf16 and float32, at 132 and 114 SMs: every
    row once, every partial once, and the values of ``layer_norm_plain``
    and its autograd."""
    for dtype in (torch.bfloat16, torch.float32):
        tol = 1e-5 if dtype == torch.float32 else 2 ** -6
        x, scale, bias, g = inputs(N, D, dtype, seed=N + D)
        tx = torch.from_numpy(x).to(dtype).requires_grad_()
        ts, tb = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
        want = cl.layer_norm_plain(tx, ts, tb, EPS)
        wdx, wds, wdb = torch.autograd.grad(
            want, (tx, ts, tb), torch.from_numpy(g).to(dtype))
        for sms in (132, 114):
            y, mu, rstd, seen = emulate_forward(x, scale, bias, dtype, sms)
            assert (seen == 1).all()
            close(y, want.float().detach(), tol, f"y {dtype} {sms}")
            dx, ds, db, seen, counted = emulate_backward(x, scale, mu, rstd,
                                                         g, dtype, sms)
            assert (seen == 1).all() and (counted == 1).all()
            close(dx, wdx.float(), tol, f"dx {dtype} {sms}")
            close(ds, wds, tol, f"dscale {dtype} {sms}")
            close(db, wdb, tol, f"dbias {dtype} {sms}")


@pytest.mark.parametrize("D", [8, 128, 200, 256, 384, 512, 640, 768, 1000,
                               1024])
def test_each_column_belongs_to_one_lane_vector(D):
    """Lane l's vector j covers columns (32 j + l) VN .. + VN; those below
    D cover 0 .. D - 1 exactly once, in both dtypes (D a multiple of the
    values a vector holds)."""
    for dtype in (torch.bfloat16, torch.float32):
        cols, nv, vn = lane_columns(D, dtype)
        if D % vn:
            continue
        got = np.sort(cols[cols >= 0])
        assert (got == np.arange(D)).all()
        assert nv & (nv - 1) == 0 and nv * 32 * vn >= D
        assert nv == 1 or (nv // 2) * 32 * vn < D


def source_consts():
    src = (CSRC / "layernorm.cu").read_text()
    return src, {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("name", ["MAX_D", "MAX_WARPS", "MAX_CHUNK",
                                  "SUM_COLS", "SUM_WARPS"])
def test_wrapper_constants_are_the_sources(name):
    assert getattr(cl, name) == source_consts()[1][name]


def test_sources_instances_are_the_chunks_the_wrapper_takes():
    """The source dispatches NV 1, 2, 4, 8 and R 1, 2, 4, and builds the
    (NV, R) pairs with R NV <= MAX_CHUNK or R = 1 whose rows fit MAX_D:
    the pairs the wrapper's reckoning picks from."""
    src = source_consts()[0]
    body = src[src.index("int by_vectors("):src.index("struct Layout")]
    assert re.findall(r"case (\d+): return fn", body) == \
        ["1", "2", "4", "8", "1", "2", "4"]
    assert "R == 1 || R * NV <= MAX_CHUNK" in body
    assert "NV * 32 * Vec<T>::N <= MAX_D" in body


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_launch_reckoning_at_every_row_count(sms):
    """At every N up to 4000 and D 128-1024 the wrapper's picks are launches
    the kernels take: the forward's grid covers N rows with no empty
    block; the backward's P runs (at most one an SM, of BWD_MIN_ROWS rows
    where N allows) are all non-empty, W fits the rows of a run, R the
    rows of a warp, and the shared memory (W D float32) is within the 48
    KB a launch gets without an attribute."""
    assert 1 <= cl.FWD_WARPS <= cl.MAX_WARPS
    for dtype in (torch.bfloat16, torch.float32):
        for D in (128, 256, 384, 512, 768, 1024):
            nv = cl.vectors(D, dtype)
            assert nv * 32 * 16 // dtype.itemsize <= 2 * max(D, 128)
            for N in range(1, 4001):
                grid, threads = cl.layout(N, D, dtype, sms)["fwd"]
                W = threads // 32
                assert W == cl.FWD_WARPS and (grid - 1) * W < N <= grid * W
                P, Wb, Rb = cl.backward_geometry(N, D, dtype, sms)
                rpb = cdiv(N, P)
                assert 1 <= P <= min(N, sms) and (P - 1) * rpb < N
                assert Wb == min(cl.MAX_WARPS, rpb)
                assert Rb == 1 or (Rb * nv <= cl.MAX_CHUNK
                                   and Rb <= cdiv(rpb, Wb))
                assert rpb >= min(cl.BWD_MIN_ROWS, cdiv(N, sms))
                assert 4 * Wb * D <= 48 * 1024


def test_scratch_and_grids_at_the_paths_shapes():
    """The reckoning at the path's shapes on the H100 (132 SMs), bf16 D
    256: the forward's 3184 / 256 rows in 796 / 64 blocks of 4 warps; the
    backward's 3184 rows in 128 runs of 25 (8 warps, 4 rows a warp at
    once), 496 in 62 of 8 and 256 in 32 of 8 (one row a warp); 16 blocks
    add the partials of 512 columns."""
    bf = torch.bfloat16
    assert cl.layout(3184, 256, bf)["fwd"] == (796, 128)
    assert cl.layout(256, 256, bf)["fwd"] == (64, 128)
    assert cl.backward_geometry(3184, 256, bf) == (128, 8, 4)
    assert cl.backward_geometry(496, 256, bf) == (62, 8, 1)
    assert cl.backward_geometry(256, 256, bf) == (32, 8, 1)
    assert cl.layout(3184, 256, bf)["sum"] == (16, 256)
    assert cl.layout(3184, 256, bf)["bwd"] == (128, 256, 8192)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernels: fused_layer_norm is
    layer_norm_plain there, value and gradient."""
    x = torch.randn(8, 256, dtype=torch.float64).float().requires_grad_()
    s = torch.ones(256, requires_grad=True)
    b = torch.zeros(256, requires_grad=True)
    y = cl.fused_layer_norm(x, s, b)
    assert torch.equal(y, cl.layer_norm_plain(x, s, b))
    assert cl.KERNEL.counts == {"layer_norm_forward": 0,
                                "layer_norm_backward": 0}
