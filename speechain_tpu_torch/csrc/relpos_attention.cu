// Transformer-XL relative-position multi-head attention for Hopper (sm_90a),
// forward and backward.
//
// Replaces speechain_tpu/ops/pallas_attention.py::flash_relpos_attention:
// the forward pl.pallas_call at :722 (body _rel_fwd_kernel :482) and the
// backward at :760 (body _rel_bwd_kernel :555).
//
// Layout as on the TPU: q, k, v (B, T, D) with heads as column slices of
// width Dh = D / H; ph (L, D), L = 2T - 1, the projected relative positions
// [T-1 .. -(T-1)]; bu, bv (D,) float32 (pos_bias_u / pos_bias_v
// flattened); key mask (B, T) int32 or null.
//
// Forward, for query i and key j of head h:
//   qu = round((q + bu) * scale), qv = round((q + bv) * scale)  (_qu_qv)
//   s[i][j] = qu[i] . k[j] + qv[i] . ph[j - i + T - 1]   (the relative
//             shift as index arithmetic: no (T, 2T-1) band is formed)
//   masked keys: s = finfo(float32).min (a fully masked row is uniform);
//   p = exp(s - max_j s), den = sum_j p,
//   out[i] = (sum_j round(p * dropmask) v[j]) / den   (_softmax_fold).
// Forward: one block per (query tile, head, utterance); key tiles and the
// 2 BT - 1 band rows that a (query tile, key tile) pair touches stream
// through shared memory, so shared memory does not grow with T. As in
// csrc/flash_attention.cu, a first sweep over the key tiles finds each
// row's exact maximum, so p is rounded to the compute dtype at the TPU
// kernel's point (an online softmax would round p against a running
// maximum); the row maximum M and denominator L are kept for the
// backward. One launch a call. Two instances:
//
// float32 (relpos_fwd): tiles of TS = 32 rows, every product on the FMA
// units in float32 (TF32 would break the float32 contract, as below).
//
// bf16 (relpos_fwd_tc): tiles of BT = 64 rows, as the backward (32-row
// tiles were slower at the path's shape, PERF.md), 4 warps of 16 query
// rows. What bounds it at conformer-small (B 16, T 199, 4 heads of 64):
// a forward is ~0.97 GFLOP of products (1.0 us at 989 TFLOP/s) on ~7 MB
// of q/k/v/ph/out (2.0 us at 3.35 TB/s), so the bytes; run on the FMA
// units in float32 it took 0.258 ms (PERF.md). Here every product is an
// m16n8k16 mma.sync with bf16 operands by ldmatrix and float32 sums: the
// content scores qu k^T, the position block qv ph^T (pos_block, shared
// with the backward's dq pass) and round(p keep) v. k, v and the band
// rows stream through a two-slot cp.async ring (the copies of tile j + 1
// overlap the products of tile j). Products a sweep forms again: sweep 1
// forms each key tile's position block and content scores for the
// maximum; sweep 2 forms both again, then p v.
// Rounding points as _rel_fwd_kernel: qu and qv (_qu_qv), round(p *
// keep) (_softmax_fold, p unnormalised, l summed before the dropout), out
// = round(acc / l).
//
// Backward (_rel_bwd_kernel, the interpret-mode branch :599-610 and its
// rounding points :646-656), with the NORMALISED p = exp(s - M) / L
// (_softmax_fp32) and the regenerated dropout mask:
//   dv = sum_i round(p * mask)[i][j] g[i];  dp = (g . v) * mask;
//   ds = p (dp - rowsum(dp p));  ds_c = round(ds);
//   dW[i][j - i + T - 1] = ds_c[i][j]        (transpose of the shift)
//   dq = (ds_c k + dW ph) * scale;  dk = ds_c^T qu;  dph = dW^T qv;
//   dbu = round(scale * sum_i ds[i][:]) . k  (the float32 ds),
//   dbv = round(scale * sum_i dW[i][:]) . ph (the rounded dW).
// Masked keys take finfo(float32).min, so a fully masked row is uniform.
// Dropout bits: common.cuh::dropout_bits, stream seed + b * H + h, element
// i * T + j, as the TPU kernel's interpret mode. Two instances:
//
// float32 (relpos_bwd_dq, relpos_bwd_dkdv, relpos_bwd_band): all products
// on the FMA units in float32 (on the tensor cores float32 means TF32,
// about three decimal digits, which breaks the 1e-4 contract a float32
// step holds the card to against the CPU). Three passes over 32-row
// tiles, deterministic without atomics:
//   relpos_bwd_dq   one block per query tile: D_i = rowsum(dp p), then dq;
//   relpos_bwd_dkdv one block per key tile, looping over query tiles:
//                   dk, dv and the key-column sums of ds (dbu partials);
//   relpos_bwd_band one block per tile of 32 band rows m, looping over
//                   query tiles: dph (per-utterance float32 partials) and
//                   the band-column sums of dW (dbv partials).
// relpos_bwd_sums then adds the partials over utterances and tiles in a
// fixed order. Each pass recomputes the scores it needs from q, k, ph.
// 6 launches a call.
//
// bf16 (relpos_bwd_dq_tc, relpos_bwd_dkdv_tc, relpos_bwd_band_sums_tc):
// every product on the tensor cores, mma.sync m16n8k16 with bf16 operands
// by ldmatrix from shared memory and float32 sums (mma.cuh), at the same
// rounding points. What bounds it at conformer-small training (B 16, T
// 199, 4 heads of 64): the bytes (3.6 us at 3.35 TB/s for q/k/v/g/ph and
// the results) and the operations alike are microseconds; run in bf16,
// the float32 instance's design took 1.0 ms (PERF.md), because every
// product ran on the FMA units and three passes each recomputed every
// score. This design:
// - Tiles of BT = 64 rows (query and key tiles alike; 32-row tiles were
//   slower at the path's shape, PERF.md), 4 warps of 16 rows, staged by
//   16-byte cp.async copies as bf16 at rows of DH + 8 values (an odd
//   number of 16-byte units: conflict-free ldmatrix); one slot each, two
//   blocks an SM. Shared memory does not grow with T.
// - The position term is a product over the band: a (query tile q0, key
//   tile k0) pair touches 2 BT - 1 band rows from mb = k0 - q0 + T - BT.
//   The dq pass forms each warp's 16 x (BT + 16) block SB = qv ph^T and
//   reads the Transformer-XL shift s_pos[r][c] = SB[r][c - r + 15] back
//   from shared memory; the dk/dv pass forms P = ph qv^T (2 BT x BT) for
//   the block and keeps P[e][c] where it lands on a (key, query) pair.
// - Two passes and a sum: relpos_bwd_dq_tc (one block per query tile:
//   D_i, then ds_c into dW in the band layout, dq = (ds_c k + dW ph) *
//   scale, and dph = dW^T qv with Qv's pad column of ones summing each
//   band row of dW: per-query-tile float32 partials over BT (nk + 1) band
//   rows, a rolling accumulator that writes each row once); then
//   relpos_bwd_dkdv_tc (one block per key tile: dv, dk and the dbu
//   partials); relpos_bwd_band_sums_tc adds the dph partials and forms
//   the dbv partials (rounded per utterance and head); relpos_bwd_sums
//   finishes dbu and dbv. No atomics; every sum in a fixed order. 5
//   launches a call at DH <= 64; from DH 96 the dq pass's accumulators
//   and dph's do not fit together and dph takes a launch of its own (6).
//   Products recomputed a pass: the dq pass's two sweeps each form the
//   content and position scores and dp; the dk/dv pass forms them again.
// - The dph partials are B nk BT (nk + 1) (D + H) float32 values: 21.3 MB
//   at the path's shape (nk = 4), growing as T^2 / BT.
// - Per-score work on the FMA units: exp(s - M) is the SFU's __expf and
//   the pass multiplies by 1 / L (as csrc/flash_attention.cu).
//
// Head widths: the kernels are templates on their head width DH, built at
// DH = 32, 64, 96 and 128 (every conformer recipe has 64). A width up to
// 128 that is a multiple of 8 runs the smallest instance DH >= Dh, its
// columns past Dh staged as zeros and left unwritten; any other width is
// refused (cudaErrorInvalidValue; the wrapper raises first). A block's
// largest shared memory: the float32 dph pass's, 149 KB at DH 128; the
// bf16 forward's, 111 KB at DH 64 (two blocks an SM) and 191 KB at DH
// 128; the bf16 dq pass's, 101 KB at DH 64 and 157 KB at DH 128.

#include <float.h>

#include <initializer_list>
#include <type_traits>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace sct;

constexpr int TS = 32;        // rows of a query, key or band tile
constexpr int NB = 2 * TS;    // band / key rows one tile pair touches (63)
constexpr float NEG_FILL = -FLT_MAX;   // finfo(float32).min

struct Drop {
  int on;
  unsigned int seed, thresh;
  float scale;
  __device__ __forceinline__ float keep(int b, int H, int h, int i, int Tn,
                                        int j) const {
    if (!on) return 1.f;
    return dropout_keep((unsigned int)i * (unsigned int)Tn + (unsigned int)j,
                        seed + (unsigned int)(b * H + h), thresh, scale);
  }
};

// rows [t0, t0 + n) of head h (width dh) of X (B, T, D) -> S[n][DH + 1]
// float, zeros outside [0, T) and past dh
template <int DH, typename T>
__device__ __forceinline__ void load_rows(float* S, const T* __restrict__ X,
                                          int b, int t0, int n, int Tn,
                                          int D, int h, int dh) {
  for (int e = threadIdx.x; e < n * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, t = t0 + r;
    S[r * (DH + 1) + d] =
        (t >= 0 && t < Tn && d < dh)
            ? to_f(X[((size_t)b * Tn + t) * D + h * dh + d])
            : 0.f;
  }
}

// rows [m0, m0 + n) of head h of ph (L, D) -> S[n][DH + 1], zeros outside
template <int DH, typename T>
__device__ __forceinline__ void load_band(float* S, const T* __restrict__ ph,
                                          int m0, int n, int L, int D,
                                          int h, int dh) {
  for (int e = threadIdx.x; e < n * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, m = m0 + r;
    S[r * (DH + 1) + d] = (m >= 0 && m < L && d < dh)
                              ? to_f(ph[(size_t)m * D + h * dh + d])
                              : 0.f;
  }
}

// qu, qv of query rows [q0, q0 + TS): the float32 fold of the biases and
// the scale, rounded to the compute dtype; zeros past T and past dh
template <int DH, typename T>
__device__ __forceinline__ void load_quqv(float* Qu, float* Qv,
                                          const T* __restrict__ q,
                                          const float* __restrict__ bu,
                                          const float* __restrict__ bv,
                                          int b, int q0, int Tn, int D,
                                          int h, int dh, float scale) {
  for (int e = threadIdx.x; e < TS * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, t = q0 + r;
    float u = 0.f, w = 0.f;
    if (t < Tn && d < dh) {
      const float qf = to_f(q[((size_t)b * Tn + t) * D + h * dh + d]);
      u = round_to<T>((qf + bu[h * dh + d]) * scale);
      w = round_to<T>((qf + bv[h * dh + d]) * scale);
    }
    Qu[r * (DH + 1) + d] = u;
    Qv[r * (DH + 1) + d] = w;
  }
}

// s[j] = A[ao[j] ..] . B[bo[j] ..] over the head width (row offsets)
template <int DH>
__device__ __forceinline__ void dots4(const float* A, const int ao[4],
                                      const float* Bm, const int bo[4],
                                      float s[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = fmaf(A[ao[j] + d], Bm[bo[j] + d], s[j]);
  }
}

// acc[j] += sum_c Pm[r][c] * V[row(c)][c0 + 8 j], j < DH / 8, with
// row(c) = c, or c - r + TS - 1 (SHIFT: the band row of query r and key
// column c)
template <int DH, bool SHIFT>
__device__ __forceinline__ void tile_acc(const float* Pm, const float* V,
                                         float (&acc)[DH / 8]) {
  constexpr int LD = DH + 1;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 4
  for (int c = 0; c < TS; ++c) {
    const float p = Pm[r * LD + c];
    const float* vr = V + (SHIFT ? c - r + TS - 1 : c) * LD + c0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) acc[j] = fmaf(p, vr[8 * j], acc[j]);
  }
}

// reduce over the 8 lanes that share a row
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float masked(float s, const int* kmask, int b,
                                        int Tn, int j) {
  return (kmask != nullptr && kmask[(size_t)b * Tn + j] == 0) ? NEG_FILL : s;
}

// this block's 32 weights w[r] (shared memory) times rows of X (staged
// tile, DH + 1 stride): out[d] = sum_r w[r] X[r][d], written by threads
// d < dh
template <int DH>
__device__ __forceinline__ void weighted_rows(const float* w, const float* X,
                                              float* out, int dh) {
  if ((int)threadIdx.x < dh) {
    float acc = 0.f;
    for (int r = 0; r < TS; ++r)
      acc = fmaf(w[r], X[r * (DH + 1) + threadIdx.x], acc);
    out[threadIdx.x] = acc;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
relpos_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ ph,
           const float* __restrict__ bu, const float* __restrict__ bv,
           const int* __restrict__ kmask, T* __restrict__ out,
           float* __restrict__ Mo, float* __restrict__ Lo, int Tn, int D,
           int H, int dh, float scale, Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* Qu = smem;                 // [TS][LD]
  float* Qv = Qu + TS * LD;         // [TS][LD]
  float* Ks = Qv + TS * LD;         // [TS][LD]
  float* Vs = Ks + TS * LD;         // [TS][LD]
  float* Ps = Vs + TS * LD;         // [TS][LD]
  float* Bs = Ps + TS * LD;         // [NB][LD] band rows of the tile pair
  const int q0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, qg = q0 + r;
  const int L = 2 * Tn - 1;
  load_quqv<DH>(Qu, Qv, q, bu, bv, b, q0, Tn, D, h, dh, scale);
  int ao[4], ko[4], bo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;
    ao[j] = r * LD;
    ko[j] = c * LD;
    bo[j] = (c - r + TS - 1) * LD;
  }

  float m = -INFINITY, s[4], w[4];
  for (int k0 = 0; k0 < Tn; k0 += TS) {
    __syncthreads();
    load_rows<DH>(Ks, k, b, k0, TS, Tn, D, h, dh);
    load_band<DH>(Bs, ph, k0 - q0 + Tn - TS, NB, L, D, h, dh);
    __syncthreads();
    dots4<DH>(Qu, ao, Ks, ko, s);
    dots4<DH>(Qv, ao, Bs, bo, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + c0 + 8 * j;
      if (kg < Tn) m = fmaxf(m, masked(s[j] + w[j], kmask, b, Tn, kg));
    }
  }
  m = row_max(m);

  float l = 0.f, acc[DH / 8] = {};
  for (int k0 = 0; k0 < Tn; k0 += TS) {
    __syncthreads();
    load_rows<DH>(Ks, k, b, k0, TS, Tn, D, h, dh);
    load_rows<DH>(Vs, v, b, k0, TS, Tn, D, h, dh);
    load_band<DH>(Bs, ph, k0 - q0 + Tn - TS, NB, L, D, h, dh);
    __syncthreads();
    dots4<DH>(Qu, ao, Ks, ko, s);
    dots4<DH>(Qv, ao, Bs, bo, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + c0 + 8 * j;
      float p = 0.f;
      if (kg < Tn && qg < Tn) {
        p = expf(masked(s[j] + w[j], kmask, b, Tn, kg) - m);
        l += p;
        p = round_to<T>(p * dr.keep(b, H, h, qg, Tn, kg));
      }
      Ps[r * LD + c0 + 8 * j] = p;
    }
    __syncthreads();
    tile_acc<DH, false>(Ps, Vs, acc);
  }
  l = row_sum(l);
  if (qg < Tn) {
    T* o = out + ((size_t)b * Tn + qg) * D + h * dh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      if (c0 + 8 * j < dh) o[c0 + 8 * j] = from_f<T>(acc[j] / l);
    if (c0 == 0) {
      Mo[((size_t)b * H + h) * Tn + qg] = m;
      Lo[((size_t)b * H + h) * Tn + qg] = l;
    }
  }
}

// per query tile: D_i = sum_j dp p, then dq = (ds_c k + dW ph) * scale
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ ph,
              const float* __restrict__ bu, const float* __restrict__ bv,
              const int* __restrict__ kmask, const T* __restrict__ g,
              const float* __restrict__ Mi, const float* __restrict__ Li,
              float* __restrict__ Do, T* __restrict__ dq, int Tn, int D,
              int H, int dh, float scale, Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* Qu = smem;
  float* Qv = Qu + TS * LD;
  float* Gs = Qv + TS * LD;
  float* Ks = Gs + TS * LD;
  float* Vs = Ks + TS * LD;
  float* Ps = Vs + TS * LD;
  float* Bs = Ps + TS * LD;         // [NB][LD]
  const int q0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, qg = q0 + r;
  const int L = 2 * Tn - 1;
  const size_t row = ((size_t)b * H + h) * Tn + qg;
  const float m = qg < Tn ? Mi[row] : 0.f;
  const float l = qg < Tn ? Li[row] : 1.f;
  load_quqv<DH>(Qu, Qv, q, bu, bv, b, q0, Tn, D, h, dh, scale);
  load_rows<DH>(Gs, g, b, q0, TS, Tn, D, h, dh);
  int ao[4], ko[4], bo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;
    ao[j] = r * LD;
    ko[j] = c * LD;
    bo[j] = (c - r + TS - 1) * LD;
  }

  float s[4], w[4], dpt[4], di = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    float accu[DH / 8] = {}, accv[DH / 8] = {};
    for (int k0 = 0; k0 < Tn; k0 += TS) {
      __syncthreads();
      load_rows<DH>(Ks, k, b, k0, TS, Tn, D, h, dh);
      load_rows<DH>(Vs, v, b, k0, TS, Tn, D, h, dh);
      load_band<DH>(Bs, ph, k0 - q0 + Tn - TS, NB, L, D, h, dh);
      __syncthreads();
      dots4<DH>(Qu, ao, Ks, ko, s);
      dots4<DH>(Qv, ao, Bs, bo, w);
      dots4<DH>(Gs, ao, Vs, ko, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kg = k0 + c0 + 8 * j;
        float ds = 0.f;
        if (kg < Tn && qg < Tn) {
          const float p =
              expf(masked(s[j] + w[j], kmask, b, Tn, kg) - m) / l;
          const float dp = dpt[j] * dr.keep(b, H, h, qg, Tn, kg);
          if (pass == 0) di += dp * p;
          else ds = round_to<T>(p * (dp - di));
        }
        Ps[r * LD + c0 + 8 * j] = ds;
      }
      if (pass == 1) {
        __syncthreads();
        tile_acc<DH, false>(Ps, Ks, accu);
        tile_acc<DH, true>(Ps, Bs, accv);
      }
    }
    if (pass == 0) {
      di = row_sum(di);
    } else if (qg < Tn) {
      T* o = dq + ((size_t)b * Tn + qg) * D + h * dh;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        if (c0 + 8 * j < dh)
          o[c0 + 8 * j] = from_f<T>((accu[j] + accv[j]) * scale);
      if (c0 == 0) Do[row] = di;
    }
  }
}

// per key tile, over all query tiles: dv = pt_c^T g, dk = ds_c^T qu, and
// this tile's dbu partial round(scale * sum_i ds[i][j]) . k[j]
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ ph,
                const float* __restrict__ bu, const float* __restrict__ bv,
                const int* __restrict__ kmask, const T* __restrict__ g,
                const float* __restrict__ Mi, const float* __restrict__ Li,
                const float* __restrict__ Di, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dbu_part, int Tn,
                int D, int H, int dh, float scale, Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TS * LD;
  float* Qu = Vs + TS * LD;
  float* Qv = Qu + TS * LD;
  float* Gs = Qv + TS * LD;
  float* Ps = Gs + TS * LD;
  float* Bs = Ps + TS * LD;         // [NB][LD]
  float* Ms = Bs + NB * LD;         // [TS] x 3
  float* Ls = Ms + TS;
  float* Ds = Ls + TS;
  const int kt = blockIdx.x, k0 = kt * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, kg = k0 + r;
  const int L = 2 * Tn - 1;
  load_rows<DH>(Ks, k, b, k0, TS, Tn, D, h, dh);
  load_rows<DH>(Vs, v, b, k0, TS, Tn, D, h, dh);
  int ro[4], co[4], bo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;
    ro[j] = r * LD;
    co[j] = c * LD;
    bo[j] = (r - c + TS - 1) * LD;
  }

  float dka[DH / 8] = {}, dva[DH / 8] = {}, s[4], w[4], dpt[4], ds[4];
  float colsum = 0.f;
  for (int q0 = 0; q0 < Tn; q0 += TS) {
    __syncthreads();
    load_quqv<DH>(Qu, Qv, q, bu, bv, b, q0, Tn, D, h, dh, scale);
    load_rows<DH>(Gs, g, b, q0, TS, Tn, D, h, dh);
    load_band<DH>(Bs, ph, k0 - q0 + Tn - TS, NB, L, D, h, dh);
    if (threadIdx.x < TS) {
      const int qq = q0 + threadIdx.x;
      const size_t row = ((size_t)b * H + h) * Tn + qq;
      Ms[threadIdx.x] = qq < Tn ? Mi[row] : 0.f;
      Ls[threadIdx.x] = qq < Tn ? Li[row] : 1.f;
      Ds[threadIdx.x] = qq < Tn ? Di[row] : 0.f;
    }
    __syncthreads();
    dots4<DH>(Ks, ro, Qu, co, s);
    dots4<DH>(Bs, bo, Qv, co, w);
    dots4<DH>(Vs, ro, Gs, co, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j, qg = q0 + c;
      float pt = 0.f;
      ds[j] = 0.f;
      if (qg < Tn && kg < Tn) {
        const float p =
            expf(masked(s[j] + w[j], kmask, b, Tn, kg) - Ms[c]) / Ls[c];
        const float kp = dr.keep(b, H, h, qg, Tn, kg);
        pt = round_to<T>(p * kp);
        const float dsf = p * (dpt[j] * kp - Ds[c]);
        colsum += dsf;
        ds[j] = round_to<T>(dsf);
      }
      Ps[r * LD + c] = pt;
    }
    __syncthreads();
    tile_acc<DH, false>(Ps, Gs, dva);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[r * LD + c0 + 8 * j] = ds[j];
    __syncthreads();
    tile_acc<DH, false>(Ps, Qu, dka);
  }
  colsum = row_sum(colsum);
  if (kg < Tn) {
    const size_t o = ((size_t)b * Tn + kg) * D + h * dh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (c0 + 8 * j >= dh) continue;
      dk[o + c0 + 8 * j] = from_f<T>(dka[j]);
      dv[o + c0 + 8 * j] = from_f<T>(dva[j]);
    }
  }
  __syncthreads();
  if (c0 == 0) Ms[r] = kg < Tn ? round_to<T>(scale * colsum) : 0.f;
  __syncthreads();
  weighted_rows<DH>(Ms, Ks,
                    dbu_part + ((size_t)b * gridDim.x + kt) * D + h * dh, dh);
}

// per tile of band rows m, over the query tiles that reach it:
// dph[m] = sum_i dW[i][m] qv[i] (this utterance's float32 partial) and
// this tile's dbv partial round(scale * sum_i dW[i][m]) . ph[m]
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_band(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ ph,
                const float* __restrict__ bu, const float* __restrict__ bv,
                const int* __restrict__ kmask, const T* __restrict__ g,
                const float* __restrict__ Mi, const float* __restrict__ Li,
                const float* __restrict__ Di, float* __restrict__ dph_part,
                float* __restrict__ dbv_part, int Tn, int D, int H,
                int dh, float scale, Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* Phs = smem;                // [TS][LD] this block's band rows
  float* Qu = Phs + TS * LD;
  float* Qv = Qu + TS * LD;
  float* Gs = Qv + TS * LD;
  float* Ps = Gs + TS * LD;
  float* Ks = Ps + TS * LD;         // [NB][LD] keys j0 .. j0 + 62
  float* Vs = Ks + NB * LD;         // [NB][LD]
  float* Ms = Vs + NB * LD;         // [TS] x 3
  float* Ls = Ms + TS;
  float* Ds = Ls + TS;
  const int mt = blockIdx.x, m0 = mt * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  const int L = 2 * Tn - 1;
  load_band<DH>(Phs, ph, m0, TS, L, D, h, dh);
  // query i meets band row m at key j = m + i - T + 1; key row r + c of
  // the staged key tile for band row r and query column c
  int ro[4], co[4], jo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;
    ro[j] = r * LD;
    co[j] = c * LD;
    jo[j] = (r + c) * LD;
  }
  // queries that reach this band tile: i in [T - m0 - TS, 2T - 2 - m0]
  const int i_lo = Tn - m0 - TS, i_hi = 2 * Tn - 2 - m0;

  float dpha[DH / 8] = {}, s[4], w[4], dpt[4], rowsum = 0.f;
  for (int q0 = 0; q0 < Tn; q0 += TS) {
    if (q0 + TS - 1 < i_lo || q0 > i_hi) continue;     // uniform per block
    const int j0 = m0 + q0 - Tn + 1;
    __syncthreads();
    load_quqv<DH>(Qu, Qv, q, bu, bv, b, q0, Tn, D, h, dh, scale);
    load_rows<DH>(Gs, g, b, q0, TS, Tn, D, h, dh);
    load_rows<DH>(Ks, k, b, j0, NB, Tn, D, h, dh);
    load_rows<DH>(Vs, v, b, j0, NB, Tn, D, h, dh);
    if (threadIdx.x < TS) {
      const int qq = q0 + threadIdx.x;
      const size_t row = ((size_t)b * H + h) * Tn + qq;
      Ms[threadIdx.x] = qq < Tn ? Mi[row] : 0.f;
      Ls[threadIdx.x] = qq < Tn ? Li[row] : 1.f;
      Ds[threadIdx.x] = qq < Tn ? Di[row] : 0.f;
    }
    __syncthreads();
    dots4<DH>(Qu, co, Ks, jo, s);
    dots4<DH>(Qv, co, Phs, ro, w);
    dots4<DH>(Gs, co, Vs, jo, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j, qg = q0 + c, kg = j0 + r + c;
      float ds = 0.f;
      if (qg < Tn && kg >= 0 && kg < Tn) {
        const float p =
            expf(masked(s[j] + w[j], kmask, b, Tn, kg) - Ms[c]) / Ls[c];
        const float dp = dpt[j] * dr.keep(b, H, h, qg, Tn, kg);
        ds = round_to<T>(p * (dp - Ds[c]));
        rowsum += ds;
      }
      Ps[r * LD + c] = ds;
    }
    __syncthreads();
    tile_acc<DH, false>(Ps, Qv, dpha);
  }
  rowsum = row_sum(rowsum);
  const int mg = m0 + r;
  if (mg < L) {
    float* o = dph_part + ((size_t)b * L + mg) * D + h * dh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      if (c0 + 8 * j < dh) o[c0 + 8 * j] = dpha[j];
  }
  __syncthreads();
  if (c0 == 0) Ms[r] = mg < L ? round_to<T>(scale * rowsum) : 0.f;
  __syncthreads();
  weighted_rows<DH>(Ms, Phs,
                    dbv_part + ((size_t)b * gridDim.x + mt) * D + h * dh, dh);
}

__global__ void relpos_bwd_sums(const float* __restrict__ part,
                                float* __restrict__ out, int n_part, int W) {
  sum_parts(part, out, n_part, W);
}

// ---- bf16 backward: the products on the tensor cores --------------------

typedef __nv_bfloat16 bf16;

// The tile geometry: BT = 64 rows a query or key tile, BT / 16 warps of
// 16 rows, the 2 BT band rows a tile pair touches (2 BT - 1 of them), a
// warp's 16 x (BT + 16) float32 position scores at row stride SBW, the dq
// pass's BT x LDW bf16 dW (an odd number of 16-byte units a row:
// conflict-free ldmatrix) and the dk/dv pass's BT x LDP float32 position
// scores.
constexpr int BT = 64;
struct Geo {
  static constexpr int NW = BT / 16, TC = 32 * NW;
  static constexpr int NBAND = 2 * BT, SBW = BT + 20;
  static constexpr int LDW = 2 * BT + 8, LDP = BT + 4;
};
constexpr int SUM_ROWS = 8;     // band rows of a relpos_bwd_band_sums_tc block
constexpr int P_DQ = 1, P_DPH = 2;   // the parts of a dq-pass launch

// rows [t0, t0 + NR) of head h (width dh) of X (rows of D values; row t of
// utterance b at (b * Tn + t) * D) -> S, rows padded to DH + 8 values, by
// 16-byte cp.async copies of NTH threads; zeros outside [0, Tn) and past dh
template <int DH, int NR, int NTH>
__device__ __forceinline__ void stage_tc(bf16* S, const bf16* __restrict__ X,
                                         int b, int t0, int Tn, int D, int h,
                                         int dh) {
  constexpr int CH = DH / 8;
  for (int e = threadIdx.x; e < NR * CH; e += NTH) {
    const int r = e / CH, c = (e - r * CH) * 8, t = t0 + r;
    const bool ok = t >= 0 && t < Tn && c < dh;
    cp_async16(S + r * (DH + 8) + c,
               ok ? X + ((size_t)b * Tn + t) * D + h * dh + c : X, ok);
  }
}

// q staged in Qu (BT rows from q0) -> Qu = round((q + bu) * scale) and Qv =
// round((q + bv) * scale) (_qu_qv), zeros past Tn and past dh; Qv's pad
// column DH is 1 and the rest of its pad 0 (the dph product's extra
// n-tile, which sums each band row of dW)
template <int DH>
__device__ __forceinline__ void fold_quqv(bf16* Qu, bf16* Qv,
                                          const float* __restrict__ bu,
                                          const float* __restrict__ bv,
                                          int q0, int Tn, int h, int dh,
                                          float scale) {
  constexpr int LDS = DH + 8;
  for (int e = threadIdx.x; e < BT * LDS; e += Geo::TC) {
    const int r = e / LDS, d = e - r * LDS;
    if (d >= DH) {
      Qv[e] = __float2bfloat16(d == DH ? 1.f : 0.f);
      continue;
    }
    float u = 0.f, w = 0.f;
    if (q0 + r < Tn && d < dh) {
      const float qf = __bfloat162float(Qu[e]);
      u = (qf + bu[h * dh + d]) * scale;
      w = (qf + bv[h * dh + d]) * scale;
    }
    Qu[e] = __float2bfloat16(u);
    Qv[e] = __float2bfloat16(w);
  }
}

// bit c: key k0 + c (c < BT) exists and the key mask keeps it (warp 0
// writes *kb)
__device__ __forceinline__ void tile_key_bits(unsigned long long* kb,
                                              const int* __restrict__ kmask,
                                              int b, int Tn, int k0) {
  if (threadIdx.x >= 32) return;
  const int k1 = k0 + threadIdx.x, k2 = k1 + 32;
  const bool v1 =
      k1 < Tn && (kmask == nullptr || kmask[(size_t)b * Tn + k1] != 0);
  const bool v2 = k2 < Tn &&
                  (kmask == nullptr || kmask[(size_t)b * Tn + k2] != 0);
  const unsigned lo = __ballot_sync(0xffffffffu, v1);
  const unsigned hi = __ballot_sync(0xffffffffu, v2);
  if (threadIdx.x == 0) *kb = lo | ((unsigned long long)hi << 32);
}

// The position term of a warp's 16 query rows against a (query tile, key
// tile) pair, whose staged band rows Bs start at mb = k0 - q0 + T - BT:
// query row i and key column c meet band row e = c - i + BT - 1. A warp of
// rows 16 w .. + 16 reaches band rows eb .. eb + BT + 16, eb = BT - 16 -
// 16 w; it forms SB = qv ph[mb + eb ..]^T (16 x (BT + 16), Qv its 16
// staged rows of qv) into sbw (row stride SBW) and reads the
// Transformer-XL shift s_pos[r][c] = SB[r][c - r + 15] back with pos_at
// (_rel_shift_band at tile level).
template <int DH>
__device__ __forceinline__ void pos_block(float* sbw, const bf16* Qv,
                                          const bf16* Bs, int eb) {
  constexpr int NT = (BT + 16) / 8, SBW = Geo::SBW;
  const int lane = threadIdx.x & 31, rl = lane >> 2, cl = 2 * (lane & 3);
  float sb[NT][4];
  warp_scores<DH, NT>(sb, Qv, Bs + eb * (DH + 8));
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(sbw + (rl + 8 * hr) * SBW + 8 * n + cl) =
          make_float2(sb[n][2 * hr], sb[n][2 * hr + 1]);
  __syncwarp();
}
__device__ __forceinline__ float pos_at(const float* sbw, int r, int c) {
  return sbw[r * Geo::SBW + c - r + 15];
}

// Runs body(j) for j < n, each after load(j)'s copies have landed: one
// slot per tile (two blocks an SM overlap each other's copies).
template <typename Load, typename Body>
__device__ __forceinline__ void sweep1(int n, Load load, Body body) {
  for (int j = 0; j < n; ++j) {
    load(j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    body(j);
    __syncthreads();
  }
}

// dph rows: acc (2 m-tiles of 16 band rows) += dW^T qv over the tile's BT
// queries, with dW (queries x band rows, row stride LDW) from column A on,
// read transposed; n-tile DH / 8 takes Qv's pad (column DH is 1): the sum
// of each band row of dW.
template <int DH>
__device__ __forceinline__ void dph_rows(float (&acc)[2][DH / 8 + 1][4],
                                         const bf16* A, const bf16* Qv) {
  constexpr int LDS = DH + 8, LDW = Geo::LDW;
  const int lane = threadIdx.x & 31;
  const bf16* pa =
      A + ((lane & 7) + 8 * (lane >> 4)) * LDW + 8 * ((lane >> 3) & 1);
  const bf16* pb =
      Qv + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4);
  const bf16* p1 = Qv + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + DH;
#pragma unroll
  for (int ks = 0; ks < BT / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4_trans(a[mt], pa + 16 * ks * LDW + 16 * mt);
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bq[4];
      ldmatrix_x4_trans(bq, pb + 16 * ks * LDS + 16 * np);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
        mma16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
      }
    }
    uint32_t b1[2];
    ldmatrix_x2_trans(b1, p1 + 16 * ks * LDS);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma16816(acc[mt][DH / 8], a[mt], b1[0], b1[1]);
  }
}

// row r (0 or 1: rows lane / 4 and + 8) of this lane's accumulators times
// x (divided by x: DIV), as bf16 pairs at o + 8 n + its column pair, for
// columns below dh
template <int DH, bool DIV = false>
__device__ __forceinline__ void store_pairs(bf16* o,
                                            const float (&acc)[DH / 8][4],
                                            int r, float x, int cl, int dh) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
    if (8 * n + cl < dh) {
      const float a0 = acc[n][2 * r], a1 = acc[n][2 * r + 1];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
          DIV ? __floats2bfloat162_rn(a0 / x, a1 / x)
              : __floats2bfloat162_rn(a0 * x, a1 * x);
    }
}

// The bf16 forward, one block per (query tile, head, utterance); warp w
// owns query rows 16 w .. + 16. Key tile j (keys k0 = BT j ..), its value
// tile, its 2 BT band rows (from mb = k0 - q0 + T - BT) and its key-mask
// bits stream through a two-slot cp.async ring, so shared memory does not
// depend on T. Per key tile a warp forms its position block (pos_block:
// 16 x (BT + 16) of qv ph^T) and its content scores qu k^T (16 x 32 at a
// time); s = content + s_pos, or finfo(float32).min where the key is
// masked.
// - Sweep 1: each row's exact maximum M over the keys below T.
// - Sweep 2: the same scores again, p = exp(s - M), l += p (before the
//   dropout), acc += round(p keep) v with round(p keep) the bf16 A
//   fragments of the product (to_a: _softmax_fold's rounding point).
// out = round(acc / l); M and l go to Mo, Lo for the backward. A fully
// masked row has M = finfo.min and is uniform over its T keys.
template <int DH>
__global__ void __launch_bounds__(Geo::TC, 2)
relpos_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ ph,
              const float* __restrict__ bu, const float* __restrict__ bv,
              const int* __restrict__ kmask, bf16* __restrict__ out,
              float* __restrict__ Mo, float* __restrict__ Lo, int Tn, int D,
              int H, int dh, float scale, Drop dr) {
  using G = Geo;
  constexpr int LDS = DH + 8, TE = BT * LDS, TC = G::TC;
  constexpr int NBAND = G::NBAND, BE = NBAND * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qu = reinterpret_cast<bf16*>(tc_smem);
  bf16* Qv = Qu + TE;
  bf16* Ks = Qv + TE;                           // 2 slots
  bf16* Vs = Ks + 2 * TE;                       // 2 slots
  bf16* Bs = Vs + 2 * TE;                       // 2 slots of NBAND rows
  float* SB = reinterpret_cast<float*>(Bs + 2 * BE);   // [NW][16][SBW]
  unsigned long long* kb =                      // 2 slots
      reinterpret_cast<unsigned long long*>(SB + G::NW * 16 * G::SBW);
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rl = lane >> 2, cl = 2 * (lane & 3), r0 = q0 + 16 * w + rl;
  const int L = 2 * Tn - 1, nk = (Tn + BT - 1) / BT;
  const int eb = BT - 16 - 16 * w;
  const bool live = q0 + 16 * w < Tn;        // a warp past Tn only stages
  float* sbw = SB + w * 16 * G::SBW;

  stage_tc<DH, BT, TC>(Qu, q, b, q0, Tn, D, h, dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  fold_quqv<DH>(Qu, Qv, bu, bv, q0, Tn, h, dh, scale);

  const auto load_k = [&](int j) {
    const int k0 = j * BT;
    stage_tc<DH, BT, TC>(Ks + (j & 1) * TE, k, b, k0, Tn, D, h, dh);
    stage_tc<DH, NBAND, TC>(Bs + (j & 1) * BE, ph, 0, k0 - q0 + Tn - BT, L,
                            D, h, dh);
    tile_key_bits(kb + (j & 1), kmask, b, Tn, k0);
  };
  // the scores of key columns 32 c .. + 32 of tile j, in s; masked keys
  // finfo.min (keys past Tn are the caller's to skip)
  const auto scores = [&](float (&s)[4][4], int j, int c) {
    warp_scores<DH, 4>(s, Qu + 16 * w * LDS,
                       Ks + (j & 1) * TE + 32 * c * LDS);
    const unsigned long long bits = kb[j & 1];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = 32 * c + 8 * n + cl + (i & 1);
        s[n][i] = (bits >> kc) & 1
                      ? s[n][i] + pos_at(sbw, rl + 8 * (i >> 1), kc)
                      : NEG_FILL;
      }
  };

  // sweep 1: each row's exact maximum
  float m[2] = {-INFINITY, -INFINITY};
  sweep(nk, load_k, [&](int j) {
    if (!live) return;
    pos_block<DH>(sbw, Qv + 16 * w * LDS, Bs + (j & 1) * BE, eb);
#pragma unroll
    for (int c = 0; c < BT / 32; ++c) {
      float s[4][4];
      scores(s, j, c);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j * BT + 32 * c + 8 * n + cl + (i & 1) < Tn)
            m[i >> 1] = fmaxf(m[i >> 1], s[n][i]);
    }
  });
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  // sweep 2: p = exp(s - m), l = sum p, acc += round(p * keep) v
  float acc[DH / 8][4] = {}, l[2] = {0.f, 0.f};
  sweep(
      nk,
      [&](int j) {
        load_k(j);
        stage_tc<DH, BT, TC>(Vs + (j & 1) * TE, v, b, j * BT, Tn, D, h, dh);
      },
      [&](int j) {
        if (!live) return;
        pos_block<DH>(sbw, Qv + 16 * w * LDS, Bs + (j & 1) * BE, eb);
#pragma unroll
        for (int c = 0; c < BT / 32; ++c) {
          float s[4][4];
          scores(s, j, c);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int kg = j * BT + 32 * c + 8 * n + cl + (i & 1);
              float pk = 0.f;
              if (kg < Tn) {
                const float p = __expf(s[n][i] - m[i >> 1]);
                l[i >> 1] += p;
                pk = p * dr.keep(b, H, h, r0 + 8 * (i >> 1), Tn, kg);
              }
              s[n][i] = pk;
            }
          uint32_t pf[2][4];
          to_a(pf, s);
          warp_acc<DH, 2>(acc, pf, Vs + (j & 1) * TE + 32 * c * LDS);
        }
      });
  const size_t st = ((size_t)b * H + h) * Tn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const int row = r0 + 8 * r;
    if (row >= Tn) continue;
    store_pairs<DH, true>(out + ((size_t)b * Tn + row) * D + h * dh + cl, acc,
                          r, den, cl, dh);
    if ((lane & 3) == 0) {
      Mo[st + row] = m[r];
      Lo[st + row] = den;
    }
  }
}

// The dq pass, one block per (query tile, head, utterance); warp w owns
// query rows 16 w .. + 16 of the tile's BT. For key tile j (keys k0 = BT j
// ..) the staged band rows are mb .. mb + 2 BT, mb = k0 - q0 + T - BT:
// query row i and key column c meet band row e = c - i + BT - 1 of them.
// - The position scores: each warp forms its rows' 16 x (BT + 16) block
//   SB = qv ph[mb + eb ..]^T, eb = BT - 16 - 16 w (the band rows its 16
//   rows reach), into shared memory, and reads s_pos[r][c] = SB[r][c - r +
//   15] back at its accumulators' (row, column): the Transformer-XL shift
//   of _rel_shift_band.
// - P_DQ: sweep A sums D_i = sum_j dp p, sweep B forms ds_c = round(p (dp
//   - D_i)) and dq = (ds_c k + dW ph) * scale: ds_c goes into dW (queries x
//   2 BT band rows) at e = c - i + BT - 1 (_rel_unshift_band), and the
//   warp's 16 rows of it (band columns eb .. + BT + 16) times ph's band
//   rows.
// - P_DPH: after sweep B's dW is whole (a block barrier), dph = dW^T qv for
//   the window's 2 BT rows: warp w holds 32 of them. Window j + 1 is window
//   j moved up BT rows, so its lower half is complete after step j: warp
//   w holds window rows (32 w + BT (j & 1)) % 2 BT .. + 32, which follows a
//   row from one window to the next without moving it; the lower half is
//   written out and zeroed after each step, the upper after the last. The
//   rows of a query tile are its float32 partial (rows mb_0 .. mb_0 + BT
//   (nk + 1), mb_0 = T - BT - q0), with each band row's dW sum beside them
//   (Qv's column of ones).
// With both parts in one launch (DH <= 64) sweep B does both; at larger
// widths the accumulators of both do not fit, and a P_DPH launch follows
// the P_DQ one, reading its D_i.
template <int DH, int PART>
__global__ void __launch_bounds__(Geo::TC, 2)
relpos_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ ph,
                 const float* __restrict__ bu, const float* __restrict__ bv,
                 const int* __restrict__ kmask, const bf16* __restrict__ g,
                 const float* __restrict__ Mi, const float* __restrict__ Li,
                 float* __restrict__ Do, bf16* __restrict__ dq,
                 float* __restrict__ dph_part, int Tn, int D, int H, int dh,
                 float scale, Drop dr) {
  using G = Geo;
  constexpr int LDS = DH + 8, TE = BT * LDS, TC = G::TC, NBAND = G::NBAND;
  constexpr int SBW = G::SBW, LDW = G::LDW;
  constexpr bool WANT_DQ = PART & P_DQ, WANT_DPH = PART & P_DPH;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qu = reinterpret_cast<bf16*>(tc_smem);
  bf16* Qv = Qu + TE;
  bf16* Gs = Qv + TE;
  bf16* Ks = Gs + TE;
  bf16* Vs = Ks + TE;
  bf16* Bs = Vs + TE;                           // [NBAND][LDS]
  bf16* Ws = Bs + NBAND * LDS;                  // [BT][LDW] dW
  float* SB = reinterpret_cast<float*>(Ws + BT * LDW);   // [NW][16][SBW]
  unsigned long long* kb =
      reinterpret_cast<unsigned long long*>(SB + G::NW * 16 * SBW);
  const int qt = blockIdx.x, q0 = qt * BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rl = lane >> 2, cl = 2 * (lane & 3), r0 = q0 + 16 * w + rl;
  const int L = 2 * Tn - 1, nk = (Tn + BT - 1) / BT, eb = BT - 16 - 16 * w;
  const size_t st = ((size_t)b * H + h) * Tn;
  const bool live = q0 + 16 * w < Tn;        // a warp past Tn only stages
  const bool ok0 = r0 < Tn, ok1 = r0 + 8 < Tn;
  const float m0 = ok0 ? Mi[st + r0] : 0.f, m1 = ok1 ? Mi[st + r0 + 8] : 0.f;
  const float rl0 = ok0 ? 1.f / Li[st + r0] : 1.f;        // 1 / L
  const float rl1 = ok1 ? 1.f / Li[st + r0 + 8] : 1.f;
  float* sbw = SB + w * 16 * SBW;

  stage_tc<DH, BT, TC>(Qu, q, b, q0, Tn, D, h, dh);
  stage_tc<DH, BT, TC>(Gs, g, b, q0, Tn, D, h, dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  fold_quqv<DH>(Qu, Qv, bu, bv, q0, Tn, h, dh, scale);
  // dW's entries off the band (e outside [BT - 1 - i, 2 BT - 2 - i]) stay
  // zero
  for (int e = threadIdx.x; e < BT * LDW / 2; e += TC)
    reinterpret_cast<uint32_t*>(Ws)[e] = 0u;

  const auto load = [&](int j) {
    const int k0 = j * BT;
    stage_tc<DH, BT, TC>(Ks, k, b, k0, Tn, D, h, dh);
    stage_tc<DH, BT, TC>(Vs, v, b, k0, Tn, D, h, dh);
    stage_tc<DH, NBAND, TC>(Bs, ph, 0, k0 - q0 + Tn - BT, L, D, h, dh);
    tile_key_bits(kb, kmask, b, Tn, k0);
  };
  // this warp's SB = qv ph[mb + eb ..]^T (16 x (BT + 16)) into sbw
  const auto pos_scores = [&]() {
    pos_block<DH>(sbw, Qv + 16 * w * LDS, Bs, eb);
  };
  // p and dp (= (g v^T) * keep) of key columns 32 c .. + 32 of tile j in
  // place of s and dp; zero past Tn
  const auto probs = [&](float (&s)[4][4], float (&dp)[4][4], int j, int c) {
    warp_scores<DH, 4>(s, Qu + 16 * w * LDS, Ks + 32 * c * LDS);
    warp_scores<DH, 4>(dp, Gs + 16 * w * LDS, Vs + 32 * c * LDS);
    const unsigned long long bits = *kb;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = 32 * c + 8 * n + cl + (i & 1), kg = j * BT + kc;
        const int rr = rl + 8 * (i >> 1), row = r0 + 8 * (i >> 1);
        float p = 0.f, d = 0.f;
        if (kg < Tn && row < Tn) {
          const float sc = (bits >> kc) & 1
                               ? s[n][i] + pos_at(sbw, rr, kc)
                               : NEG_FILL;
          p = __expf(sc - (i < 2 ? m0 : m1)) * (i < 2 ? rl0 : rl1);
          d = dp[n][i] * dr.keep(b, H, h, row, Tn, kg);
        }
        s[n][i] = p;
        dp[n][i] = d;
      }
  };

  // sweep A: D_i (or the P_DQ launch's, read back)
  float di0 = 0.f, di1 = 0.f;
  if constexpr (WANT_DQ) {
    sweep1(nk, load, [&](int j) {
      if (!live) return;
      pos_scores();
#pragma unroll
      for (int c = 0; c < BT / 32; ++c) {
        float s[4][4], dp[4][4];
        probs(s, dp, j, c);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          di0 += dp[n][0] * s[n][0] + dp[n][1] * s[n][1];
          di1 += dp[n][2] * s[n][2] + dp[n][3] * s[n][3];
        }
      }
    });
    di0 = quad_sum(di0);
    di1 = quad_sum(di1);
  } else {
    di0 = ok0 ? Do[st + r0] : 0.f;
    di1 = ok1 ? Do[st + r0 + 8] : 0.f;
  }

  // sweep B: ds_c into dW; dq and (or) dph
  float acc[WANT_DQ ? DH / 8 : 1][4] = {};
  float pacc[2][DH / 8 + 1][4] = {};       // unused without P_DPH
  const size_t Lq = (size_t)(nk + 1) * BT;
  float* dpp = dph_part + ((size_t)b * gridDim.x + qt) * Lq * D;
  float* rsp = dph_part + (size_t)gridDim.z * gridDim.x * Lq * D +
               (((size_t)b * gridDim.x + qt) * H + h) * Lq;
  // window rows e0 .. e0 + 32 of step j to the partial (slice rows e +
  // BT j), band rows in [0, L) only
  const auto flush = [&](int j, int e0) {
    const int mb = j * BT - q0 + Tn - BT;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int e = e0 + 16 * mt + rl + 8 * hr, m = mb + e;
        if (m < 0 || m >= L) continue;
        const size_t sr = (size_t)e + BT * j;
        float* o = dpp + sr * D + h * dh + cl;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          if (8 * n + cl < dh)
            *reinterpret_cast<float2*>(o + 8 * n) = make_float2(
                pacc[mt][n][2 * hr], pacc[mt][n][2 * hr + 1]);
        if (cl == 0) rsp[sr] = pacc[mt][DH / 8][2 * hr];
      }
  };
  sweep1(nk, load, [&](int j) {
    if (live) {
      pos_scores();
#pragma unroll
      for (int c = 0; c < BT / 32; ++c) {
        float s[4][4], dp[4][4];
        probs(s, dp, j, c);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[n][i] *= dp[n][i] - (i < 2 ? di0 : di1);        // ds
            const int il = 16 * w + rl + 8 * (i >> 1);
            const int kc = 32 * c + 8 * n + cl + (i & 1);
            Ws[il * LDW + kc - il + BT - 1] = __float2bfloat16(s[n][i]);
          }
        if constexpr (WANT_DQ) {
          uint32_t sf[2][4];
          to_a(sf, s);
          warp_acc<DH, 2>(acc, sf, Ks + 32 * c * LDS);
        }
      }
      if constexpr (WANT_DQ) {
        __syncwarp();
        // acc += dW (this warp's rows, band columns eb .. + BT + 16) times
        // ph's band rows eb ..
        constexpr int KS = (BT + 16) / 16;
        const bf16* pa = Ws + (16 * w + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                  LDW + eb + 8 * (lane >> 4);
        uint32_t af[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(af[ks], pa + 16 * ks);
        warp_acc<DH, KS>(acc, af, Bs + eb * LDS);
      }
    }
    if constexpr (WANT_DPH) {
      __syncthreads();                 // every warp's rows of dW are in
      const int e0 = (32 * w + BT * (j & 1)) & (NBAND - 1);
      dph_rows<DH>(pacc, Ws + e0, Qv);
      if (e0 < BT) {
        flush(j, e0);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n <= DH / 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) pacc[mt][n][i] = 0.f;
      }
    }
  });
  if constexpr (WANT_DPH) {
    const int e0 = (32 * w + BT * ((nk - 1) & 1)) & (NBAND - 1);
    if (e0 >= BT) flush(nk - 1, e0);
  }
  if constexpr (WANT_DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Tn) continue;
      store_pairs<DH>(dq + ((size_t)b * Tn + row) * D + h * dh + cl, acc, r,
                      scale, cl, dh);
      if ((lane & 3) == 0) Do[st + row] = r == 0 ? di0 : di1;
    }
  }
}

// The dk/dv pass, one block per (key tile, head, utterance); warp w owns
// keys 16 w .. + 16 and sweeps the query tiles i0, forming products
// transposed (rows: keys, columns: queries). The staged band rows are
// mb .. mb + 2 BT, mb = k0 - i0 + T - BT; key row r meets query column c
// at band row e = r - c + BT - 1. The position scores: the block forms
// P = ph[mb ..] qv^T (2 BT x BT, warp w rows 32 w .. + 32) and keeps
// P[e][c] at Ps[c][e + c - BT + 1], where it lands on a (key, query) pair;
// warps read s_pos(r, c) = Ps[c][r] after a barrier. Then dv += round(p
// keep)^T g, dk += ds_c^T qu, and each key's float32 sum of ds over the
// queries, for this tile's dbu partial round(scale * sum_i ds[i][j]) .
// k[j].
template <int DH>
__global__ void __launch_bounds__(Geo::TC, 2)
relpos_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ ph,
                   const float* __restrict__ bu, const float* __restrict__ bv,
                   const int* __restrict__ kmask, const bf16* __restrict__ g,
                   const float* __restrict__ Mi, const float* __restrict__ Li,
                   const float* __restrict__ Di, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, float* __restrict__ dbu_part,
                   int Tn, int D, int H, int dh, float scale, Drop dr) {
  using G = Geo;
  constexpr int LDS = DH + 8, TE = BT * LDS, TC = G::TC, NBAND = G::NBAND;
  constexpr int LDP = G::LDP;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + TE;
  bf16* Qu = Vs + TE;
  bf16* Qv = Qu + TE;
  bf16* Gs = Qv + TE;
  bf16* Bs = Gs + TE;                           // [NBAND][LDS]
  float* Ps = reinterpret_cast<float*>(Bs + NBAND * LDS);   // [BT][LDP]
  float* Ss = Ps + BT * LDP;                    // [3][BT]: M, 1 / L, D
  const int kt = blockIdx.x, k0 = kt * BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rl = lane >> 2, cl = 2 * (lane & 3), kr0 = k0 + 16 * w + rl;
  const int L = 2 * Tn - 1, nq = (Tn + BT - 1) / BT;
  const size_t st = ((size_t)b * H + h) * Tn;
  const bool live = k0 + 16 * w < Tn;        // a warp past Tn only stages
  bool kok[2], kmasked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kg = kr0 + 8 * r;
    kok[r] = kg < Tn;
    kmasked[r] = kok[r] && kmask != nullptr && kmask[(size_t)b * Tn + kg] == 0;
  }
  stage_tc<DH, BT, TC>(Ks, k, b, k0, Tn, D, h, dh);  // join step 0's copies
  stage_tc<DH, BT, TC>(Vs, v, b, k0, Tn, D, h, dh);

  float dka[DH / 8][4] = {}, dva[DH / 8][4] = {}, colsum[2] = {0.f, 0.f};
  sweep1(
      nq,
      [&](int t) {
        const int i0 = t * BT;
        stage_tc<DH, BT, TC>(Qu, q, b, i0, Tn, D, h, dh);
        stage_tc<DH, BT, TC>(Gs, g, b, i0, Tn, D, h, dh);
        stage_tc<DH, NBAND, TC>(Bs, ph, 0, k0 - i0 + Tn - BT, L, D, h, dh);
        for (int e = threadIdx.x; e < BT; e += TC) {
          const bool ok = i0 + e < Tn;
          Ss[e] = ok ? Mi[st + i0 + e] : 0.f;
          Ss[BT + e] = ok ? 1.f / Li[st + i0 + e] : 1.f;
          Ss[2 * BT + e] = ok ? Di[st + i0 + e] : 0.f;
        }
      },
      [&](int t) {
        const int i0 = t * BT;
        fold_quqv<DH>(Qu, Qv, bu, bv, i0, Tn, h, dh, scale);
        __syncthreads();
        {
          float ps[2][BT / 8][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            warp_scores<DH, BT / 8>(ps[mt], Bs + (32 * w + 16 * mt) * LDS,
                                    Qv);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int n = 0; n < BT / 8; ++n)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int e = 32 * w + 16 * mt + rl + 8 * (i >> 1);
                const int c = 8 * n + cl + (i & 1), r = e + c - (BT - 1);
                if (r >= 0 && r < BT) Ps[c * LDP + r] = ps[mt][n][i];
              }
        }
        __syncthreads();
        if (!live) return;
#pragma unroll
        for (int c2 = 0; c2 < BT / 32; ++c2) {
          float s[4][4], dp[4][4];
          warp_scores<DH, 4>(s, Ks + 16 * w * LDS, Qu + 32 * c2 * LDS);
          warp_scores<DH, 4>(dp, Vs + 16 * w * LDS, Gs + 32 * c2 * LDS);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int qc = 32 * c2 + 8 * n + cl + (i & 1), qg = i0 + qc;
              const int r = i >> 1, kr = 16 * w + rl + 8 * r;
              float pt = 0.f, ds = 0.f;
              if (qg < Tn && kok[r]) {
                const float sc =
                    kmasked[r] ? NEG_FILL : s[n][i] + Ps[qc * LDP + kr];
                const float p = __expf(sc - Ss[qc]) * Ss[BT + qc];
                const float kp = dr.keep(b, H, h, qg, Tn, kr0 + 8 * r);
                pt = p * kp;
                ds = p * (dp[n][i] * kp - Ss[2 * BT + qc]);
                colsum[r] += ds;
              }
              s[n][i] = pt;
              dp[n][i] = ds;
            }
          uint32_t pf[2][4], sf[2][4];
          to_a(pf, s);
          to_a(sf, dp);
          warp_acc<DH, 2>(dva, pf, Gs + 32 * c2 * LDS);
          warp_acc<DH, 2>(dka, sf, Qu + 32 * c2 * LDS);
        }
      });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float cs = quad_sum(colsum[r]);
    if ((lane & 3) == 0)               // keys past Tn weigh nothing
      Ss[16 * w + rl + 8 * r] =
          kok[r] ? __bfloat162float(__float2bfloat16(scale * cs)) : 0.f;
    if (!kok[r]) continue;
    const size_t o = ((size_t)b * Tn + kr0 + 8 * r) * D + h * dh + cl;
    store_pairs<DH>(dk + o, dka, r, 1.f, cl, dh);
    store_pairs<DH>(dv + o, dva, r, 1.f, cl, dh);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += TC) {
    float a = 0.f;
    for (int r = 0; r < BT; ++r)
      a = fmaf(Ss[r], __bfloat162float(Ks[r * LDS + d]), a);
    dbu_part[((size_t)b * gridDim.x + kt) * D + h * dh + d] = a;
  }
}

// dph[m] = the dq pass's partials of band row m added over the utterances,
// then over the query tiles whose slice holds m (slice row m + q0 - T + BT
// of BT (nk + 1)), in order; dbv_part[blockIdx.x] = sum over the block's
// SUM_ROWS band rows m (in order) and the utterances b of round(scale *
// sum_i dW_b[i][m]) ph[m] (_rel_bwd_kernel's dbv, rounded per utterance
// and head). One thread per (band row, column): SUM_ROWS x 32 a block, so
// that the partials' ~20 MB (at the path's shape) stream with many loads
// in flight.
__global__ void __launch_bounds__(SUM_ROWS * 32)
relpos_bwd_band_sums_tc(const float* __restrict__ part,
                        const bf16* __restrict__ ph, float* __restrict__ dph,
                        float* __restrict__ dbv_part, int B, int Tn, int D,
                        int H, float scale) {
  __shared__ float red[SUM_ROWS][32];
  const int L = 2 * Tn - 1, nk = (Tn + BT - 1) / BT, Lq = (nk + 1) * BT;
  const int rr = threadIdx.x >> 5, cc = threadIdx.x & 31;
  const int m = blockIdx.x * SUM_ROWS + rr, col = blockIdx.y * 32 + cc;
  const float* rs = part + (size_t)B * nk * Lq * D;
  float bacc = 0.f;
  if (m < L && col < D) {
    const int h = col / (D / H);
    // the query tiles whose slice holds m: 0 <= m + BT qt - T + BT < Lq
    const int lo = Tn - BT - m > 0 ? (Tn - BT - m + BT - 1) / BT : 0;
    const int hi = min(nk, (Lq - 1 - m + Tn - BT) / BT + 1);
    const float phv = __bfloat162float(ph[(size_t)m * D + col]);
    float acc = 0.f;
    for (int bb = 0; bb < B; ++bb) {
      float rsum = 0.f;
      for (int qt = lo; qt < hi; ++qt) {
        const int sr = m + qt * BT - Tn + BT;
        const size_t p = (size_t)bb * nk + qt;
        acc += part[(p * Lq + sr) * D + col];
        rsum += rs[(p * H + h) * Lq + sr];
      }
      bacc = fmaf(__bfloat162float(__float2bfloat16(scale * rsum)), phv,
                  bacc);
    }
    dph[(size_t)m * D + col] = acc;
  }
  red[rr][cc] = bacc;
  __syncthreads();
  if (rr == 0 && col < D) {
    float t = 0.f;
    for (int r = 0; r < SUM_ROWS; ++r) t += red[r][cc];
    dbv_part[(size_t)blockIdx.x * D + col] = t;
  }
}

// dynamic shared memory of each kernel at head width DH (float32 rows of
// DH + 1); ops/cuda_attention.py relpos_smem_bytes reckons the largest,
// BAND_SMEM
template <int DH> constexpr size_t row_bytes() {
  return sizeof(float) * (DH + 1);
}
template <int DH> constexpr size_t FWD_SMEM = (5 * TS + NB) * row_bytes<DH>();
template <int DH> constexpr size_t DQ_SMEM = (6 * TS + NB) * row_bytes<DH>();
template <int DH>
constexpr size_t DKDV_SMEM =
    (6 * TS + NB) * row_bytes<DH>() + 3 * TS * sizeof(float);
template <int DH>
constexpr size_t BAND_SMEM =
    (5 * TS + 2 * NB) * row_bytes<DH>() + 3 * TS * sizeof(float);
static_assert(BAND_SMEM<128> <= 227 * 1024, "the widest instance must fit");
// the bf16 passes: five BT-row tiles (q folded into qu and qv, g, k, v;
// the dk/dv pass: k, v, qu, qv, g) and 2 BT band rows, rows of DH + 8
// bf16; the dq pass's dW (BT x LDW bf16), its warps' 16 x SBW float32
// position scores and the key tile's mask bits; the dk/dv pass's BT x LDP
// shifted position scores and the query tile's M, 1 / L, D
template <int DH>
constexpr size_t TC_TILE_BYTES = (size_t)7 * BT * (DH + 8) * 2;
template <int DH>
constexpr size_t DQ_TC_SMEM = TC_TILE_BYTES<DH> +
                              (size_t)BT * Geo::LDW * 2 +
                              (size_t)Geo::NW * 16 * Geo::SBW * 4 + 8;
template <int DH>
constexpr size_t DKDV_TC_SMEM =
    TC_TILE_BYTES<DH> + (size_t)BT * Geo::LDP * 4 + 3 * BT * 4;
static_assert(DQ_TC_SMEM<128> <= 227 * 1024, "the widest instance must fit");
// the bf16 forward: q folded into qu and qv, two slots of k, v and 2 BT
// band rows (rows of DH + 8 bf16), each warp's 16 x SBW float32 position
// scores and two slots of key-mask bits
template <int DH>
constexpr size_t FWD_TC_SMEM = (size_t)(2 + 4 + 4) * BT * (DH + 8) * 2 +
                               (size_t)Geo::NW * 16 * Geo::SBW * 4 + 2 * 8;
static_assert(FWD_TC_SMEM<128> <= 227 * 1024, "the widest must fit");

// the instance that runs head width dh: the smallest of 32, 64, 96, 128
// at least dh, for a positive multiple of 8; 0 otherwise
int instance_of(int dh) {
  if (dh <= 0 || dh % 8 != 0) return 0;
  for (int w : {32, 64, 96, 128})
    if (dh <= w) return w;
  return 0;
}

// fn(std::integral_constant<int, DH>) for the instance of head width dh
template <typename Fn>
int by_width(int dh, Fn fn) {
  switch (instance_of(dh)) {
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DH>
int forward(const void* q, const void* k, const void* v, const void* ph,
            const float* bu, const float* bv, const int* kmask, void* out,
            float* M, float* L, int B, int Tn, int D, int H, int dh,
            float scale, Drop dr, cudaStream_t s) {
  constexpr size_t smem = FWD_SMEM<DH>;
  int err = allow_smem(relpos_fwd<T, DH>, smem);
  if (err) return err;
  relpos_fwd<T, DH><<<dim3((Tn + TS - 1) / TS, H, B), THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ph, bu, bv, kmask,
      (T*)out, M, L, Tn, D, H, dh, scale, dr);
  return (int)cudaGetLastError();
}

// the bf16 forward: relpos_fwd_tc, one launch a call
template <int DH>
int forward_bf16(const void* q, const void* k, const void* v,
                 const void* ph, const float* bu, const float* bv,
                 const int* kmask, void* out, float* M, float* L, int B,
                 int Tn, int D, int H, int dh, float scale, Drop dr,
                 cudaStream_t s) {
  constexpr size_t smem = FWD_TC_SMEM<DH>;
  static SmemSet set;
  int err = (int)sct::allow_smem(relpos_fwd_tc<DH>, smem, set);
  if (err) return err;
  relpos_fwd_tc<DH><<<dim3((Tn + BT - 1) / BT, H, B), Geo::TC, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ph, bu,
      bv, kmask, (bf16*)out, M, L, Tn, D, H, dh, scale, dr);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int backward(const void* q, const void* k, const void* v, const void* ph,
             const float* bu, const float* bv, const int* kmask,
             const void* g, const float* M, const float* L, float* Dsum,
             void* dq, void* dk, void* dv, float* dph_part, float* dbu_part,
             float* dbv_part, float* dph, float* dbu, float* dbv, int B,
             int Tn, int D, int H, int dh, float scale, Drop dr,
             cudaStream_t s) {
  const int nt = (Tn + TS - 1) / TS, Lb = 2 * Tn - 1;
  const int nm = (Lb + TS - 1) / TS;
  constexpr size_t dq_smem = DQ_SMEM<DH>, dkdv_smem = DKDV_SMEM<DH>;
  constexpr size_t band_smem = BAND_SMEM<DH>;
  int err;
  if ((err = allow_smem(relpos_bwd_dq<T, DH>, dq_smem))) return err;
  if ((err = allow_smem(relpos_bwd_dkdv<T, DH>, dkdv_smem))) return err;
  if ((err = allow_smem(relpos_bwd_band<T, DH>, band_smem))) return err;
  relpos_bwd_dq<T, DH><<<dim3(nt, H, B), THREADS, dq_smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ph, bu, bv, kmask,
      (const T*)g, M, L, Dsum, (T*)dq, Tn, D, H, dh, scale, dr);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_dkdv<T, DH><<<dim3(nt, H, B), THREADS, dkdv_smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ph, bu, bv, kmask,
      (const T*)g, M, L, Dsum, (T*)dk, (T*)dv, dbu_part, Tn, D, H, dh, scale,
      dr);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_band<T, DH><<<dim3(nm, H, B), THREADS, band_smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ph, bu, bv, kmask,
      (const T*)g, M, L, Dsum, dph_part, dbv_part, Tn, D, H, dh, scale, dr);
  if ((err = (int)cudaGetLastError())) return err;
  const int W = Lb * D;
  relpos_bwd_sums<<<(W + 255) / 256, 256, 0, s>>>(dph_part, dph, B, W);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_sums<<<(D + 255) / 256, 256, 0, s>>>(dbu_part, dbu, B * nt, D);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_sums<<<(D + 255) / 256, 256, 0, s>>>(dbv_part, dbv, B * nm, D);
  return (int)cudaGetLastError();
}

// Float32 elements of the backward's three scratch buffers, out[0..2]:
// dph_part, dbu_part, dbv_part. float32: per-utterance dph partials (B, L,
// D), then the dbu / dbv partials of each 32-row key / band tile (B *
// ceil(T / 32), D), (B * ceil(L / 32), D). bf16: the dq pass's dph
// partials of each query tile over its BT (nk + 1) band rows (B, nk, BT
// (nk + 1), D), then their band-row sums of dW (B, nk, H, BT (nk + 1));
// dbu partials (B * nk, D); dbv partials (ceil(L / SUM_ROWS), D); nk =
// ceil(T / BT). The dph partials grow as T^2 / BT: 21 MB at B 16, T 199,
// D 256, 4 heads. The entry point refuses shorter buffers;
// ops/cuda_attention.py relpos_bwd_scratch sizes them.
void scratch_need(int dtype, int B, int Tn, int D, int H, long long* out) {
  const long long Lb = 2LL * Tn - 1;
  if (dtype == 0) {
    out[0] = (long long)B * Lb * D;
    out[1] = (long long)B * ((Tn + TS - 1) / TS) * D;
    out[2] = (long long)B * ((Lb + TS - 1) / TS) * D;
    return;
  }
  const long long nk = (Tn + BT - 1) / BT, Lq = (nk + 1) * BT;
  out[0] = (long long)B * nk * Lq * (D + H);
  out[1] = (long long)B * nk * D;
  out[2] = (Lb + SUM_ROWS - 1) / SUM_ROWS * D;
}

// the bf16 backward: the dq pass (with dph, or a second launch for it from
// DH 96), the dk/dv pass, the band sums (dph, dbv partials), then dbu and
// dbv in a fixed order: 5 launches a call up to DH 64, 6 above. The
// scratch as scratch_need lays it out.
template <int DH>
int backward_bf16(const void* q, const void* k, const void* v,
                  const void* ph, const float* bu, const float* bv,
                  const int* kmask, const void* g, const float* M,
                  const float* L, float* Dsum, void* dq, void* dk, void* dv,
                  float* dph_part, float* dbu_part, float* dbv_part,
                  float* dph, float* dbu, float* dbv, int B, int Tn, int D,
                  int H, int dh, float scale, Drop dr, cudaStream_t s) {
  const int nk = (Tn + BT - 1) / BT, Lb = 2 * Tn - 1;
  const int nsum = (Lb + SUM_ROWS - 1) / SUM_ROWS;
  const dim3 grid(nk, H, B);
  constexpr int TC = Geo::TC;
  constexpr size_t dq_smem = DQ_TC_SMEM<DH>;
  constexpr size_t dkdv_smem = DKDV_TC_SMEM<DH>;
  const auto dq_pass = [&](auto part) {
    constexpr int PART = decltype(part)::value;
    static SmemSet set;
    int err = (int)sct::allow_smem(relpos_bwd_dq_tc<DH, PART>, dq_smem, set);
    if (err) return err;
    relpos_bwd_dq_tc<DH, PART><<<grid, TC, dq_smem, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ph, bu,
        bv, kmask, (const bf16*)g, M, L, Dsum, (bf16*)dq, dph_part, Tn, D, H,
        dh, scale, dr);
    return (int)cudaGetLastError();
  };
  int err;
  if constexpr (DH <= 64) {
    if ((err = dq_pass(std::integral_constant<int, P_DQ | P_DPH>{})))
      return err;
  } else {
    if ((err = dq_pass(std::integral_constant<int, P_DQ>{}))) return err;
    if ((err = dq_pass(std::integral_constant<int, P_DPH>{}))) return err;
  }
  static SmemSet dkdv_set;
  if ((err = (int)sct::allow_smem(relpos_bwd_dkdv_tc<DH>, dkdv_smem,
                                  dkdv_set)))
    return err;
  relpos_bwd_dkdv_tc<DH><<<grid, TC, dkdv_smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ph, bu,
      bv, kmask, (const bf16*)g, M, L, Dsum, (bf16*)dk, (bf16*)dv, dbu_part,
      Tn, D, H, dh, scale, dr);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_band_sums_tc<<<dim3(nsum, (D + 31) / 32), SUM_ROWS * 32, 0, s>>>(
      dph_part, (const bf16*)ph, dph, dbv_part, B, Tn, D, H, scale);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_sums<<<(D + 255) / 256, 256, 0, s>>>(dbu_part, dbu, B * nk, D);
  if ((err = (int)cudaGetLastError())) return err;
  relpos_bwd_sums<<<(D + 255) / 256, 256, 0, s>>>(dbv_part, dbv, nsum, D);
  return (int)cudaGetLastError();
}

// the head width of a launch; 0 unless D = H * dh with dh a width some
// instance runs
int head_width(int D, int H) {
  if (H <= 0 || D % H != 0) return 0;
  return instance_of(D / H) ? D / H : 0;
}

}  // namespace

// dtype: 0 = float32 (relpos_fwd, the FMA units), 1 = bfloat16
// (relpos_fwd_tc, the tensor cores). kmask may be null. D / H is the head
// width: a multiple of 8 up to 128. M, L (B, H, T) float32 receive each
// row's maximum and denominator.
extern "C" int relpos_attention_forward(
    const void* q, const void* k, const void* v, const void* ph,
    const float* bu, const float* bv, const int* kmask, void* out, float* M,
    float* L, int B, int Tn, int D, int H, float scale, int dtype,
    int drop_on, unsigned int seed, unsigned int thresh, float dscale,
    void* stream) {
  const Drop dr{drop_on, seed, thresh, dscale};
  cudaStream_t s = (cudaStream_t)stream;
  const int dh = head_width(D, H);
  if (!dh || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    return dtype == 0
               ? forward<float, DH>(q, k, v, ph, bu, bv, kmask, out, M, L, B,
                                    Tn, D, H, dh, scale, dr, s)
               : forward_bf16<DH>(q, k, v, ph, bu, bv, kmask, out, M, L, B,
                                  Tn, D, H, dh, scale, dr, s);
  });
}

// g: output cotangent (B, T, D); Dsum (B, H, T) float32 scratch; dq, dk,
// dv (B, T, D) in the compute dtype; dph_part, dbu_part, dbv_part float32
// scratch of n_dph, n_dbu, n_dbv elements, at least what
// relpos_attention_scratch says (cudaErrorInvalidValue otherwise); dph
// (L, D), dbu, dbv (D,) float32 results.
extern "C" int relpos_attention_backward(
    const void* q, const void* k, const void* v, const void* ph,
    const float* bu, const float* bv, const int* kmask, const void* g,
    const float* M, const float* L, float* Dsum, void* dq, void* dk,
    void* dv, float* dph_part, float* dbu_part, float* dbv_part, float* dph,
    float* dbu, float* dbv, long long n_dph, long long n_dbu,
    long long n_dbv, int B, int Tn, int D, int H, float scale, int dtype,
    int drop_on, unsigned int seed, unsigned int thresh, float dscale,
    void* stream) {
  const Drop dr{drop_on, seed, thresh, dscale};
  cudaStream_t s = (cudaStream_t)stream;
  const int dh = head_width(D, H);
  if (!dh || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  long long need[3];
  scratch_need(dtype, B, Tn, D, H, need);
  if (n_dph < need[0] || n_dbu < need[1] || n_dbv < need[2])
    return (int)cudaErrorInvalidValue;
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    if (dtype == 0)
      return backward<float, DH>(q, k, v, ph, bu, bv, kmask, g, M, L, Dsum,
                                 dq, dk, dv, dph_part, dbu_part, dbv_part,
                                 dph, dbu, dbv, B, Tn, D, H, dh, scale, dr,
                                 s);
    return backward_bf16<DH>(q, k, v, ph, bu, bv, kmask, g, M, L, Dsum, dq,
                             dk, dv, dph_part, dbu_part, dbv_part, dph, dbu,
                             dbv, B, Tn, D, H, dh, scale, dr, s);
  });
}

// The backward's scratch for a call (dtype 0 = float32, 1 = bfloat16):
// out[0..2] the float32 elements of dph_part, dbu_part, dbv_part
// (scratch_need); ops/cuda_attention.py relpos_bwd_scratch reckons the
// same without a card, and the smoke run holds the two equal.
extern "C" int relpos_attention_scratch(int dtype, int B, int Tn, int D,
                                        int H, long long* out) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || Tn <= 0 || !head_width(D, H))
    return (int)cudaErrorInvalidValue;
  scratch_need(dtype, B, Tn, D, H, out);
  return 0;
}

// Shared memory each kernel of a dtype's route takes at head width dh,
// static plus dynamic: out[0] the forward, out[1] the dq pass, out[2] the
// dk/dv pass, out[3] the float32 route's dph pass (0 in bf16, whose band
// sums take none). ops/cuda_attention.py relpos_kernel_smem reckons the
// same without a card; the smoke run holds the two equal.
extern "C" int relpos_attention_smem(int dtype, int dh, long long* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    int err;
    if (dtype == 0) {
      if ((err = smem_of(relpos_fwd<float, DH>, FWD_SMEM<DH>, out))) return err;
      if ((err = smem_of(relpos_bwd_dq<float, DH>, DQ_SMEM<DH>, out + 1)))
        return err;
      if ((err = smem_of(relpos_bwd_dkdv<float, DH>, DKDV_SMEM<DH>,
                         out + 2)))
        return err;
      return (int)smem_of(relpos_bwd_band<float, DH>, BAND_SMEM<DH>, out + 3);
    }
    if ((err = smem_of(relpos_fwd_tc<DH>, FWD_TC_SMEM<DH>, out))) return err;
    constexpr int PART = DH <= 64 ? (P_DQ | P_DPH) : P_DQ;
    if ((err = smem_of(relpos_bwd_dq_tc<DH, PART>, DQ_TC_SMEM<DH>, out + 1)))
      return err;
    out[3] = 0;
    return (int)smem_of(relpos_bwd_dkdv_tc<DH>, DKDV_TC_SMEM<DH>, out + 2);
  });
}
