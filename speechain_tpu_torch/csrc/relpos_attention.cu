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
// One block per (query tile of 32, head, utterance); key tiles of 32 and
// the 63 band rows that a (query tile, key tile) pair touches stream
// through shared memory, so shared memory does not grow with T. As in
// csrc/flash_attention.cu, a first pass over the key tiles finds each
// row's exact maximum, so p is rounded to the compute dtype at the TPU
// kernel's point; the row maximum M and denominator L are kept for the
// backward.
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
// Three passes, deterministic without atomics:
//   relpos_bwd_dq   one block per query tile: D_i = rowsum(dp p), then dq;
//   relpos_bwd_dkdv one block per key tile, looping over query tiles:
//                   dk, dv and the key-column sums of ds (dbu partials);
//   relpos_bwd_band one block per tile of 32 band rows m, looping over
//                   query tiles: dph (per-utterance float32 partials) and
//                   the band-column sums of dW (dbv partials).
// relpos_bwd_sums then adds the partials over utterances and tiles in a
// fixed order. Each pass recomputes the scores it needs from q, k, ph.
// Dropout bits: common.cuh::dropout_bits, stream seed + b * H + h, element
// i * T + j, as the TPU kernel's interpret mode.
//
// Head widths: the kernels are templates on their head width DH, built at
// DH = 32, 64, 96 and 128 (every conformer recipe has 64). A width up to
// 128 that is a multiple of 8 runs the smallest instance DH >= Dh, its
// columns past Dh staged as zeros and left unwritten; any other width is
// refused (cudaErrorInvalidValue; the wrapper raises first). A block's
// largest shared memory, the dph pass's, is 149 KB at DH 128.
//
// What bounds it on the H100: at conformer-small training (B = 16,
// T = 199, 4 heads of 64) a forward is ~1.5 GFLOP of products on ~7 MB of
// q/k/v/ph/out, so the operations; all products run on the FMA units in
// float32 (tensor cores are later work).

#include <float.h>

#include <initializer_list>
#include <type_traits>

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

// the head width of a launch; 0 unless D = H * dh with dh a width some
// instance runs
int head_width(int D, int H) {
  if (H <= 0 || D % H != 0) return 0;
  return instance_of(D / H) ? D / H : 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kmask may be null. D / H is the head
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
               : forward<__nv_bfloat16, DH>(q, k, v, ph, bu, bv, kmask, out,
                                            M, L, B, Tn, D, H, dh, scale, dr,
                                            s);
  });
}

// g: output cotangent (B, T, D); Dsum (B, H, T) float32 scratch; dq, dk,
// dv (B, T, D) in the compute dtype; dph_part (B, L, D), dbu_part
// (B * ceil(T/32), D), dbv_part (B * ceil(L/32), D) float32 scratch; dph
// (L, D), dbu, dbv (D,) float32 results.
extern "C" int relpos_attention_backward(
    const void* q, const void* k, const void* v, const void* ph,
    const float* bu, const float* bv, const int* kmask, const void* g,
    const float* M, const float* L, float* Dsum, void* dq, void* dk,
    void* dv, float* dph_part, float* dbu_part, float* dbv_part, float* dph,
    float* dbu, float* dbv, int B, int Tn, int D, int H, float scale,
    int dtype, int drop_on, unsigned int seed, unsigned int thresh,
    float dscale, void* stream) {
  const Drop dr{drop_on, seed, thresh, dscale};
  cudaStream_t s = (cudaStream_t)stream;
  const int dh = head_width(D, H);
  if (!dh || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    return dtype == 0
               ? backward<float, DH>(q, k, v, ph, bu, bv, kmask, g, M, L,
                                     Dsum, dq, dk, dv, dph_part, dbu_part,
                                     dbv_part, dph, dbu, dbv, B, Tn, D, H,
                                     dh, scale, dr, s)
               : backward<__nv_bfloat16, DH>(
                     q, k, v, ph, bu, bv, kmask, g, M, L, Dsum, dq, dk, dv,
                     dph_part, dbu_part, dbv_part, dph, dbu, dbv, B, Tn, D,
                     H, dh, scale, dr, s);
  });
}
