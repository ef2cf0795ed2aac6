// Standard multi-head attention for Hopper (sm_90a), forward and backward.
//
// Replaces speechain_tpu/ops/pallas_attention.py::flash_attention: the
// forward pl.pallas_call at :353 (body _std_fwd_kernel :250) and the
// backward at :384 (body _std_bwd_kernel :271):
//     s = (q k^T) * scale, key-masked and optionally causal (masked scores
//         are finfo(float32).min, so a fully masked row is uniform),
//     p = exp(s - max), den = sum p, o = (round(p * dropmask) v) / den.
// q (B, Tq, D), k/v (B, Tk, D) in their projection layout: head h is the
// column slice [h * 64, (h + 1) * 64), so nothing is transposed.
//
// Layout of the work: one block per (query tile of 32, head, utterance) in
// the forward and the dq pass, one block per (key tile of 32, head,
// utterance) in the dk/dv pass; 256 threads, each owning one row of a
// 32 x 32 score tile (4 columns) and 8 of the 64 head dimensions of that
// row's output. Tiles of q, k, v and the output cotangent are staged in
// shared memory as float32 with a padded row (65 floats), so the score and
// accumulation loops are free of bank conflicts.
//
// The forward runs two passes over the key tiles: the first finds each
// row's exact maximum, the second forms p relative to it. p is then rounded
// to the compute dtype at the TPU kernel's point (before p v, after the
// dropout mask) instead of relative to a running maximum, and no (T, T)
// tensor reaches device memory, with no cap on T. The row maximum and
// denominator are kept for the backward. The backward is deterministic
// without atomics: the dq pass computes D_i = sum_k dp * p per query and
// then dq; the dk/dv pass loops over all query tiles for its key tile.
// Dropout bits: common.cuh::dropout_bits, stream seed + b * H + h, element
// q * Tk + k, as the TPU kernel's interpret mode.
//
// What bounds it on the H100: at transformer-wide training (B = 16, T = 199,
// 8 heads of 64) a forward is ~1.3 GFLOP of products on ~6.5 MB of q/k/v/o,
// so the operations; it runs on the FMA units in float32.

#include <float.h>

#include "common.cuh"

namespace {

using namespace sct;

constexpr int DH = 64;        // head width
constexpr int TS = 32;        // rows of a query or key tile
constexpr int LD = DH + 1;    // padded row of a staged tile
constexpr float NEG_FILL = -FLT_MAX;   // finfo(float32).min

struct Drop {
  int on;
  unsigned int seed, thresh;
  float scale;
};

// rows [t0, t0 + TS) of head h of X (B, T, D) -> S[TS][LD] float, zeros
// past T
template <typename T>
__device__ __forceinline__ void load_tile(float* S, const T* __restrict__ X,
                                          int b, int t0, int Tn, int D,
                                          int h) {
  for (int e = threadIdx.x; e < TS * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, t = t0 + r;
    S[r * LD + d] =
        t < Tn ? to_f(X[((size_t)b * Tn + t) * D + h * DH + d]) : 0.f;
  }
}

// s[j] = A[r] . Bm[c0 + 8 j] over the head width; r = tid / 8, c0 = tid % 8
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          float s[4]) {
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float a = A[r * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = fmaf(a, Bm[(c0 + 8 * j) * LD + d], s[j]);
  }
}

// acc[j] += sum_c Pm[r][c] * V[c][c0 + 8 j]
__device__ __forceinline__ void tile_acc(const float* Pm, const float* V,
                                         float acc[8]) {
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 4
  for (int c = 0; c < TS; ++c) {
    const float p = Pm[r * LD + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, V[c * LD + c0 + 8 * j], acc[j]);
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

// scaled, masked score of (query qg, key kg)
__device__ __forceinline__ float masked(float dot, float scale,
                                        const int* kmask, int b, int Tk,
                                        int qg, int kg, int causal) {
  float s = dot * scale;
  if (kmask != nullptr && kmask[(size_t)b * Tk + kg] == 0) s = NEG_FILL;
  if (causal && kg > qg) s = NEG_FILL;
  return s;
}

__device__ __forceinline__ float keep(const Drop& dr, int b, int H, int h,
                                      int qg, int Tk, int kg) {
  if (!dr.on) return 1.f;
  return dropout_keep((unsigned int)qg * (unsigned int)Tk + (unsigned int)kg,
                      dr.seed + (unsigned int)(b * H + h), dr.thresh,
                      dr.scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ kmask,
          T* __restrict__ out, float* __restrict__ Mo, float* __restrict__ Lo,
          int Tq, int Tk, int D, int H, float scale, int causal, Drop dr) {
  __shared__ float Qs[TS * LD], Ks[TS * LD], Vs[TS * LD], Ps[TS * LD];
  const int q0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, qg = q0 + r;
  load_tile(Qs, q, b, q0, Tq, D, h);

  float m = -INFINITY, s[4];
  for (int k0 = 0; k0 < Tk; k0 += TS) {
    __syncthreads();
    load_tile(Ks, k, b, k0, Tk, D, h);
    __syncthreads();
    tile_dots(Qs, Ks, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + c0 + 8 * j;
      if (kg < Tk)
        m = fmaxf(m, masked(s[j], scale, kmask, b, Tk, qg, kg, causal));
    }
  }
  m = row_max(m);

  float l = 0.f, acc[8] = {};
  for (int k0 = 0; k0 < Tk; k0 += TS) {
    __syncthreads();
    load_tile(Ks, k, b, k0, Tk, D, h);
    load_tile(Vs, v, b, k0, Tk, D, h);
    __syncthreads();
    tile_dots(Qs, Ks, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + c0 + 8 * j;
      float p = 0.f;
      if (kg < Tk) {
        p = expf(masked(s[j], scale, kmask, b, Tk, qg, kg, causal) - m);
        l += p;
        p = round_to<T>(p * keep(dr, b, H, h, qg, Tk, kg));
      }
      Ps[r * LD + c0 + 8 * j] = p;
    }
    __syncthreads();
    tile_acc(Ps, Vs, acc);
  }
  l = row_sum(l);
  if (qg < Tq) {
    T* o = out + ((size_t)b * Tq + qg) * D + h * DH;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[c0 + 8 * j] = from_f<T>(acc[j] / l);
    if (c0 == 0) {
      Mo[((size_t)b * H + h) * Tq + qg] = m;
      Lo[((size_t)b * H + h) * Tq + qg] = l;
    }
  }
}

// dq = (ds_c k) * scale per query tile; also D_i = sum_k dp * p
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kmask,
             const T* __restrict__ g, const float* __restrict__ Mi,
             const float* __restrict__ Li, float* __restrict__ Do,
             T* __restrict__ dq, int Tq, int Tk, int D, int H, float scale,
             int causal, Drop dr) {
  __shared__ float Qs[TS * LD], Gs[TS * LD], Ks[TS * LD], Vs[TS * LD],
      Ps[TS * LD];
  const int q0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, qg = q0 + r;
  const size_t row = ((size_t)b * H + h) * Tq + qg;
  const float m = qg < Tq ? Mi[row] : 0.f;
  const float l = qg < Tq ? Li[row] : 1.f;
  load_tile(Qs, q, b, q0, Tq, D, h);
  load_tile(Gs, g, b, q0, Tq, D, h);

  float s[4], dpt[4], di = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    float acc[8] = {};
    for (int k0 = 0; k0 < Tk; k0 += TS) {
      __syncthreads();
      load_tile(Ks, k, b, k0, Tk, D, h);
      load_tile(Vs, v, b, k0, Tk, D, h);
      __syncthreads();
      tile_dots(Qs, Ks, s);
      tile_dots(Gs, Vs, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kg = k0 + c0 + 8 * j;
        float ds = 0.f;
        if (kg < Tk && qg < Tq) {
          const float p =
              expf(masked(s[j], scale, kmask, b, Tk, qg, kg, causal) - m) / l;
          const float dp = dpt[j] * keep(dr, b, H, h, qg, Tk, kg);
          if (pass == 0) di += dp * p;
          else ds = round_to<T>(p * (dp - di));
        }
        Ps[r * LD + c0 + 8 * j] = ds;
      }
      if (pass == 1) {
        __syncthreads();
        tile_acc(Ps, Ks, acc);
      }
    }
    if (pass == 0) {
      di = row_sum(di);
    } else if (qg < Tq) {
      T* o = dq + ((size_t)b * Tq + qg) * D + h * DH;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[c0 + 8 * j] = from_f<T>(acc[j] * scale);
      if (c0 == 0) Do[row] = di;
    }
  }
}

// dv = p~_c^T g and dk = (ds_c^T q) * scale per key tile
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kmask,
               const T* __restrict__ g, const float* __restrict__ Mi,
               const float* __restrict__ Li, const float* __restrict__ Di,
               T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int D,
               int H, float scale, int causal, Drop dr) {
  __shared__ float Ks[TS * LD], Vs[TS * LD], Qs[TS * LD], Gs[TS * LD],
      Ps[TS * LD];
  __shared__ float Ms[TS], Ls[TS], Ds[TS];
  const int k0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, kg = k0 + r;
  load_tile(Ks, k, b, k0, Tk, D, h);
  load_tile(Vs, v, b, k0, Tk, D, h);

  float dka[8] = {}, dva[8] = {}, s[4], dpt[4], ds[4];
  for (int q0 = 0; q0 < Tq; q0 += TS) {
    __syncthreads();
    load_tile(Qs, q, b, q0, Tq, D, h);
    load_tile(Gs, g, b, q0, Tq, D, h);
    if (threadIdx.x < TS) {
      const int qq = q0 + threadIdx.x;
      const size_t row = ((size_t)b * H + h) * Tq + qq;
      Ms[threadIdx.x] = qq < Tq ? Mi[row] : 0.f;
      Ls[threadIdx.x] = qq < Tq ? Li[row] : 1.f;
      Ds[threadIdx.x] = qq < Tq ? Di[row] : 0.f;
    }
    __syncthreads();
    tile_dots(Ks, Qs, s);
    tile_dots(Vs, Gs, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j, qg = q0 + c;
      float pt = 0.f;
      ds[j] = 0.f;
      if (qg < Tq && kg < Tk) {
        const float p =
            expf(masked(s[j], scale, kmask, b, Tk, qg, kg, causal) - Ms[c]) /
            Ls[c];
        const float kp = keep(dr, b, H, h, qg, Tk, kg);
        pt = round_to<T>(p * kp);
        ds[j] = round_to<T>(p * (dpt[j] * kp - Ds[c]));
      }
      Ps[r * LD + c] = pt;
    }
    __syncthreads();
    tile_acc(Ps, Gs, dva);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[r * LD + c0 + 8 * j] = ds[j];
    __syncthreads();
    tile_acc(Ps, Qs, dka);
  }
  if (kg < Tk) {
    const size_t o = ((size_t)b * Tk + kg) * D + h * DH;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dk[o + c0 + 8 * j] = from_f<T>(dka[j] * scale);
      dv[o + c0 + 8 * j] = from_f<T>(dva[j]);
    }
  }
}

template <typename T>
int forward(const void* q, const void* k, const void* v, const int* kmask,
            void* out, float* M, float* L, int B, int Tq, int Tk, int D,
            int H, float scale, int causal, Drop dr, cudaStream_t s) {
  const dim3 grid((Tq + TS - 1) / TS, H, B);
  flash_fwd<T><<<grid, THREADS, 0, s>>>((const T*)q, (const T*)k,
                                        (const T*)v, kmask, (T*)out, M, L, Tq,
                                        Tk, D, H, scale, causal, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const int* kmask,
             const void* g, const float* M, const float* L, float* Dsum,
             void* dq, void* dk, void* dv, int B, int Tq, int Tk, int D,
             int H, float scale, int causal, Drop dr, cudaStream_t s) {
  flash_bwd_dq<T><<<dim3((Tq + TS - 1) / TS, H, B), THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, kmask, (const T*)g, M, L, Dsum,
      (T*)dq, Tq, Tk, D, H, scale, causal, dr);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dkdv<T><<<dim3((Tk + TS - 1) / TS, H, B), THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, kmask, (const T*)g, M, L, Dsum,
      (T*)dk, (T*)dv, Tq, Tk, D, H, scale, causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kmask (B, Tk) int32 or null. M, L
// (B, H, Tq) float32 receive each row's maximum and denominator.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, const int* kmask, void* out,
    float* M, float* L, int B, int Tq, int Tk, int D, int H, float scale,
    int causal, int dtype, int drop_on, unsigned int seed,
    unsigned int thresh, float dscale, void* stream) {
  const Drop dr{drop_on, seed, thresh, dscale};
  cudaStream_t s = (cudaStream_t)stream;
  if (D != H * DH) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return forward<float>(q, k, v, kmask, out, M, L, B, Tq, Tk, D, H, scale,
                          causal, dr, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(q, k, v, kmask, out, M, L, B, Tq, Tk, D, H,
                                  scale, causal, dr, s);
  return (int)cudaErrorInvalidValue;
}

// g: output cotangent (B, Tq, D); Dsum (B, H, Tq) float32 scratch; dq
// (B, Tq, D), dk/dv (B, Tk, D) in the compute dtype.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const int* kmask,
    const void* g, const float* M, const float* L, float* Dsum, void* dq,
    void* dk, void* dv, int B, int Tq, int Tk, int D, int H, float scale,
    int causal, int dtype, int drop_on, unsigned int seed,
    unsigned int thresh, float dscale, void* stream) {
  const Drop dr{drop_on, seed, thresh, dscale};
  cudaStream_t s = (cudaStream_t)stream;
  if (D != H * DH) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return backward<float>(q, k, v, kmask, g, M, L, Dsum, dq, dk, dv, B, Tq,
                           Tk, D, H, scale, causal, dr, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(q, k, v, kmask, g, M, L, Dsum, dq, dk, dv,
                                   B, Tq, Tk, D, H, scale, causal, dr, s);
  return (int)cudaErrorInvalidValue;
}
