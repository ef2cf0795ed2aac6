// Transformer-XL relative-position multi-head attention for Hopper (sm_90a),
// forward.
//
// Replaces speechain_tpu/ops/pallas_attention.py::flash_relpos_attention
// (pl.pallas_call at :722, body _rel_fwd_kernel at :482).
//
// Layout as on the TPU: q, k, v (B, T, D) with heads as column slices of
// width DH; ph (2T-1, D) the projected relative positions [T-1 .. -(T-1)];
// bu, bv (D,) float32 (pos_bias_u / pos_bias_v flattened); key mask (B, T)
// int32 or null.
//
// One block owns (utterance b, head h, TQ query rows i0..i0+TQ-1):
//   qu = round((q + bu) * scale), qv = round((q + bv) * scale)  (float32
//   fold, rounded to the compute dtype, as _qu_qv does);
//   W[i][r] = qv[i] . ph[r + base] over the TQ + T - 1 band rows that the
//   tile touches; the relative shift is index arithmetic:
//   bd[i][j] = W[i][j - i + T - 1] (rel_shift, nn/attention.py:270-282);
//   s = qu . k + bd, masked keys = finfo(float32).min (a fully masked row
//   gives a finite uniform softmax);
//   p = exp(s - max), den = sum p; out = (round(p) . v) / den.
// The full key row (K^T, V) and the band live in shared memory in the
// compute dtype; scores never reach device memory.

#include "common.cuh"

namespace {

using namespace sct;

constexpr int DH = 64;         // head width (ops/cuda_attention.py checks)
constexpr int TQ = 32;         // query rows per block
constexpr float NEG_FILL = -3.4028234663852886e38f;   // finfo(float32).min

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ ph,
              const float* __restrict__ bu, const float* __restrict__ bv,
              const int* __restrict__ kmask, T* __restrict__ out, int Tn,
              int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int RB = Tn + TQ - 1;                   // band rows for this tile
  float* qu = smem;                             // [TQ][DH]
  float* qv = qu + TQ * DH;                     // [TQ][DH]
  float* W = qv + TQ * DH;                      // [TQ][RB]
  float* S = W + TQ * RB;                       // [TQ][Tn]
  float* den = S + TQ * Tn;                     // [TQ]
  T* Kt = reinterpret_cast<T*>(den + TQ);       // [DH][Tn]
  T* band = Kt + DH * Tn;                       // [DH][RB], later V [Tn][DH]

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const size_t row_base = (size_t)b * Tn;
  const int col0 = h * DH;
  const int base = Tn - TQ - i0;                // ph row of band row 0

  for (int idx = tid; idx < TQ * DH; idx += THREADS) {
    const int li = idx / DH, d = idx - li * DH;
    const int i = i0 + li;
    float u = 0.f, w = 0.f;
    if (i < Tn) {
      const float qf = to_f(q[(row_base + i) * D + col0 + d]);
      u = round_to<T>((qf + bu[col0 + d]) * scale);
      w = round_to<T>((qf + bv[col0 + d]) * scale);
    }
    qu[idx] = u;
    qv[idx] = w;
  }
  for (int idx = tid; idx < Tn * DH; idx += THREADS) {
    const int j = idx / DH, d = idx - j * DH;
    Kt[d * Tn + j] = k[(row_base + j) * D + col0 + d];
  }
  for (int idx = tid; idx < RB * DH; idx += THREADS) {
    const int r = idx / DH, d = idx - r * DH;
    const int p = r + base;
    band[d * RB + r] =
        (p >= 0 && p <= 2 * Tn - 2) ? ph[(size_t)p * D + col0 + d]
                                    : from_f<T>(0.f);
  }
  __syncthreads();

  // W = qv . band^T: one band row per thread, all TQ queries
  for (int r = tid; r < RB; r += THREADS) {
    float acc[TQ];
#pragma unroll
    for (int li = 0; li < TQ; ++li) acc[li] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float b0 = to_f(band[(d + 0) * RB + r]);
      const float b1 = to_f(band[(d + 1) * RB + r]);
      const float b2 = to_f(band[(d + 2) * RB + r]);
      const float b3 = to_f(band[(d + 3) * RB + r]);
#pragma unroll
      for (int li = 0; li < TQ; ++li) {
        const float4 qq = *reinterpret_cast<const float4*>(qv + li * DH + d);
        acc[li] = fmaf(qq.x, b0, acc[li]);
        acc[li] = fmaf(qq.y, b1, acc[li]);
        acc[li] = fmaf(qq.z, b2, acc[li]);
        acc[li] = fmaf(qq.w, b3, acc[li]);
      }
    }
#pragma unroll
    for (int li = 0; li < TQ; ++li) W[li * RB + r] = acc[li];
  }
  __syncthreads();

  // V replaces the band; scores s = qu . k + shifted W
  T* Vs = band;                                 // [Tn][DH]
  for (int idx = tid; idx < Tn * DH; idx += THREADS) {
    const int j = idx / DH, d = idx - j * DH;
    Vs[idx] = v[(row_base + j) * D + col0 + d];
  }
  for (int j = tid; j < Tn; j += THREADS) {
    float acc[TQ];
#pragma unroll
    for (int li = 0; li < TQ; ++li) acc[li] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float k0 = to_f(Kt[(d + 0) * Tn + j]);
      const float k1 = to_f(Kt[(d + 1) * Tn + j]);
      const float k2 = to_f(Kt[(d + 2) * Tn + j]);
      const float k3 = to_f(Kt[(d + 3) * Tn + j]);
#pragma unroll
      for (int li = 0; li < TQ; ++li) {
        const float4 qq = *reinterpret_cast<const float4*>(qu + li * DH + d);
        acc[li] = fmaf(qq.x, k0, acc[li]);
        acc[li] = fmaf(qq.y, k1, acc[li]);
        acc[li] = fmaf(qq.z, k2, acc[li]);
        acc[li] = fmaf(qq.w, k3, acc[li]);
      }
    }
    const bool keep = kmask == nullptr || kmask[row_base + j] != 0;
#pragma unroll
    for (int li = 0; li < TQ; ++li)
      S[li * Tn + j] = keep ? acc[li] + W[li * RB + j - li + TQ - 1] : NEG_FILL;
  }
  __syncthreads();

  // softmax, one warp per row: p = exp(s - max) stored rounded to the
  // compute dtype (the AV product's operand), den from the unrounded p
  const int warp = tid / 32, lane = tid % 32;
  for (int li = warp; li < TQ; li += THREADS / 32) {
    float* srow = S + li * Tn;
    float m = NEG_FILL;
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float p = expf(srow[j] - m);
      sum += p;
      srow[j] = round_to<T>(p);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) den[li] = sum;
  }
  __syncthreads();

  // out = (p . V) / den: one head column per thread, TQ / 4 query rows
  constexpr int GROUPS = THREADS / DH;          // 4
  constexpr int RPT = TQ / GROUPS;              // 8
  const int dd = tid % DH, g = tid / DH;
  float acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
  for (int j = 0; j < Tn; ++j) {
    const float vv = to_f(Vs[j * DH + dd]);
#pragma unroll
    for (int m = 0; m < RPT; ++m)
      acc[m] = fmaf(S[(g + GROUPS * m) * Tn + j], vv, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int li = g + GROUPS * m;
    const int i = i0 + li;
    if (i < Tn) out[(row_base + i) * D + col0 + dd] = from_f<T>(acc[m] / den[li]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ph,
           const float* bu, const float* bv, const int* kmask, void* out,
           int B, int Tn, int D, int H, float scale, cudaStream_t stream) {
  const int RB = Tn + TQ - 1;
  const size_t smem = sizeof(float) * (2 * TQ * DH + (size_t)TQ * RB +
                                       (size_t)TQ * Tn + TQ) +
                      sizeof(T) * ((size_t)DH * Tn + (size_t)DH * RB);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tn + TQ - 1) / TQ, H, B);
  relpos_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ph, bu, bv, kmask,
      (T*)out, Tn, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kmask may be null. D must equal H * 64.
extern "C" int relpos_attention_forward(const void* q, const void* k,
                                        const void* v, const void* ph,
                                        const float* bu, const float* bv,
                                        const int* kmask, void* out, int B,
                                        int Tn, int D, int H, float scale,
                                        int dtype, void* stream) {
  if (D != H * DH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, ph, bu, bv, kmask, out, B, Tn, D, H, scale,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ph, bu, bv, kmask, out, B, Tn, D,
                                 H, scale, s);
  return (int)cudaErrorInvalidValue;
}
