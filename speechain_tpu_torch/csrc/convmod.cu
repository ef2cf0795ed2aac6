// Conformer convolution-module front half for Hopper (sm_90a), forward.
//
// Replaces speechain_tpu/ops/pallas_convmod.py::fused_conv_glu_dw
// (pl.pallas_call at :273, body _fwd_kernel at :131):
//     z = round(x W1^T + b1)              (B, T, 2C), float32 accumulation
//     a = z[:, :C] * sigmoid(z[:, C:])    (GLU), zero outside [0, T)
//     u = round(sum_k dwk[k] * a[t + k - P] + dwb)   ('SAME', P = (K-1)/2)
//     s[c] = sum_{b,t} u, ss[c] = sum_{b,t} u^2   (from the ROUNDED u)
// Zero padding applies at the array's time edges only: padded frames of a
// shorter utterance are not masked (the reference BatchNorm semantics).
//
// One block owns (utterance b, TT frames, CB channels): it recomputes the
// pointwise product over its tile plus the K-1 halo frames, so blocks are
// independent; the (rows, 2*CB) pointwise output never reaches device
// memory. The TPU kernel carried s/ss across its sequential grid; blocks
// here run in any order, so each block writes its partial sums and a
// second small kernel adds them in a fixed order (deterministic).
// Weights: W1 (2C, C) PyTorch layout, b1 (2C,) and dwb (C,) in the compute
// dtype, dwk (C, K) float32.

#include "common.cuh"

namespace {

using namespace sct;

constexpr int TT = 64;          // frames per block
constexpr int CB = 64;          // channels per block
constexpr int RPT = 48;         // rows per thread: supports K <= 2*RPT - TT + 1
constexpr int KMAX = 2 * RPT - TT + 1;

template <typename T>
__global__ void __launch_bounds__(THREADS)
convmod_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const float* __restrict__ dwk,
               const T* __restrict__ dwb, T* __restrict__ u,
               float* __restrict__ part, int Tn, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int RZ = TT + K - 1;
  const int P = (K - 1) / 2;
  float* xs = smem;                        // [RZ][BK]
  float* ws = xs + RZ * BK;                // [2*CB][BK + 1]
  float* zs = ws + 2 * CB * (BK + 1);      // [RZ][2*CB]
  float* dk = zs + RZ * 2 * CB;            // [K][CB]
  float* red = dk + K * CB;                // [4][2][CB]

  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int t0 = tile * TT;
  const int tid = threadIdx.x;
  const size_t xrow = (size_t)b * Tn;

  for (int i = tid; i < K * CB; i += THREADS) {
    const int kk = i / CB, c = i - kk * CB;
    dk[i] = dwk[(size_t)(c0 + c) * K + kk];
  }

  // pointwise product over the tile and its halo: 128 columns (CB GLU
  // inputs, CB gates), rows r = rg + 2m
  const int j = tid % (2 * CB), rg = tid / (2 * CB);
  const int wrow_j = j < CB ? c0 + j : C + c0 + (j - CB);
  float acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int i = tid; i < RZ * BK; i += THREADS) {
      const int r = i / BK, kk = i - r * BK;
      const int t = t0 - P + r;
      xs[i] = (t >= 0 && t < Tn && k0 + kk < C)
                  ? to_f(x[(xrow + t) * C + k0 + kk]) : 0.f;
    }
    for (int i = tid; i < 2 * CB * BK; i += THREADS) {
      const int jj = i / BK, kk = i - jj * BK;
      const int wr = jj < CB ? c0 + jj : C + c0 + (jj - CB);
      ws[jj * (BK + 1) + kk] =
          k0 + kk < C ? to_f(w1[(size_t)wr * C + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int kmax = min(BK, C - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float w = ws[j * (BK + 1) + kk];
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int r = rg + 2 * m;
        if (r < RZ) acc[m] = fmaf(xs[r * BK + kk], w, acc[m]);
      }
    }
    __syncthreads();
  }
  const float bias = to_f(b1[wrow_j]);
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int r = rg + 2 * m;
    if (r < RZ) zs[r * 2 * CB + j] = round_to<T>(acc[m] + bias);
  }
  __syncthreads();

  // GLU in place of the first half, zero outside the array [0, T)
  for (int i = tid; i < RZ * CB; i += THREADS) {
    const int r = i / CB, c = i - r * CB;
    const int t = t0 - P + r;
    float a = 0.f;
    if (t >= 0 && t < Tn) {
      const float g = zs[r * 2 * CB + CB + c];
      a = zs[r * 2 * CB + c] * (1.f / (1.f + expf(-g)));
    }
    zs[r * 2 * CB + c] = a;
  }
  __syncthreads();

  // depthwise conv: one channel per thread, 16 frames each
  constexpr int GROUPS = THREADS / CB;            // 4
  constexpr int FPT = TT / GROUPS;                // 16
  const int c = tid % CB, g = tid / CB;
  const float db = to_f(dwb[c0 + c]);
  float s = 0.f, ss = 0.f;
  for (int m = 0; m < FPT; ++m) {
    const int tt = g * FPT + m;
    const int t = t0 + tt;
    if (t >= Tn) break;
    float o = zs[tt * 2 * CB + c] * dk[c];
    for (int kk = 1; kk < K; ++kk)
      o = fmaf(zs[(tt + kk) * 2 * CB + c], dk[kk * CB + c], o);
    const T uo = from_f<T>(o + db);
    u[(xrow + t) * C + c0 + c] = uo;
    const float uf = to_f(uo);
    s += uf;
    ss += uf * uf;
  }
  red[(g * 2 + 0) * CB + c] = s;
  red[(g * 2 + 1) * CB + c] = ss;
  __syncthreads();
  if (g == 0) {
    float st = 0.f, sst = 0.f;
    for (int q = 0; q < GROUPS; ++q) {
      st += red[(q * 2 + 0) * CB + c];
      sst += red[(q * 2 + 1) * CB + c];
    }
    const size_t prow = (size_t)b * gridDim.x + tile;
    part[(prow * 2 + 0) * C + c0 + c] = st;
    part[(prow * 2 + 1) * C + c0 + c] = sst;
  }
}

// s[c] = sum_p part[p][0][c], ss[c] = sum_p part[p][1][c], in order of p
__global__ void stats_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ s,
                                    float* __restrict__ ss, int n_part,
                                    int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, q = 0.f;
  for (int p = 0; p < n_part; ++p) {
    a += part[((size_t)p * 2 + 0) * C + c];
    q += part[((size_t)p * 2 + 1) * C + c];
  }
  s[c] = a;
  ss[c] = q;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const float* dwk,
           const void* dwb, void* u, float* part, float* s, float* ss, int B,
           int Tn, int C, int K, cudaStream_t stream) {
  if (K > KMAX || C % CB != 0) return (int)cudaErrorInvalidValue;
  const int RZ = TT + K - 1;
  const size_t smem = sizeof(float) * ((size_t)RZ * BK + 2 * CB * (BK + 1) +
                                       (size_t)RZ * 2 * CB + (size_t)K * CB +
                                       8 * CB);
  cudaError_t err = cudaFuncSetAttribute(
      convmod_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Tn + TT - 1) / TT;
  dim3 grid(tiles, C / CB, B);
  convmod_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, dwk, (const T*)dwb, (T*)u,
      part, Tn, C, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<(C + 127) / 128, 128, 0, stream>>>(part, s, ss,
                                                           B * tiles, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part: (B * ceil(T / 64), 2, C) float32
// scratch. C must be a multiple of 64 and K <= 33.
extern "C" int convmod_forward(const void* x, const void* w1, const void* b1,
                               const float* dwk, const void* dwb, void* u,
                               float* part, float* s, float* ss, int B,
                               int Tn, int C, int K, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w1, b1, dwk, dwb, u, part, s, ss, B, Tn, C, K,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, dwk, dwb, u, part, s, ss, B, Tn,
                                 C, K, st);
  return (int)cudaErrorInvalidValue;
}
