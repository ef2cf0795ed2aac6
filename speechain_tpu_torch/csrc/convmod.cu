// Conformer convolution-module front half for Hopper (sm_90a), forward and
// backward.
//
// Forward: replaces speechain_tpu/ops/pallas_convmod.py::fused_conv_glu_dw
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
//
// Backward: replaces the backward pl.pallas_call at :301 (body _bwd_kernel
// :165) and the depthwise weight gradient that the JAX wrapper computes
// outside it (:324-336; Mosaic could not compile it inside, :33-53):
//     du_tot = du + ds + 2 u dss  for t < T   (the statistics' cotangents)
//     da[t]  = sum_k dwk[k] du_tot[t + P - k]  (transposed depthwise)
//     dz     = [da * gate, da * ag * gate * (1 - gate)] from z recomputed
//              from x (ag, gate the GLU halves), dz_c = round(dz)
//     dx = dz_c W1, dW1 = dz_c^T x, db1 = sum dz  (float32 dz)
//     ddwk[k] = sum a[t + k - P] du_tot[t], ddwb = sum du_tot, with the
//              GLU output a in float32 (as the TPU kernel's interpret mode;
//              on the TPU it exports a in bf16).
// convmod_bwd_rows: one block per (utterance, 64 frames, 64 channels)
// recomputes z over the tile and its K-1 halo frames, forms du_tot over the
// halo, writes dz_c (N, 2C) and per-block partials of db1, ddwk and ddwb;
// convmod_bwd_dx (dz_c W1) and convmod_bwd_wgrad (dz_c^T x) are tiled
// products; convmod_bwd_sums adds the partials in a fixed order.

#include "tiles.cuh"

namespace {

using namespace sct;

constexpr int TT = 64;          // frames per block
constexpr int CB = 64;          // channels per block
constexpr int RPT = 48;         // rows per thread: supports K <= 2*RPT - TT + 1
constexpr int KMAX = 2 * RPT - TT + 1;

// zs[r][j] = round(x[t0 - P + r] . W1[col(j)] + b1[col(j)]) for rows
// r < RZ and the 2 * CB columns col(j) of channel block c0 (CB GLU inputs,
// then their CB gates); frames outside [0, T) read x = 0. xs and ws stage
// (RZ, BK) of x and (2 CB, BK) of W1; one column per thread, rows
// rg + 2 m. Ends synchronised.
template <typename T>
__device__ __forceinline__ void pointwise_rows(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ b1, float* xs, float* ws, float* zs, size_t xrow,
    int t0, int RZ, int P, int Tn, int C, int c0) {
  const int tid = threadIdx.x;
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
}

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

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
  pointwise_rows<T>(x, w1, b1, xs, ws, zs, xrow, t0, RZ, P, Tn, C, c0);

  // GLU in place of the first half, zero outside the array [0, T)
  for (int i = tid; i < RZ * CB; i += THREADS) {
    const int r = i / CB, c = i - r * CB;
    const int t = t0 - P + r;
    float a = 0.f;
    if (t >= 0 && t < Tn)
      a = zs[r * 2 * CB + c] * sigmoid(zs[r * 2 * CB + CB + c]);
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

// Backward row pass. Frames of the tile: t0 + tt, tt < TT. z and a over
// frames t0 - P + r (r < RZ): a[t + k - P] is row tt + k. du_tot over
// frames t0 - Q + r with Q = K - 1 - P: du_tot[t + P - k] is row
// tt + K - 1 - k, du_tot[t] row tt + Q. Partials, row b * tiles + tile of
// part (.., 2C + C K + C): [db1 (2C) | ddwk (C, K) | ddwb (C)].
template <typename T>
__global__ void __launch_bounds__(THREADS)
convmod_bwd_rows(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ b1, const float* __restrict__ dwk,
                 const T* __restrict__ u, const T* __restrict__ du,
                 const float* __restrict__ dsum,
                 const float* __restrict__ dssum, T* __restrict__ dz,
                 float* __restrict__ part, int Tn, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int RZ = TT + K - 1;
  const int P = (K - 1) / 2, Q = K - 1 - P;
  float* xs = smem;                        // [RZ][BK]
  float* ws = xs + RZ * BK;                // [2*CB][BK + 1]
  float* zs = ws + 2 * CB * (BK + 1);      // [RZ][2*CB]
  float* as = zs + RZ * 2 * CB;            // [RZ][CB] GLU output a
  float* gs = as + RZ * CB;                // [RZ][CB] du_tot
  float* dk = gs + RZ * CB;                // [K][CB]
  float* red = dk + K * CB;                // [4][2*CB]

  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int t0 = tile * TT;
  const int tid = threadIdx.x;
  const size_t xrow = (size_t)b * Tn;

  for (int i = tid; i < K * CB; i += THREADS) {
    const int kk = i / CB, c = i - kk * CB;
    dk[i] = dwk[(size_t)(c0 + c) * K + kk];
  }
  pointwise_rows<T>(x, w1, b1, xs, ws, zs, xrow, t0, RZ, P, Tn, C, c0);

  for (int i = tid; i < RZ * CB; i += THREADS) {
    const int r = i / CB, c = i - r * CB;
    const int t = t0 - P + r;
    as[i] = (t >= 0 && t < Tn)
                ? zs[r * 2 * CB + c] * sigmoid(zs[r * 2 * CB + CB + c])
                : 0.f;
    const int t2 = t0 - Q + r;
    float d = 0.f;
    if (t2 >= 0 && t2 < Tn) {
      const size_t e = (xrow + t2) * C + c0 + c;
      d = to_f(du[e]) + dsum[c0 + c] + 2.f * to_f(u[e]) * dssum[c0 + c];
    }
    gs[i] = d;
  }
  __syncthreads();

  // GLU backward: one channel per thread, 16 frames each
  constexpr int GROUPS = THREADS / CB;            // 4
  constexpr int FPT = TT / GROUPS;                // 16
  const int c = tid % CB, g = tid / CB;
  const int nt = min(TT, Tn - t0);
  float sa = 0.f, sg = 0.f;
  for (int m = 0; m < FPT; ++m) {
    const int tt = g * FPT + m;
    if (tt >= nt) break;
    float da = 0.f;
    for (int kk = 0; kk < K; ++kk)
      da = fmaf(dk[kk * CB + c], gs[(tt + K - 1 - kk) * CB + c], da);
    const float ag = zs[(tt + P) * 2 * CB + c];
    const float gate = sigmoid(zs[(tt + P) * 2 * CB + CB + c]);
    const float dag = da * gate;
    const float dgate = da * ag * gate * (1.f - gate);
    T* row = dz + (xrow + t0 + tt) * 2 * C;
    row[c0 + c] = from_f<T>(dag);
    row[C + c0 + c] = from_f<T>(dgate);
    sa += dag;
    sg += dgate;
  }
  red[g * 2 * CB + c] = sa;
  red[g * 2 * CB + CB + c] = sg;
  __syncthreads();

  float* prow = part + ((size_t)b * gridDim.x + tile) * (2 * C + C * K + C);
  if (g == 0) {
    float st = 0.f, sgt = 0.f;
    for (int q = 0; q < GROUPS; ++q) {
      st += red[q * 2 * CB + c];
      sgt += red[q * 2 * CB + CB + c];
    }
    prow[c0 + c] = st;
    prow[C + c0 + c] = sgt;
  }
  for (int i = tid; i < K * CB; i += THREADS) {
    const int kk = i / CB, cc = i - kk * CB;
    float acc = 0.f;
    for (int tt = 0; tt < nt; ++tt)
      acc = fmaf(as[(tt + kk) * CB + cc], gs[(tt + Q) * CB + cc], acc);
    prow[2 * C + (size_t)(c0 + cc) * K + kk] = acc;
  }
  if (tid < CB) {
    float acc = 0.f;
    for (int tt = 0; tt < nt; ++tt) acc += gs[(tt + Q) * CB + tid];
    prow[2 * C + C * K + c0 + tid] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
convmod_bwd_dx(const T* __restrict__ dz, const T* __restrict__ w1,
               T* __restrict__ dx, int N, int C) {
  gemm_nn_tile<T>(dz, w1, dx, N, 2 * C, C);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
convmod_bwd_wgrad(const T* __restrict__ dz, const T* __restrict__ x,
                  float* __restrict__ dw1, int N, int C) {
  wgrad_tile<T>(dz, x, dw1, N, 2 * C, C);
}

__global__ void convmod_bwd_sums(const float* __restrict__ part,
                                 float* __restrict__ out, int n_part,
                                 int W) {
  sum_parts(part, out, n_part, W);
}

size_t fwd_smem(int K) {
  const int RZ = TT + K - 1;
  return sizeof(float) * ((size_t)RZ * BK + 2 * CB * (BK + 1) +
                          (size_t)RZ * 2 * CB + (size_t)K * CB + 8 * CB);
}

size_t bwd_smem(int K) {
  const int RZ = TT + K - 1;
  return fwd_smem(K) + sizeof(float) * 2 * (size_t)RZ * CB;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const float* dwk,
           const void* dwb, void* u, float* part, float* s, float* ss, int B,
           int Tn, int C, int K, cudaStream_t stream) {
  if (K > KMAX || C % CB != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(K);
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

template <typename T>
int launch_bwd(const void* x, const void* w1, const void* b1,
               const float* dwk, const void* u, const void* du,
               const float* ds, const float* dss, void* dz, float* part,
               void* dx, float* dw1, float* sums, int B, int Tn, int C,
               int K, cudaStream_t stream) {
  if (K > KMAX || C % CB != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(K);
  cudaError_t err = cudaFuncSetAttribute(
      convmod_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Tn + TT - 1) / TT, N = B * Tn;
  convmod_bwd_rows<T><<<dim3(tiles, C / CB, B), THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, dwk, (const T*)u,
      (const T*)du, ds, dss, (T*)dz, part, Tn, C, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  convmod_bwd_dx<T><<<dim3((C + WT - 1) / WT, (N + WT - 1) / WT), THREADS, 0,
                      stream>>>((const T*)dz, (const T*)w1, (T*)dx, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  convmod_bwd_wgrad<T><<<dim3((C + WT - 1) / WT, (2 * C + WT - 1) / WT),
                         THREADS, 0, stream>>>((const T*)dz, (const T*)x,
                                               dw1, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int W = 2 * C + C * K + C;
  convmod_bwd_sums<<<(W + 255) / 256, 256, 0, stream>>>(part, sums,
                                                        B * tiles, W);
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

// du (B, T, C) in the compute dtype, ds / dss (C,) float32: the cotangents
// of u, s and ss. dz: (B * T, 2C) scratch in the compute dtype; part:
// (B * ceil(T / 64), 2C + C K + C) float32 scratch. Results: dx (B, T, C)
// in the compute dtype, dw1 (2C, C) float32, sums (2C + C K + C) float32 =
// [db1 | ddwk (C, K) | ddwb].
extern "C" int convmod_backward(const void* x, const void* w1, const void* b1,
                                const float* dwk, const void* u,
                                const void* du, const float* ds,
                                const float* dss, void* dz, float* part,
                                void* dx, float* dw1, float* sums, int B,
                                int Tn, int C, int K, int dtype,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(x, w1, b1, dwk, u, du, ds, dss, dz, part, dx,
                             dw1, sums, B, Tn, C, K, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w1, b1, dwk, u, du, ds, dss, dz,
                                     part, dx, dw1, sums, B, Tn, C, K, st);
  return (int)cudaErrorInvalidValue;
}
