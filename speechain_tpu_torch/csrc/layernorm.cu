// LayerNorm over the last axis, forward and backward, float32 statistics.
//
// Replaces speechain_tpu/ops/pallas_layernorm.py::fused_layer_norm
// (forward pl.pallas_call at :117, body _fwd_kernel :56; backward at :139,
// body _bwd_kernel :68):
//   mu = mean(x), var = mean(x^2) - mu^2 (the fast variance),
//   rstd = rsqrt(var + eps), y = (x - mu) * rstd * scale + bias  (x's type)
//   dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)), gs = g * scale
//   dscale = sum_rows g * xhat, dbias = sum_rows g                (float32)
//
// What bounds it on the H100: the bytes. The conformer encoder's LayerNorm
// (N = 3184 rows, D = 256, bf16) moves 3.29 MB forward (0.98 us at 3.35
// TB/s) and ~4.9 MB backward (1.47 us), below a launch's latency. Design:
// one warp per row, 16-byte loads (8 bf16 or 4 float32 values a lane), the
// row's float32 sums reduced by shuffles, the row read again for the
// output (it is in L1 by then). The TPU kernel accumulates dscale and dbias
// over a sequential grid; blocks here run in no order, so each 16-row block
// writes its partial sums (in a fixed order over its warps) and a second
// kernel adds the partials in block order: deterministic, no atomics.
//
// Rounding points: x widened to float32, all arithmetic float32, y and dx
// rounded once to x's type at the store, as the TPU kernel's astype.

#include "tiles.cuh"

namespace {

using namespace sct;

constexpr int WARPS = THREADS / 32;        // 8 warps, one row each
constexpr int BWD_ROWS = 2 * WARPS;        // backward: 2 rows a warp
constexpr int MAX_D = 1024;                // a lane keeps <= 32 columns

// values of T in one 16-byte load
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) out[e] = to_f(v[e]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 u;
  T* v = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) v[e] = from_f<T>(in[e]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_rows_fwd(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ y,
            float* __restrict__ mu_out, float* __restrict__ rstd_out, int N,
            int D, float eps) {
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane * VN; c < D; c += 32 * VN) {
    float v[VN];
    load_vec(xr + c, v);
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      s += v[e];
      ss += v[e] * v[e];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float rstd = rsqrtf(ss / (float)D - mu * mu + eps);
  T* yr = y + (size_t)row * D;
  for (int c = lane * VN; c < D; c += 32 * VN) {
    float v[VN];
    load_vec(xr + c, v);
#pragma unroll
    for (int e = 0; e < VN; ++e)
      v[e] = (v[e] - mu) * rstd * scale[c + e] + bias[c + e];
    store_vec(yr + c, v);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// dx for BWD_ROWS rows; part[block] = (dscale partial (D), dbias partial
// (D)), each summed over the block's rows in row order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_rows_bwd(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ mu, const float* __restrict__ rstd,
            const T* __restrict__ g, T* __restrict__ dx,
            float* __restrict__ part, int N, int D) {
  constexpr int VN = Vec<T>::N;
  constexpr int NV = 32 / VN;               // vectors a lane keeps
  __shared__ float red[WARPS][MAX_D];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float dsc[NV][VN], dbi[NV][VN];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VN; ++e) dsc[j][e] = dbi[j][e] = 0.f;
  const float invD = 1.f / (float)D;
  for (int rr = 0; rr < 2; ++rr) {
    const int row = blockIdx.x * BWD_ROWS + warp * 2 + rr;
    if (row >= N) break;
    const T* xr = x + (size_t)row * D;
    const T* gr = g + (size_t)row * D;
    const float m = mu[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * VN;
      if (c < D) {
        float xv[VN], gv[VN];
        load_vec(xr + c, xv);
        load_vec(gr + c, gv);
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          const float xh = (xv[e] - m) * r;
          const float gs = gv[e] * scale[c + e];
          s1 += gs;
          s2 += gs * xh;
          dsc[j][e] += gv[e] * xh;
          dbi[j][e] += gv[e];
        }
      }
    }
    const float m1 = warp_sum(s1) * invD, m2 = warp_sum(s2) * invD;
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * VN;
      if (c < D) {
        float xv[VN], gv[VN];
        load_vec(xr + c, xv);
        load_vec(gr + c, gv);
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          const float xh = (xv[e] - m) * r;
          xv[e] = r * (gv[e] * scale[c + e] - m1 - xh * m2);
        }
        store_vec(dxr + c, xv);
      }
    }
  }
  // per-block partials: warps' sums added in warp order
  float* out = part + (size_t)blockIdx.x * 2 * D;
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * VN;
      if (c < D) {
#pragma unroll
        for (int e = 0; e < VN; ++e)
          red[warp][c + e] = q == 0 ? dsc[j][e] : dbi[j][e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += THREADS) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t += red[w][c];
      out[q * D + c] = t;
    }
    __syncthreads();
  }
}

__global__ void ln_param_sum(const float* __restrict__ part,
                             float* __restrict__ out, int n_part, int W) {
  sum_parts(part, out, n_part, W);
}

template <typename T>
cudaError_t forward(const void* x, const float* s, const float* b, void* y,
                    float* mu, float* rstd, int N, int D, float eps,
                    cudaStream_t st) {
  ln_rows_fwd<T><<<(N + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const T*)x, s, b, (T*)y, mu, rstd, N, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const float* s, const float* mu,
                     const float* rstd, const void* g, void* dx, float* part,
                     float* sums, int N, int D, cudaStream_t st) {
  const int blocks = (N + BWD_ROWS - 1) / BWD_ROWS;
  ln_rows_bwd<T><<<blocks, THREADS, 0, st>>>(
      (const T*)x, s, mu, rstd, (const T*)g, (T*)dx, part, N, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_param_sum<<<(2 * D + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, sums, blocks, 2 * D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (N, D) in float32 (dtype 0) or bf16 (dtype 1); scale, bias (D,)
// float32; mu, rstd (N,) float32 out. D % (16 / sizeof(T)) == 0.
int layer_norm_forward(const void* x, const float* scale, const float* bias,
                       void* y, float* mu, float* rstd, int N, int D,
                       float eps, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? forward<float>(x, scale, bias, y, mu, rstd, N, D, eps,
                                    st)
                   : forward<__nv_bfloat16>(x, scale, bias, y, mu, rstd, N,
                                            D, eps, st));
}

// dx (N, D) in x's type; part (ceil(N / 16), 2 D) float32 scratch; sums
// (2 D) float32 out: dscale then dbias.
int layer_norm_backward(const void* x, const float* scale, const float* mu,
                        const float* rstd, const void* g, void* dx,
                        float* part, float* sums, int N, int D, int dtype,
                        void* stream) {
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaMemsetAsync(sums, 0, 2 * D * sizeof(float),
                                          (cudaStream_t)stream);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? backward<float>(x, scale, mu, rstd, g, dx, part, sums,
                                     N, D, st)
                   : backward<__nv_bfloat16>(x, scale, mu, rstd, g, dx, part,
                                             sums, N, D, st));
}

}  // extern "C"
