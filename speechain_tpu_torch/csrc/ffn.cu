// Fused position-wise feed-forward kernels for Hopper (sm_90a).
//
// Forward: replaces speechain_tpu/ops/pallas_ffn.py::fused_ffn (pl.pallas_call
// at :180) and ::fused_ffn_residual (:264), one body (_fwd_kernel :59):
//     out = [res + alpha * resdrop](drop(act(x W1^T + b1)) W2^T + b2)
// with the (rows, F) intermediate kept in shared memory.
//
// Backward: replaces the backward pl.pallas_call at :207 and :293, one body
// (_bwd_kernel :93): dx, dW1, db1, dW2, db2 with the intermediate recomputed
// from x and both dropout masks regenerated. The TPU kernel accumulates the
// weight gradients across its sequential grid; blocks here run in parallel,
// and per-block partials of both matrices would not fit (199 blocks x 8 MB
// at N = 3184, D = 512, F = 2048). So the backward is split:
//   1. ffn_bwd_rows: one block per R rows writes dx and, in the compute
//      dtype, ht (the dropped activation), dz, and g_c (the scaled output
//      cotangent), plus g in float32 for db2;
//   2. wgrad_kernel: one block per 64 x 64 tile of dW1 = dz^T x and of
//      dW2 = g_c^T ht, summing rows in a fixed order (deterministic);
//   3. colsum_kernel: db1 = sum dz, db2 = sum g, fixed order.
// Weight gradients stay float32, as the TPU kernel returns them.
//
// Rounding points follow the TPU kernel: z = x W1^T + b1 accumulates in
// float32 and is rounded to the compute dtype before the activation; the
// activation, the dropped activation ht, g_c and dz are rounded to the
// compute dtype; products accumulate in float32. Dropout bits come from
// common.cuh::dropout_bits with stream seed + row / pick and element
// (row % pick) * C + col, pick = pallas_ffn.py::_pick_rows(N).
// Weights are PyTorch Linear layout: W1 (F, D), W2 (Do, F); biases float32.

#include "tiles.cuh"

namespace {

using namespace sct;

struct Drop {          // one dropout site; thresh/scale from ops/dropout.py
  int on;
  unsigned int seed, thresh;
  float scale;
  __device__ __forceinline__ float keep(int row, int col, int C,
                                        int pick) const {
    return dropout_keep((unsigned int)((row % pick) * C + col),
                        seed + (unsigned int)(row / pick), thresh, scale);
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, const T* __restrict__ res,
           T* __restrict__ out, int N, int D, int Fd, int Do, int act,
           float alpha, int pick, Drop drop, Drop rdrop) {
  extern __shared__ float smem[];
  float* xs = smem;                  // [R][D]
  float* hs = xs + R * D;            // [R][Fd]
  float* ws = hs + R * Fd;           // [THREADS][BK + 1]
  const int row0 = blockIdx.x * R;

  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D;
    xs[i] = row0 + r < N ? to_f(x[(size_t)row0 * D + i]) : 0.f;
  }
  __syncthreads();

  rows_times_wt<T, R>(xs, D, w1, Fd, ws, [&](int r, int c, float acc) {
    const float z = round_to<T>(acc + b1[c]);
    float h = round_to<T>(activate(z, act));
    if (drop.on && row0 + r < N)
      h = round_to<T>(h * drop.keep(row0 + r, c, Fd, pick));
    hs[r * Fd + c] = h;
  });
  __syncthreads();

  rows_times_wt<T, R>(hs, Fd, w2, Do, ws, [&](int r, int c, float acc) {
    const int row = row0 + r;
    if (row >= N) return;
    float y = acc + b2[c];
    const size_t o = (size_t)row * Do + c;
    if (res != nullptr) {
      if (rdrop.on) y = y * rdrop.keep(row, c, Do, pick);
      y = to_f(res[o]) + alpha * y;
    }
    out[o] = from_f<T>(y);
  });
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows(const T* __restrict__ x, const T* __restrict__ w1,
             const float* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ ht,
             T* __restrict__ dz, T* __restrict__ gc, float* __restrict__ gs,
             int N, int D, int Fd, int Do, int act, float alpha, int pick,
             Drop drop, Drop rdrop) {
  extern __shared__ float smem[];
  const int W = D > Do ? D : Do;
  float* buf = smem;                 // [R][W]: x, then g_c
  float* hs = buf + R * W;           // [R][Fd]: z (rounded), then dz
  float* ws = hs + R * Fd;           // [THREADS][BK + 1]
  const int row0 = blockIdx.x * R;

  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D;
    buf[i] = row0 + r < N ? to_f(x[(size_t)row0 * D + i]) : 0.f;
  }
  __syncthreads();

  // recompute z and the dropped activation ht
  rows_times_wt<T, R>(buf, D, w1, Fd, ws, [&](int r, int c, float acc) {
    const float z = round_to<T>(acc + b1[c]);
    hs[r * Fd + c] = z;
    const int row = row0 + r;
    if (row >= N) return;
    float h = round_to<T>(activate(z, act));
    if (drop.on) h = round_to<T>(h * drop.keep(row, c, Fd, pick));
    ht[(size_t)row * Fd + c] = from_f<T>(h);
  });
  __syncthreads();

  // output cotangent of the inner branch: alpha * resmask * g
  for (int i = threadIdx.x; i < R * Do; i += THREADS) {
    const int r = i / Do, c = i - r * Do, row = row0 + r;
    float v = 0.f;
    if (row < N) {
      const size_t o = (size_t)row * Do + c;
      v = to_f(g[o]);
      if (rdrop.on) v = v * rdrop.keep(row, c, Do, pick);
      v = alpha * v;
      gs[o] = v;
      v = round_to<T>(v);
      gc[o] = from_f<T>(v);
    }
    buf[r * Do + c] = v;
  }
  __syncthreads();

  // dht = g_c W2; dz = act'(z) * (dht * mask), in the compute dtype
  rows_times_w<T, R>(buf, Do, w2, Fd, [&](int r, int c, float acc) {
    const int row = row0 + r;
    float v = 0.f;
    if (row < N) {
      float dh = acc;
      if (drop.on) dh = dh * drop.keep(row, c, Fd, pick);
      v = round_to<T>(activate_grad(hs[r * Fd + c], act) * round_to<T>(dh));
      dz[(size_t)row * Fd + c] = from_f<T>(v);
    }
    hs[r * Fd + c] = v;
  });
  __syncthreads();

  // dx = dz W1
  rows_times_w<T, R>(hs, Fd, w1, D, [&](int r, int c, float acc) {
    const int row = row0 + r;
    if (row < N) dx[(size_t)row * D + c] = from_f<T>(acc);
  });
}

// C (M1, M2) float32 = A^T B over N rows (tiles.cuh::wgrad_tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ B,
             float* __restrict__ C, int N, int M1, int M2) {
  wgrad_tile<T>(A, B, C, N, M1, M2);
}

// out[c] = sum over rows of A[r][c]; 32 columns x 8 row groups per block,
// partial sums added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const T* __restrict__ A, float* __restrict__ out, int N,
              int M) {
  __shared__ float part[8][33];
  const int cx = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float s = 0.f;
  if (c < M)
    for (int r = rg; r < N; r += 8) s += to_f(A[(size_t)r * M + c]);
  part[rg][cx] = s;
  __syncthreads();
  if (rg == 0 && c < M) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += part[k][cx];
    out[c] = t;
  }
}

template <typename T, int R>
size_t fwd_smem(int D, int Fd) {
  return sizeof(float) * ((size_t)R * D + (size_t)R * Fd + THREADS * (BK + 1));
}

template <typename T, int R>
int launch_fwd(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* res, void* out, int N, int D,
               int Fd, int Do, int act, float alpha, int pick, Drop drop,
               Drop rdrop, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, R>(D, Fd);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + R - 1) / R;
  ffn_kernel<T, R><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)res,
      (T*)out, N, D, Fd, Do, act, alpha, pick, drop, rdrop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int R, const void* x, const void* w1, const float* b1,
                 const void* w2, const float* b2, const void* res, void* out,
                 int N, int D, int Fd, int Do, int act, float alpha, int pick,
                 Drop drop, Drop rdrop, cudaStream_t s) {
#define FFN_FWD(RR)                                                        \
  case RR:                                                                 \
    return launch_fwd<T, RR>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do,    \
                             act, alpha, pick, drop, rdrop, s);
  switch (R) {
    FFN_FWD(1) FFN_FWD(2) FFN_FWD(4) FFN_FWD(8) FFN_FWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFN_FWD
}

template <typename T, int R>
int launch_bwd_rows(const void* x, const void* w1, const float* b1,
                    const void* w2, const void* g, void* dx, void* ht,
                    void* dz, void* gc, float* gs, int N, int D, int Fd,
                    int Do, int act, float alpha, int pick, Drop drop,
                    Drop rdrop, cudaStream_t stream) {
  const int W = D > Do ? D : Do;
  const size_t smem =
      sizeof(float) * ((size_t)R * W + (size_t)R * Fd + THREADS * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_rows<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_rows<T, R><<<(N + R - 1) / R, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, (const T*)g, (T*)dx,
      (T*)ht, (T*)dz, (T*)gc, gs, N, D, Fd, Do, act, alpha, pick, drop,
      rdrop);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(int R, const void* x, const void* w1, const float* b1,
             const void* w2, const void* g, void* dx, void* ht, void* dz,
             void* gc, float* gs, float* dw1, float* db1, float* dw2,
             float* db2, int N, int D, int Fd, int Do, int act, float alpha,
             int pick, Drop drop, Drop rdrop, cudaStream_t s) {
  int err;
#define FFN_BWD(RR)                                                        \
  case RR:                                                                 \
    err = launch_bwd_rows<T, RR>(x, w1, b1, w2, g, dx, ht, dz, gc, gs, N,  \
                                 D, Fd, Do, act, alpha, pick, drop, rdrop, \
                                 s);                                       \
    break;
  switch (R) {
    FFN_BWD(1) FFN_BWD(2) FFN_BWD(4) FFN_BWD(8) FFN_BWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFN_BWD
  if (err) return err;
  wgrad_kernel<T><<<dim3((D + WT - 1) / WT, (Fd + WT - 1) / WT), THREADS, 0,
                    s>>>((const T*)dz, (const T*)x, dw1, N, Fd, D);
  if ((err = (int)cudaGetLastError())) return err;
  wgrad_kernel<T><<<dim3((Fd + WT - 1) / WT, (Do + WT - 1) / WT), THREADS, 0,
                    s>>>((const T*)gc, (const T*)ht, dw2, N, Do, Fd);
  if ((err = (int)cudaGetLastError())) return err;
  colsum_kernel<T><<<(Fd + 31) / 32, THREADS, 0, s>>>((const T*)dz, db1, N,
                                                      Fd);
  if ((err = (int)cudaGetLastError())) return err;
  colsum_kernel<float><<<(Do + 31) / 32, THREADS, 0, s>>>(gs, db2, N, Do);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be null (no residual epilogue).
// drop_*/rdrop_*: inner and residual dropout (on, seed, threshold, scale).
extern "C" int ffn_forward(const void* x, const void* w1, const float* b1,
                           const void* w2, const float* b2, const void* res,
                           void* out, int N, int D, int Fd, int Do, int rows,
                           int act, float alpha, int dtype, int pick,
                           int drop_on, unsigned int seed,
                           unsigned int thresh, float scale, int rdrop_on,
                           unsigned int rseed, unsigned int rthresh,
                           float rscale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop drop{drop_on, seed, thresh, scale};
  const Drop rdrop{rdrop_on, rseed, rthresh, rscale};
  if (dtype == 0)
    return dispatch_fwd<float>(rows, x, w1, b1, w2, b2, res, out, N, D, Fd,
                               Do, act, alpha, pick, drop, rdrop, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(rows, x, w1, b1, w2, b2, res, out, N,
                                       D, Fd, Do, act, alpha, pick, drop,
                                       rdrop, s);
  return (int)cudaErrorInvalidValue;
}

// g: output cotangent (N, Do). Scratch ht, dz (N, Fd), gc (N, Do) in the
// compute dtype and gs (N, Do) float32; outputs dx (N, D) in the compute
// dtype, dw1 (Fd, D), db1 (Fd), dw2 (Do, Fd), db2 (Do) float32.
extern "C" int ffn_backward(const void* x, const void* w1, const float* b1,
                            const void* w2, const void* g, void* dx,
                            void* ht, void* dz, void* gc, float* gs,
                            float* dw1, float* db1, float* dw2, float* db2,
                            int N, int D, int Fd, int Do, int rows, int act,
                            float alpha, int dtype, int pick, int drop_on,
                            unsigned int seed, unsigned int thresh,
                            float scale, int rdrop_on, unsigned int rseed,
                            unsigned int rthresh, float rscale,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop drop{drop_on, seed, thresh, scale};
  const Drop rdrop{rdrop_on, rseed, rthresh, rscale};
  if (dtype == 0)
    return backward<float>(rows, x, w1, b1, w2, g, dx, ht, dz, gc, gs, dw1,
                           db1, dw2, db2, N, D, Fd, Do, act, alpha, pick,
                           drop, rdrop, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(rows, x, w1, b1, w2, g, dx, ht, dz, gc,
                                   gs, dw1, db1, dw2, db2, N, D, Fd, Do, act,
                                   alpha, pick, drop, rdrop, s);
  return (int)cudaErrorInvalidValue;
}
