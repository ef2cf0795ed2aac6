// Fused position-wise feed-forward kernel for Hopper (sm_90a), forward.
//
// Replaces speechain_tpu/ops/pallas_ffn.py::fused_ffn (pl.pallas_call at
// :180) and ::fused_ffn_residual (:264), one body (_fwd_kernel :59):
//     out = [res + alpha *] (act(x W1^T + b1) W2^T + b2)
// with the (rows, F) intermediate kept in shared memory.
//
// One block owns R rows (R chosen by the wrapper so that the grid fills the
// card). Rounding points follow the TPU kernel: z = x W1^T + b1 accumulates
// in float32 and is rounded to the compute dtype before the activation
// (exact-erf GELU via erff); h = act(z) is rounded to the compute dtype
// before the second product; the residual epilogue is float32 and the
// result is stored in the compute dtype. Weights are PyTorch Linear layout:
// W1 (F, D), W2 (Do, F); biases float32.

#include "common.cuh"

namespace {

using namespace sct;

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, const T* __restrict__ res,
           T* __restrict__ out, int N, int D, int Fd, int Do, int act,
           float alpha) {
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
    hs[r * Fd + c] = round_to<T>(activate(z, act));
  });
  __syncthreads();

  rows_times_wt<T, R>(hs, Fd, w2, Do, ws, [&](int r, int c, float acc) {
    const int row = row0 + r;
    if (row >= N) return;
    float y = acc + b2[c];
    const size_t o = (size_t)row * Do + c;
    if (res != nullptr) y = to_f(res[o]) + alpha * y;
    out[o] = from_f<T>(y);
  });
}

template <typename T, int R>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* res, void* out, int N, int D, int Fd,
           int Do, int act, float alpha, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)R * D + (size_t)R * Fd + THREADS * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + R - 1) / R;
  ffn_kernel<T, R><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)res,
      (T*)out, N, D, Fd, Do, act, alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(int R, const void* x, const void* w1, const float* b1,
                  const void* w2, const float* b2, const void* res, void* out,
                  int N, int D, int Fd, int Do, int act, float alpha,
                  cudaStream_t s) {
  switch (R) {
    case 1: return launch<T, 1>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do, act, alpha, s);
    case 2: return launch<T, 2>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do, act, alpha, s);
    case 4: return launch<T, 4>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do, act, alpha, s);
    case 8: return launch<T, 8>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do, act, alpha, s);
    case 16: return launch<T, 16>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do, act, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be null (no residual epilogue).
extern "C" int ffn_forward(const void* x, const void* w1, const float* b1,
                           const void* w2, const float* b2, const void* res,
                           void* out, int N, int D, int Fd, int Do, int rows,
                           int act, float alpha, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_rows<float>(rows, x, w1, b1, w2, b2, res, out, N, D, Fd,
                                Do, act, alpha, s);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(rows, x, w1, b1, w2, b2, res, out, N,
                                        D, Fd, Do, act, alpha, s);
  return (int)cudaErrorInvalidValue;
}
