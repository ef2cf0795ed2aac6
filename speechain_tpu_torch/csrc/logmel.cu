// Fused waveform -> log-Mel kernel for Hopper (sm_90a), float32 throughout.
//
// Replaces speechain_tpu/ops/pallas_logmel.py::pallas_logmel (its
// pl.pallas_call at :110, body _logmel_kernel at :38).
//
// One block owns TILE consecutive frames of one utterance:
//   1. frames them straight from the waveform by index arithmetic:
//      pre-emphasis y[i] = x[i] - p*x[i-1] (y = 0 at i >= wave_len),
//      then reflect centre padding at both array ends;
//   2. windowed DFT (basis (n_fft, 2*n_freq): cos | -sin columns) with
//      float32 FMAs, power re^2 + im^2 (or magnitude) kept in shared memory;
//   3. mel product, clamp, log, / log(base); frames at or beyond feat_len
//      are written as 0.
// What bounds it on the H100: float32 FMA throughput (the DFT is ~400
// multiply-adds per output bin and frame); see ops/cuda_logmel.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;       // frames per block (ops/cuda_logmel.py)
constexpr int THREADS = 256;

__device__ __forceinline__ float emphasized(const float* __restrict__ w,
                                            int i, int len, int has_pe,
                                            float pe) {
  float x = w[i];
  if (has_pe) {
    if (i >= len) return 0.f;
    const float prev = i > 0 ? w[i - 1] : 0.f;
    // no contraction into an FMA: the reference rounds p * prev first
    x = __fsub_rn(x, __fmul_rn(pe, prev));
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ wave, const int* __restrict__ wave_len,
              const int* __restrict__ feat_len,
              const float* __restrict__ basis, const float* __restrict__ mel,
              float* __restrict__ out, int L, int T, int n_fft, int hop,
              int n_freq, int n_mels, int center, int has_pe, float pe,
              int mag_spec, int logging, float clamp, float log_div) {
  extern __shared__ float smem[];
  float* fr = smem;                        // [TILE][n_fft]
  float* pw = smem + TILE * n_fft;         // [TILE][n_freq]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const float* w = wave + (size_t)b * L;
  const int len = wave_len[b];
  const int pad = center ? n_fft / 2 : 0;

  // 1. frames (reflect padding excludes the edge sample, like numpy)
  for (int idx = threadIdx.x; idx < TILE * n_fft; idx += blockDim.x) {
    const int tt = idx / n_fft;
    const int n = idx - tt * n_fft;
    const int t = t0 + tt;
    float v = 0.f;
    if (t < T) {
      int i = t * hop + n - pad;
      if (i < 0) i = -i;
      if (i >= L) i = 2 * (L - 1) - i;
      v = emphasized(w, i, len, has_pe, pe);
    }
    fr[idx] = v;
  }
  __syncthreads();

  // 2. power spectrum: one frequency bin per thread, all TILE frames
  const int two_f = 2 * n_freq;
  for (int k = threadIdx.x; k < n_freq; k += blockDim.x) {
    float re[TILE], im[TILE];
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) { re[tt] = 0.f; im[tt] = 0.f; }
    for (int n = 0; n < n_fft; ++n) {
      const float c = basis[(size_t)n * two_f + k];
      const float s = basis[(size_t)n * two_f + n_freq + k];
#pragma unroll
      for (int tt = 0; tt < TILE; ++tt) {
        const float f = fr[tt * n_fft + n];
        re[tt] = fmaf(f, c, re[tt]);
        im[tt] = fmaf(f, s, im[tt]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) {
      float p = re[tt] * re[tt] + im[tt] * im[tt];
      if (mag_spec) p = sqrtf(p);
      pw[tt * n_freq + k] = p;
    }
  }
  __syncthreads();

  // 3. mel product + clamp/log, zero beyond feat_len
  const int flen = feat_len[b];
  for (int idx = threadIdx.x; idx < TILE * n_mels; idx += blockDim.x) {
    const int tt = idx / n_mels;
    const int m = idx - tt * n_mels;
    const int t = t0 + tt;
    if (t >= T) continue;
    float acc = 0.f;
    const float* prow = pw + tt * n_freq;
    for (int k = 0; k < n_freq; ++k)
      acc = fmaf(prow[k], mel[(size_t)k * n_mels + m], acc);
    if (logging) acc = logf(fmaxf(acc, clamp)) / log_div;
    out[((size_t)b * T + t) * n_mels + m] = t < flen ? acc : 0.f;
  }
}

}  // namespace

extern "C" int logmel_forward(const float* wave, const int* wave_len,
                              const int* feat_len, const float* basis,
                              const float* mel, float* out, int B, int L,
                              int T, int n_fft, int hop, int n_freq,
                              int n_mels, int center, int has_pe, float pe,
                              int mag_spec, int logging, float clamp,
                              float log_div, void* stream) {
  const size_t smem = sizeof(float) * TILE * (size_t)(n_fft + n_freq);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, B);
  logmel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      wave, wave_len, feat_len, basis, mel, out, L, T, n_fft, hop, n_freq,
      n_mels, center, has_pe, pe, mag_spec, logging, clamp, log_div);
  return (int)cudaGetLastError();
}
