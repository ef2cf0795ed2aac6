// Fused waveform -> log-Mel kernels for Hopper (sm_90a), float32 throughout.
//
// Replaces speechain_tpu/ops/pallas_logmel.py::pallas_logmel (its
// pl.pallas_call at :110, body _logmel_kernel at :38): framing, window,
// DFT, power, mel product, clamp / log, with the spectrum kept on chip.
//
// What bounds it on the H100: float32 FMAs. At conformer-small's batch (16
// x 8 s, n_fft 400, 201 bins) the DFT is 12,816 frames x 80,400
// multiply-adds once folded (below), 0.031 ms at 67 TFLOP/s, against 13 MB
// of waveform and features (0.004 ms). It stays on the FMA units: TF32
// breaks the < 1e-4 log-Mel contract and split bf16 passes leave under 2x
// margin on it (PERF.md), so the design cuts the work and feeds the FMAs.
//
// - Fold. Where n_fft is even and the Hann window sits centred in it (n_fft
//   - win even), the padded window is symmetric about n_fft / 2 and is 0 at
//   n = 0, so with e[n] = x[n] + x[N - n], o[n] = x[n] - x[N - n] (e[N/2]
//   = x[N/2], o[N/2] = 0): re_k = sum_{n=1..N/2} e[n] C[n][k] and im_k =
//   sum o[n] S[n][k] over the basis rows 1..N/2 (C: w cos, S: -w sin; ops/
//   cuda_logmel.py lays them out). Other configs take the direct DFT, rows
//   0..N-1 with e = o = x[n], through the same code ("fold" is a flag).
// - Stage the waveform, not frames. A block owns TT = 8 TF consecutive
//   frames of one utterance and stages the samples they read once:
//   pre-emphasis, the length mask and the reflect centre padding applied
//   on the way; sample n of frame t sits at t S + n, S = min(hop, N).
// - Register tiles. Warp w owns frames w TF .. w TF + TF - 1, lane l the
//   bins 7 l .. 7 l + 6 of each pass of 224 bins; a thread sums TF x 7 re
//   and im in registers. Per basis row it reads its frames' e and o (the
//   warp's 8 columns: two 16-byte loads each, the same address in every
//   lane) and its 7 cos and 7 sin (four 16-byte loads): 8 shared loads per
//   14 TF multiply-adds.
// - Basis through cp.async. Rows come in chunks of KC, one chunk for the
//   whole block, through a two-slot ring, the next chunk in flight while
//   one is summed; e / o of a chunk's rows (and the low bins' samples) are
//   formed from the staged samples one chunk ahead into a second buffer,
//   loaded before the chunk's products and stored after them. One barrier
//   a chunk orders every fill before its first read.
// - Power, then a banded mel: the power tile stays in shared memory; each
//   mel filter is summed over its non-zero band [lo, hi) in ascending k,
//   then clamp, log, / log(base); frames at or beyond feat_len are 0.
// - Low bins as the plain version sums them. Folded, where a mel filter
//   weighs bins 0 .. 6, they are summed once more by the direct DFT, one
//   chain over rows 0 .. N - 1 in order, LR rows a chunk after the folded
//   products (thread (g, t) takes bins 2 g and 2 g + 1 of frame t; the fill
//   stages the rows' samples): pre-emphasis leaves them a power far below
//   the frame's, where float32 rounding decides the last digits of the
//   log, and the fold's rounding drifted 2.4e-4 from the plain version's
//   at mel bin 0 (PERF.md).
// No atomics: every output comes out of one fixed chain of sums.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using sct::cp_async16;
using sct::cp_async4;
using sct::cp_async_commit;
using sct::cp_async_wait;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TB = 7;                 // bins a lane in each pass
constexpr int BINS = 32 * TB;         // bins a pass
constexpr int ROW = 4 * 32 * 4;       // floats of one staged basis row of a
                                      // pass: groups cos 0-3, cos 4-6, sin
                                      // 0-3, sin 4-6 (+ a zero), 32 lanes x 4
constexpr int KC = 16;                // basis rows a ring chunk
constexpr int STAGES = 2;             // chunks in the ring
constexpr int EO_COLS = 8 * WARPS;    // e / o columns: 8 a warp
constexpr int EO_ROW = 2 * EO_COLS + 4;   // one row's e then o; the 4 spread
                                          // the fill's stores over the banks
constexpr int LOW_ROW = 16;           // floats of a low-basis row: cos of
                                      // bins 0-6, 0, -sin of bins 0-6, 0
constexpr int LR = 2 * KC;            // low-bin rows a chunk
constexpr int CH = KC * ROW + LR * LOW_ROW;   // floats of a staged chunk:
                                              // KC basis rows, LR low rows
constexpr int XS_ROW = EO_COLS + 1;   // floats of one row's samples of the
                                      // low bins, a column a frame

struct Params {
  const float* wave;      // (B, L)
  const int* wave_len;    // (B,)
  const int* feat_len;    // (B,)
  const float* basis;     // (passes, chunks, CH)
  const float* mel_w;     // (nnz,) the filters' band weights, in order
  const int* mel_band;    // (2 n_mels + 1,) each band's first bin, then
                          // the offsets of the bands in mel_w
  float* out;             // (B, T, n_mels)
  int L, T, N, hop, F, n_mels, nnz, rows, passes, fold, low, center,
      has_pe, mag_spec, logging;
  float pe, clamp, log_div;
};

__host__ __device__ constexpr long long round4(long long n) {
  return (n + 3) & ~3LL;
}

// floats of a block's dynamic shared memory, in order: the ring, two e / o
// chunks, the power tile (TT x F), the segment, where low two chunks of
// the low bins' samples (LR x XS_ROW), the band weights and the band
// table; each region rounded to 4 floats (16 bytes)
__host__ __device__ inline long long smem_floats(int tt, int S, int N, int F,
                                                 int low, int nnz,
                                                 int n_mels) {
  return (long long)STAGES * CH + 2 * KC * EO_ROW +
         round4((long long)tt * F) + round4((long long)(tt - 1) * S + N) +
         (low ? round4(2 * LR * XS_ROW) : 0) + round4(nnz) + 2 * n_mels + 1;
}

// The waveform index of position g of the padded signal (reflect padding
// excludes the edge sample, like numpy), clamped into the waveform; -1
// past the padded signal's end
__device__ __forceinline__ int wave_index(int g, int L, int pad) {
  if (g >= L + 2 * pad) return -1;
  int x = g - pad;
  if (x < 0) x = -x;
  if (x >= L) x = 2 * (L - 1) - x;
  return min(max(x, 0), L - 1);
}

// The staged sample at waveform index x from its value and its
// predecessor's: y = w[x] - pe w[x - 1], each rounded as the reference
// rounds it (no fused multiply-add), 0 from wave_len; 0 for x = -1
__device__ __forceinline__ float staged(float cur, float prev, int x,
                                        int len, const Params& p) {
  if (x < 0) return 0.f;
  if (!p.has_pe) return cur;
  return x < len ? __fsub_rn(cur, __fmul_rn(p.pe, x > 0 ? prev : 0.f)) : 0.f;
}

// re^2 + im^2 rounded as the plain version rounds it (no fused
// multiply-add), or its root
__device__ __forceinline__ float power(float re, float im, int mag_spec) {
  const float v = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  return mag_spec ? sqrtf(v) : v;
}

__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <int TF>
__global__ void __launch_bounds__(THREADS, 1)
logmel_tile(const Params p) {
  constexpr int TT = WARPS * TF;
  extern __shared__ float4 smem4[];
  const int N = p.N, S = min(p.hop, N);
  float* ring = reinterpret_cast<float*>(smem4);
  float* eo = ring + STAGES * CH;
  float* pw = eo + 2 * KC * EO_ROW;
  float* seg = pw + round4(TT * p.F);
  float* xs = seg + round4((TT - 1) * S + N);
  float* melw = xs + (p.low ? round4(2 * LR * XS_ROW) : 0);
  int* band = reinterpret_cast<int*>(melw + round4(p.nnz));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int flen = p.feat_len[b];
  const int nc = (p.rows + KC - 1) / KC;        // chunks a pass
  const int steps = p.passes * nc;

  // chunk s of the ring: pass s / nc, its rows KC (s % nc) .., then the
  // low bins' rows LR (s % nc) ..
  auto load = [&](int s) {
    const float* src = p.basis + (size_t)s * CH;
    float* dst = ring + (s % STAGES) * CH;
    for (int i = tid; i < CH / 4; i += THREADS)
      cp_async16(dst + 4 * i, src + 4 * i, true);
  };
  load(0);
  // with chunk 0: the mel tables
  for (int i = tid; i < p.nnz; i += THREADS)
    cp_async4(melw + i, p.mel_w + i, true);
  for (int i = tid; i < 2 * p.n_mels + 1; i += THREADS)
    cp_async4(band + i, p.mel_band + i, true);
  cp_async_commit();

  // the segment: sample i belongs to frame q = min(i / S, TT - 1) at
  // offset i - q S, position g of the padded signal. Each thread loads U
  // samples and their predecessors at once, then stages them.
  {
    const float* w = p.wave + (size_t)b * p.L;
    const int len = p.wave_len[b], pad = p.center ? N / 2 : 0;
    const int segn = (TT - 1) * S + N;
    constexpr int U = 24;
    for (int i0 = tid; i0 < segn; i0 += U * THREADS) {
      int x[U];
      float cur[U], prev[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS;
        // frames overlap or touch (S = hop): position t0 hop + i
        const int q = S == p.hop ? 0 : min(i / S, TT - 1);
        x[u] = i < segn ? wave_index((t0 + q) * p.hop + (i - q * S), p.L,
                                     pad)
                        : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cur[u] = __ldg(w + max(x[u], 0));
        prev[u] = __ldg(w + max(x[u] - 1, 0));
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * THREADS < segn)
          seg[i0 + u * THREADS] = staged(cur[u], prev[u], x[u], len, p);
    }
  }
  __syncthreads();                     // the segment is in place

  // e / o of chunk s's rows for every frame into buffer s % 2: entry i is
  // row KC (s % nc) + i % KC of frame i / KC, at column 8 (t / TF) + t % TF.
  // A thread loads its FE entries' samples before the chunk's products and
  // stores their e / o after them, so the loads' latency hides under them.
  // The low bins' rows LR s .. LR s + LR - 1 of chunk s: entry i is row
  // i % LR of frame i / LR, at column 8 (t / TF) + t % TF of xs.
  constexpr int FE = (KC * TT + THREADS - 1) / THREADS;
  constexpr int FX = (LR * TT + THREADS - 1) / THREADS;
  const bool low_rows = p.low != 0;
  float fa[FE], fr[FE], fx[FX];
  auto fill_load = [&](int s) {
    const int j0 = (s % nc) * KC;
    if (low_rows && s * LR < N)
#pragma unroll
      for (int u = 0; u < FX; ++u) {
        const int i = tid + u * THREADS, t = i / LR, n = s * LR + i - t * LR;
        fx[u] = i < LR * TT && n < N ? seg[t * S + n] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < FE; ++u) {
      const int i = tid + u * THREADS, t = i / KC, j = j0 + i - t * KC;
      const float* x = seg + t * S;
      fa[u] = fr[u] = 0.f;
      if (i < KC * TT) {
        if (p.fold) {                  // row j is n = j + 1
          if (j + 1 <= N / 2) fa[u] = x[j + 1];
          if (j + 1 < N / 2) fr[u] = x[N - j - 1];
        } else if (j < N) {
          fa[u] = fr[u] = x[j];
        }
      }
    }
  };
  auto fill_store = [&](int s) {
    const int j0 = (s % nc) * KC;
    float* dst = eo + (s & 1) * KC * EO_ROW;
    if (low_rows && s * LR < N)
#pragma unroll
      for (int u = 0; u < FX; ++u) {
        const int i = tid + u * THREADS, t = i / LR;
        if (i < LR * TT)
          xs[(s & 1) * LR * XS_ROW + (i - t * LR) * XS_ROW +
             (t / TF) * 8 + t % TF] = fx[u];
      }
#pragma unroll
    for (int u = 0; u < FE; ++u) {
      const int i = tid + u * THREADS, t = i / KC, jj = i - t * KC;
      if (i < KC * TT) {
        const int col = (t / TF) * 8 + t % TF;
        // folded: e = x[n] + x[N - n], o = x[n] - x[N - n], except e =
        // x[N/2], o = 0 at n = N / 2 (fr is 0 there); direct: e = o = x[n]
        dst[jj * EO_ROW + col] = p.fold ? fa[u] + fr[u] : fa[u];
        dst[jj * EO_ROW + EO_COLS + col] =
            p.fold ? (j0 + jj + 1 < N / 2 ? fa[u] - fr[u] : 0.f) : fr[u];
      }
    }
  };
  fill_load(0);
  fill_store(0);

  float re[TF][TB], im[TF][TB];
#pragma unroll
  for (int i = 0; i < TF; ++i)
#pragma unroll
    for (int k = 0; k < TB; ++k) re[i][k] = im[i][k] = 0.f;
  // the low bins' chains: thread q < 4 TT takes frame q % TT, bins 2 (q /
  // TT) and 2 (q / TT) + 1
  const int lt = tid % TT, lk = 2 * (tid / TT);
  const bool chains = low_rows && tid < 4 * TT;   // else its chains go unused
  const int lcol = (lt / TF) * 8 + lt % TF;
  float lre[2] = {}, lim[2] = {};

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();                   // chunk s and its e / o are in place;
                                       // chunk s - 1 is read by every warp
    if (s + 1 < steps) load(s + 1);    // into the slot chunk s - 1 used
    cp_async_commit();
    if (s + 1 < steps) fill_load(s + 1);
    // the chunk's KC basis rows and, folded with low bins, two of the low
    // bins' rows beside each (LR = 2 KC a chunk; the staged low rows are 0
    // past n_fft and past pass 0): one straight-line block, so that the
    // compiler interleaves the low chains' loads and multiply-adds with
    // the tile's. With low bins every warp sums (one whose frames lie past
    // T too: its threads own chains); without, only a warp with a frame
    // before T.
    const float* bs = ring + (s % STAGES) * CH + 4 * lane;
    const float* es = eo + (s & 1) * KC * EO_ROW + 8 * warp;
    const float* xr = xs + (s & 1) * LR * XS_ROW + lcol;
    const float* lb = ring + (s % STAGES) * CH + KC * ROW + lk;
    auto rows = [&](auto with_low) {
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        float ev[8], ov[8], c[8], sn[8];
        ld4(ev, es + jj * EO_ROW);
        ld4(ov, es + jj * EO_ROW + EO_COLS);
        if (TF > 4) {
          ld4(ev + 4, es + jj * EO_ROW + 4);
          ld4(ov + 4, es + jj * EO_ROW + EO_COLS + 4);
        }
        ld4(c, bs + jj * ROW);
        ld4(c + 4, bs + jj * ROW + 128);
        ld4(sn, bs + jj * ROW + 256);
        ld4(sn + 4, bs + jj * ROW + 384);
#pragma unroll
        for (int i = 0; i < TF; ++i)
#pragma unroll
          for (int k = 0; k < TB; ++k) {
            re[i][k] = fmaf(ev[i], c[k], re[i][k]);
            im[i][k] = fmaf(ov[i], sn[k], im[i][k]);
          }
        if constexpr (decltype(with_low)::value) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 2 * jj + h;
            const float x = xr[r * XS_ROW];
            const float2 lc =
                *reinterpret_cast<const float2*>(lb + r * LOW_ROW);
            const float2 ls = *reinterpret_cast<const float2*>(
                lb + r * LOW_ROW + LOW_ROW / 2);
            lre[0] = fmaf(x, lc.x, lre[0]);
            lim[0] = fmaf(x, ls.x, lim[0]);
            lre[1] = fmaf(x, lc.y, lre[1]);
            lim[1] = fmaf(x, ls.y, lim[1]);
          }
        }
      }
    };
    if (low_rows)
      rows(std::true_type{});
    else if (t0 + warp * TF < p.T)
      rows(std::false_type{});
    if (s + 1 < steps) fill_store(s + 1);   // into the buffers chunk s - 1
                                            // used
    if ((s + 1) % nc == 0) {           // the pass is done: its power
      const int k0 = (s / nc) * BINS + TB * lane;
#pragma unroll
      for (int i = 0; i < TF; ++i)
#pragma unroll
        for (int k = 0; k < TB; ++k) {
          if (k0 + k < p.F)
            pw[(warp * TF + i) * p.F + k0 + k] =
                power(re[i][k], im[i][k], p.mag_spec);
          re[i][k] = im[i][k] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the power tile is complete
  if (low_rows) {                      // the low bins' power, over the
    if (chains)                        // folded sums'
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (lk + u < TB)
          pw[lt * p.F + lk + u] = power(lre[u], lim[u], p.mag_spec);
    __syncthreads();
  }

  // banded mel product, clamp / log, zero beyond feat_len: thread r n_mels
  // + m takes filter m for frames r, r + R, .. (R rows of threads), MU of
  // them at once; each band summed in ascending bins
  const int nt = min(TT, p.T - t0);
  const int R = max(1, THREADS / p.n_mels);
  constexpr int MU = 4;
  for (int mi = tid; mi < p.n_mels * R; mi += THREADS) {
    const int m = mi % p.n_mels, r = mi / p.n_mels;
    const int lo = band[m], o0 = band[p.n_mels + m];
    const int cnt = band[p.n_mels + m + 1] - o0;
    for (int t = r; t < nt; t += MU * R) {
      float acc[MU] = {};
      for (int k = 0; k < cnt; ++k) {
        const float wk = melw[o0 + k];
#pragma unroll
        for (int u = 0; u < MU; ++u)
          if (t + u * R < nt)
            acc[u] = fmaf(pw[(t + u * R) * p.F + lo + k], wk, acc[u]);
      }
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int tu = t + u * R;
        if (tu >= nt) break;
        float v = acc[u];
        if (p.logging) v = logf(fmaxf(v, p.clamp)) / p.log_div;
        p.out[((size_t)b * p.T + t0 + tu) * p.n_mels + m] =
            t0 + tu < flen ? v : 0.f;
      }
    }
  }
}

template <int TF>
int launch(const Params& p, int B, cudaStream_t stream) {
  const long long smem =
      4 * smem_floats(WARPS * TF, min(p.hop, p.N), p.N, p.F, p.low, p.nnz,
                      p.n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_tile<TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + WARPS * TF - 1) / (WARPS * TF), B);
  logmel_tile<TF><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the built instances: frames a warp (ops/cuda_logmel.py FRAMES_PER_WARP)
bool built(int tf) {
  return tf == 2 || (tf >= 4 && tf <= 7);
}

}  // namespace

extern "C" {

// wave (B, L) float32 -> out (B, T, n_mels) float32 with the instance of
// tf frames a warp; basis, mel_w and mel_band as
// ops/cuda_logmel.py::kernel_constants lays them out; low (0 or TB) the
// bins summed again by the direct DFT. Refuses an instance that is not
// built.
int logmel_forward(const float* wave, const int* wave_len,
                   const int* feat_len, const float* basis,
                   const float* mel_w,
                   const int* mel_band, float* out,
                   int B, int L, int T,
                   int n_fft, int hop, int n_freq, int n_mels, int nnz,
                   int rows, int passes, int fold, int low, int center,
                   int has_pe, float pe, int mag_spec, int logging,
                   float clamp, float log_div, int tf, void* stream) {
  if (!built(tf) || rows < 1 || passes * BINS < n_freq ||
      (low != 0 && (low != TB || !fold || n_freq < TB || n_fft % 2)))
    return (int)cudaErrorInvalidValue;
  const Params p{wave, wave_len, feat_len, basis, mel_w,
                 mel_band, out, L, T, n_fft, hop, n_freq, n_mels, nnz, rows,
                 passes, fold, low, center, has_pe, mag_spec, logging, pe,
                 clamp, log_div};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tf) {
    case 2: return launch<2>(p, B, s);
    case 4: return launch<4>(p, B, s);
    case 5: return launch<5>(p, B, s);
    case 6: return launch<6>(p, B, s);
    default: return launch<7>(p, B, s);
  }
}

// The launch logmel_forward makes, for the smoke run to hold against the
// wrapper's reckoning: out = {grid x, grid y, threads, dynamic shared
// bytes}.
int logmel_layout(int tf, int B, int T, int n_fft, int hop, int n_freq,
                  int low, int nnz, int n_mels, long long* out) {
  if (!built(tf)) return (int)cudaErrorInvalidValue;
  const int tt = WARPS * tf;
  out[0] = (T + tt - 1) / tt;
  out[1] = B;
  out[2] = THREADS;
  out[3] = 4 * smem_floats(tt, min(hop, n_fft), n_fft, n_freq, low, nnz,
                           n_mels);
  return 0;
}

}  // extern "C"
