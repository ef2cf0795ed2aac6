// Standard multi-head attention for Hopper (sm_90a), forward and backward.
//
// Replaces speechain_tpu/ops/pallas_attention.py::flash_attention: the
// forward pl.pallas_call at :353 (body _std_fwd_kernel :250) and the
// backward at :384 (body _std_bwd_kernel :271):
//     s = (q k^T) * scale, key-masked and optionally causal (masked scores
//         are finfo(float32).min, so a fully masked row is uniform),
//     p = exp(s - max), den = sum p, o = (round(p * dropmask) v) / den;
//     backward: p = exp(s - M) / L, dv = round(p * keep)^T g,
//     dp = (g v^T) * keep, D_i = sum_k dp * p (over every key, masked ones
//     included), ds = round(p * (dp - D_i)), dq = ds k * scale,
//     dk = ds^T q * scale.
// q (B, Tq, D), k/v (B, Tk, D) in their projection layout: head h is the
// column slice [h * Dh, (h + 1) * Dh), Dh = D / H, so nothing is
// transposed.
//
// Head widths: every kernel is a template on its head width DH, built at
// DH = 32, 64, 96, 128, 192 and 256 (the recipes' widths: 64 for the ASR
// models and the LMs, 96 for the TTS benchmark, 128 for transformer-large,
// 192 for the FastSpeech2 recipes). A launch takes exactly these widths;
// any other is refused (cudaErrorInvalidValue). The wrapper
// (ops/cuda_flash_attention.py) runs a width Dh <= 256 that is a multiple
// of 8 on the smallest instance DH >= Dh by zero-padding each head's
// columns to DH (the zeros add nothing to any product) and slicing the
// output; it raises on any other width, naming it.
//
// What bounds it on the H100: the bytes, at the path's shapes. A bf16
// forward at transformer-wide training (B = 16, T = 199, 8 heads of 64)
// moves 13 MB of q/k/v/o (3.9 us at 3.35 TB/s) for 1.3 GFLOP of products
// (1.3 us at 989 TFLOP/s); the operations grow as T^2 and the bytes as T,
// so the operations bound it only from T ~ 590 (the backward from T ~ 410).
// Neither bound is near: the exact-maximum design recomputes q k^T in a
// second sweep and the backward forms p and dp in three, and every score
// costs ~40 FMA-unit instructions (mask, exp, the dropout hash, rounding)
// beside its 4 x Dh multiply-adds on the tensor cores; short query rows
// (the decoder's 31) leave the dq pass one block of 2 working warps per SM.
//
// bf16 design (flash_fwd_tc, flash_bwd_dq_tc, flash_bwd_dkdv_tc):
// - Products on the tensor cores: mma.sync m16n8k16, bf16 operands,
//   float32 sums, operands from shared memory by ldmatrix (.trans for the
//   value-side operand of p v, ds k, p^T g and ds^T q). One block of 4
//   warps per (64-query tile, head, utterance) in the forward and the dq
//   pass, per (64-key tile, head, utterance) in the dk/dv pass; each warp
//   owns 16 rows. Its q (and g) tile, or k and v in the dk/dv pass, stays
//   staged for the whole sweep, and ldmatrix reads each 16-wide k-step of
//   it just before the products that use it: held in registers, these
//   fragments cost the fourth block per SM (PERF.md, PR 5). Score
//   accumulators become the bf16 A fragments of the next product in
//   registers (mma.cuh), so p and ds never pass through shared memory.
// - Staging: 16-byte cp.async copies of 64 x DH tiles into a ring of two
//   slots, the next tile loading while the current one computes. A staged
//   row is padded by 16 bytes to DH + 8 values: with DH a multiple of 16
//   its stride is an odd number of 16-byte units, so the 8 rows an
//   ldmatrix reads fall in distinct bank groups. Every sweep streams its
//   key tiles, the second one too: holding a head's K and V whole between
//   the sweeps cost blocks per SM on long rows and saved nothing
//   measurable on short ones (PERF.md).
// - Occupancy by width: a warp's output accumulators are DH / 2 float32
//   registers a thread (acc[DH / 8][4]), and a block stages five (forward)
//   or six (backward) 64 x (DH + 8) tiles. The launch bounds ask for as
//   many blocks of 4 warps an SM as that shared memory allows: 4 up to
//   DH 64 (128 registers, <= 56 KB each); the forward 3 at DH 96 (170
//   registers) and the backward 2 there; 2 at DH 128 (255 registers); 1
//   from DH 192 (up to 203 KB of shared memory at DH 256). The dk/dv pass
//   holds two sets of accumulators (dk and dv); from DH 192 it runs as two
//   launches, one for dv (which needs no dp) and one for dk, each holding
//   one set. Warps whose 16 rows lie past the sequence only stage.
// - Exact maximum: the forward's first sweep finds each row's maximum and
//   the second forms p against it, so p is rounded at the TPU kernel's
//   point and not against a running maximum; the row maximum and
//   denominator are saved for the backward. The backward is a dq pass
//   (sweep A forms D_i, sweep B dq) and a dk/dv pass: deterministic,
//   without atomics.
// - Causal skip: key tiles past a query tile's last row (and, in the dk/dv
//   pass, query tiles before a key tile) hold only masked scores and are
//   skipped, unless a row of the block is fully masked: such a row is
//   uniform over all Tk keys, those past the diagonal included.
// - Per-score work on the FMA units: exp(s - M) is the SFU's exponential
//   (__expf) and the backward multiplies by 1 / L (a reciprocal per row,
//   per query column in the dk/dv pass) instead of dividing. __expf's
//   error grows with |s - M|: CUDA documents 2 ulps plus about 1.2 per
//   unit of |x|, so tens of float32 ulps (~1e-5 relative) at |s - M| ~ 20;
//   the reciprocal stays within 1.5 ulps of the quotient. Both lie far
//   below the bf16 roundings that follow, which are all kept. Together
//   they took a third off the backward's time on the H100 (PERF.md, PR 5).
// Dropout bits: common.cuh::dropout_bits, stream seed + b * H + h, element
// q * Tk + k, evaluated at each accumulator element's (row, column).
//
// float32 keeps the FMA-unit kernels (flash_fwd, flash_bwd_dq,
// flash_bwd_dkdv: 32 x 32 tiles staged as float32 in dynamic shared
// memory, 256 threads): float32 on the tensor cores means TF32, about
// three decimal digits, which breaks the 1e-4 contract a float32 step
// holds the card to against the CPU.

#include <float.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace sct;

constexpr int TS = 32;        // rows of a float32 query or key tile
constexpr float NEG_FILL = -FLT_MAX;   // finfo(float32).min

// fn(std::integral_constant<int, DH>) for the instance of head width dh;
// cudaErrorInvalidValue where no instance has that width
template <typename Fn>
int by_width(int dh, Fn fn) {
  switch (dh) {
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 192: return fn(std::integral_constant<int, 192>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

struct Drop {
  int on;
  unsigned int seed, thresh;
  float scale;
};

// ---- float32: FMA units, 32 x 32 tiles ----------------------------------

// rows [t0, t0 + TS) of head h of X (B, T, D) -> S[TS][DH + 1] float,
// zeros past T
template <int DH, typename T>
__device__ __forceinline__ void load_tile(float* S, const T* __restrict__ X,
                                          int b, int t0, int Tn, int D,
                                          int h) {
  for (int e = threadIdx.x; e < TS * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, t = t0 + r;
    S[r * (DH + 1) + d] =
        t < Tn ? to_f(X[((size_t)b * Tn + t) * D + h * DH + d]) : 0.f;
  }
}

// s[j] = A[r] . Bm[c0 + 8 j] over the head width; r = tid / 8, c0 = tid % 8
template <int DH>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          float s[4]) {
  constexpr int LD = DH + 1;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float a = A[r * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[j] = fmaf(a, Bm[(c0 + 8 * j) * LD + d], s[j]);
  }
}

// acc[j] += sum_c Pm[r][c] * V[c][c0 + 8 j], j < DH / 8
template <int DH>
__device__ __forceinline__ void tile_acc(const float* Pm, const float* V,
                                         float (&acc)[DH / 8]) {
  constexpr int LD = DH + 1;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 4
  for (int c = 0; c < TS; ++c) {
    const float p = Pm[r * LD + c];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      acc[j] = fmaf(p, V[c * LD + c0 + 8 * j], acc[j]);
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

// dynamic shared memory of the float32 kernels: 4 (forward) or 5
// (backward) staged tiles, and the dk/dv pass's 3 row vectors
template <int DH> constexpr size_t fp32_tile_bytes() {
  return sizeof(float) * TS * (DH + 1);
}
template <int DH> constexpr size_t fwd_fp32_smem() {
  return 4 * fp32_tile_bytes<DH>();
}
template <int DH> constexpr size_t dq_fp32_smem() {
  return 5 * fp32_tile_bytes<DH>();
}
template <int DH> constexpr size_t dkdv_fp32_smem() {
  return 5 * fp32_tile_bytes<DH>() + 3 * TS * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ kmask,
          T* __restrict__ out, float* __restrict__ Mo, float* __restrict__ Lo,
          int Tq, int Tk, int D, int H, float scale, int causal,
          Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float fsm[];
  float *Qs = fsm, *Ks = Qs + TS * LD, *Vs = Ks + TS * LD, *Ps = Vs + TS * LD;
  const int q0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, qg = q0 + r;
  load_tile<DH>(Qs, q, b, q0, Tq, D, h);

  float m = -INFINITY, s[4];
  for (int k0 = 0; k0 < Tk; k0 += TS) {
    __syncthreads();
    load_tile<DH>(Ks, k, b, k0, Tk, D, h);
    __syncthreads();
    tile_dots<DH>(Qs, Ks, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + c0 + 8 * j;
      if (kg < Tk)
        m = fmaxf(m, masked(s[j], scale, kmask, b, Tk, qg, kg, causal));
    }
  }
  m = row_max(m);

  float l = 0.f, acc[DH / 8] = {};
  for (int k0 = 0; k0 < Tk; k0 += TS) {
    __syncthreads();
    load_tile<DH>(Ks, k, b, k0, Tk, D, h);
    load_tile<DH>(Vs, v, b, k0, Tk, D, h);
    __syncthreads();
    tile_dots<DH>(Qs, Ks, s);
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
    tile_acc<DH>(Ps, Vs, acc);
  }
  l = row_sum(l);
  if (qg < Tq) {
    T* o = out + ((size_t)b * Tq + qg) * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      o[c0 + 8 * j] = from_f<T>(acc[j] / l);
    if (c0 == 0) {
      Mo[((size_t)b * H + h) * Tq + qg] = m;
      Lo[((size_t)b * H + h) * Tq + qg] = l;
    }
  }
}

// dq = (ds_c k) * scale per query tile; also D_i = sum_k dp * p
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kmask,
             const T* __restrict__ g, const float* __restrict__ Mi,
             const float* __restrict__ Li, float* __restrict__ Do,
             T* __restrict__ dq, int Tq, int Tk, int D, int H,
             float scale, int causal, Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float fsm[];
  float *Qs = fsm, *Gs = Qs + TS * LD, *Ks = Gs + TS * LD, *Vs = Ks + TS * LD,
        *Ps = Vs + TS * LD;
  const int q0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, qg = q0 + r;
  const size_t row = ((size_t)b * H + h) * Tq + qg;
  const float m = qg < Tq ? Mi[row] : 0.f;
  const float l = qg < Tq ? Li[row] : 1.f;
  load_tile<DH>(Qs, q, b, q0, Tq, D, h);
  load_tile<DH>(Gs, g, b, q0, Tq, D, h);

  float s[4], dpt[4], di = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    float acc[DH / 8] = {};
    for (int k0 = 0; k0 < Tk; k0 += TS) {
      __syncthreads();
      load_tile<DH>(Ks, k, b, k0, Tk, D, h);
      load_tile<DH>(Vs, v, b, k0, Tk, D, h);
      __syncthreads();
      tile_dots<DH>(Qs, Ks, s);
      tile_dots<DH>(Gs, Vs, dpt);
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
        tile_acc<DH>(Ps, Ks, acc);
      }
    }
    if (pass == 0) {
      di = row_sum(di);
    } else if (qg < Tq) {
      T* o = dq + ((size_t)b * Tq + qg) * D + h * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        o[c0 + 8 * j] = from_f<T>(acc[j] * scale);
      if (c0 == 0) Do[row] = di;
    }
  }
}

// dv = p~_c^T g and dk = (ds_c^T q) * scale per key tile
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kmask,
               const T* __restrict__ g, const float* __restrict__ Mi,
               const float* __restrict__ Li, const float* __restrict__ Di,
               T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int D,
               int H, float scale, int causal, Drop dr) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float fsm[];
  float *Ks = fsm, *Vs = Ks + TS * LD, *Qs = Vs + TS * LD, *Gs = Qs + TS * LD,
        *Ps = Gs + TS * LD;
  float *Ms = Ps + TS * LD, *Ls = Ms + TS, *Ds = Ls + TS;
  const int k0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7, kg = k0 + r;
  load_tile<DH>(Ks, k, b, k0, Tk, D, h);
  load_tile<DH>(Vs, v, b, k0, Tk, D, h);

  float dka[DH / 8] = {}, dva[DH / 8] = {}, s[4], dpt[4], ds[4];
  for (int q0 = 0; q0 < Tq; q0 += TS) {
    __syncthreads();
    load_tile<DH>(Qs, q, b, q0, Tq, D, h);
    load_tile<DH>(Gs, g, b, q0, Tq, D, h);
    if (threadIdx.x < TS) {
      const int qq = q0 + threadIdx.x;
      const size_t row = ((size_t)b * H + h) * Tq + qq;
      Ms[threadIdx.x] = qq < Tq ? Mi[row] : 0.f;
      Ls[threadIdx.x] = qq < Tq ? Li[row] : 1.f;
      Ds[threadIdx.x] = qq < Tq ? Di[row] : 0.f;
    }
    __syncthreads();
    tile_dots<DH>(Ks, Qs, s);
    tile_dots<DH>(Vs, Gs, dpt);
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
    tile_acc<DH>(Ps, Gs, dva);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[r * LD + c0 + 8 * j] = ds[j];
    __syncthreads();
    tile_acc<DH>(Ps, Qs, dka);
  }
  if (kg < Tk) {
    const size_t o = ((size_t)b * Tk + kg) * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dk[o + c0 + 8 * j] = from_f<T>(dka[j] * scale);
      dv[o + c0 + 8 * j] = from_f<T>(dva[j]);
    }
  }
}

// ---- bf16: the products on the tensor cores -----------------------------

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;              // rows of a query or key tile
constexpr int TC = 128;             // threads: 4 warps of 16 rows

// a staged 64 x DH bf16 tile: rows padded to LDS values (the 16-byte pad
// puts the 8 rows an ldmatrix reads in 8 distinct bank groups), TE
// elements, TB bytes
template <int DH> struct Tile {
  static_assert(DH % 16 == 0, "head width instances are multiples of 16");
  static constexpr int LDS = DH + 8;
  static constexpr int TE = BT * LDS;
  static constexpr size_t TB = (size_t)TE * 2;
};

// blocks an SM that the launch bounds ask for, as many as the shared
// memory lets share an SM: the forward (5 staged tiles), and the dq and
// dk/dv passes (6; the dk/dv pass holds two accumulator sets)
constexpr int fwd_blocks(int dh) {
  return dh <= 64 ? 4 : dh <= 96 ? 3 : dh <= 128 ? 2 : 1;
}
constexpr int bwd_blocks(int dh) {
  return dh <= 64 ? 4 : dh <= 128 ? 2 : 1;
}
// the dk/dv pass's parts: both sets in one launch up to DH 128, else dv
// (DV) and dk (DK) in two
constexpr int DV = 1, DK = 2;

// rows [t0, t0 + 64) of head h of X (B, Tn, D) -> S (64 x LDS), by
// 16-byte cp.async copies; rows past Tn are zeros
template <int DH>
__device__ __forceinline__ void stage(bf16* S, const bf16* __restrict__ X,
                                      int b, int t0, int Tn, int D,
                                      int h) {
  constexpr unsigned CH = DH / 8;     // 16-byte chunks of a row
  // unsigned: a power-of-two CH divides by a shift, and c < DH is known
  for (unsigned e = threadIdx.x; e < BT * CH; e += TC) {
    const int r = e / CH, c = (e % CH) * 8, t = t0 + r;
    const bool ok = t < Tn;
    cp_async16(S + r * Tile<DH>::LDS + c,
               X + ((size_t)b * Tn + (ok ? t : 0)) * D + h * DH + c, ok);
  }
}

// 64 entries from row t0 of a (rows of length Tn) float vector -> S, zeros
// past Tn
__device__ __forceinline__ void stage_row(float* S,
                                          const float* __restrict__ X,
                                          int t0, int Tn) {
  for (int e = threadIdx.x; e < BT; e += TC) {
    const bool ok = t0 + e < Tn;
    cp_async4(S + e, X + (ok ? t0 + e : 0), ok);
  }
}

// kb[t] bit c: key 64 t + c exists and the key mask keeps it
__device__ __forceinline__ void key_bits(unsigned long long* kb,
                                         const int* __restrict__ kmask,
                                         int b, int Tk, int ntk) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < ntk; t += TC / 32) {
    const int k0 = t * BT + lane, k1 = k0 + 32;
    const bool v0 = k0 < Tk &&
                    (kmask == nullptr || kmask[(size_t)b * Tk + k0] != 0);
    const bool v1 = k1 < Tk &&
                    (kmask == nullptr || kmask[(size_t)b * Tk + k1] != 0);
    const unsigned lo = __ballot_sync(0xffffffffu, v0);
    const unsigned hi = __ballot_sync(0xffffffffu, v1);
    if (lane == 0) kb[t] = lo | ((unsigned long long)hi << 32);
  }
}

// s = A Bt[c0 .. c0 + 32)^T over the head width: A this warp's 16 rows of
// staged tile At, Bt a staged tile whose rows are s's columns. The A
// fragment of each 16-wide k-step is read by ldmatrix just before its
// products, so 4 registers of it are live, not DH / 4.
template <int DH>
__device__ __forceinline__ void scores(float (&s)[4][4], const bf16* At,
                                       const bf16* Bt, int c0) {
  constexpr int LDS = Tile<DH>::LDS;
  warp_scores<DH, 4>(s, At + 16 * (threadIdx.x >> 5) * LDS, Bt + c0 * LDS);
}

// acc += P Vt[c0 .. c0 + 32): P this warp's 16 x 32 (2 k-steps of A
// fragments), Vt a staged tile (rows: P's columns; the head width along
// the row), read transposed
template <int DH>
__device__ __forceinline__ void acc_pv(float (&acc)[DH / 8][4],
                                       const uint32_t (&pf)[2][4],
                                       const bf16* Vt, int c0) {
  warp_acc<DH, 2>(acc, pf, Vt + c0 * Tile<DH>::LDS);
}

// row r (0 or 1: rows g and g + 8) of this lane's accumulators, divided
// by x (DIV) or multiplied by it, as bf16 pairs at o + 8 n + its column
// pair
template <int DH, bool DIV>
__device__ __forceinline__ void store_rows(bf16* o,
                                           const float (&acc)[DH / 8][4],
                                           int r, float x) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const float a0 = acc[n][2 * r], a1 = acc[n][2 * r + 1];
    *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
        DIV ? __floats2bfloat162_rn(a0 / x, a1 / x)
            : __floats2bfloat162_rn(a0 * x, a1 * x);
  }
}

// the scaled score of a fragment element, finfo(float32).min where masked
__device__ __forceinline__ float mask_score(float dot, float scale,
                                            bool masked) {
  return masked ? NEG_FILL : dot * scale;
}

__device__ __forceinline__ float keep_at(const Drop& dr, unsigned int sd,
                                         int qg, int Tk, int kg) {
  if (!dr.on) return 1.f;
  return dropout_keep((unsigned int)qg * (unsigned int)Tk + (unsigned int)kg,
                      sd, dr.thresh, dr.scale);
}

// Accumulator element i of n-tile n of a 16 x 32 chunk at column c0 of a
// tile: row 16 w + lane / 4 + 8 (i / 2), column c0 + 8 n + 2 (lane % 4) +
// i % 2 (mma.cuh).

template <int DH>
__global__ void __launch_bounds__(TC, fwd_blocks(DH))
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ kmask,
             bf16* __restrict__ out, float* __restrict__ Mo,
             float* __restrict__ Lo, int Tq, int Tk, int D, int H,
             float scale, int causal, Drop dr) {
  constexpr int TE = Tile<DH>::TE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntk = (Tk + BT - 1) / BT;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TE;                  // 2 slots
  bf16* Vs = Ks + 2 * TE;              // 2 slots
  unsigned long long* kb =
      reinterpret_cast<unsigned long long*>(Vs + 2 * TE);
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = q0 + 16 * w + (lane >> 2), cl = 2 * (lane & 3);
  const bool live = q0 + 16 * w < Tq;        // a warp past Tq only stages
  const unsigned int sd = dr.seed + (unsigned int)(b * H + h);

  key_bits(kb, kmask, b, Tk, ntk);
  stage<DH>(Qs, q, b, q0, Tq, D, h);
  // causal: key tiles past the block's last row hold only masked scores
  const int nt1 =
      causal ? min(ntk, (min(q0 + BT, Tq) - 1) / BT + 1) : ntk;

  // sweep 1: each row's exact maximum
  float m[2] = {-INFINITY, -INFINITY};
  sweep(
      nt1,
      [&](int j) { stage<DH>(Ks + (j & 1) * TE, k, b, j * BT, Tk, D, h); },
      [&](int j) {
        if (!live) return;
        const bf16* Kt = Ks + (j & 1) * TE;
        const unsigned long long bits = kb[j];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s[4][4];
          scores<DH>(s, Qs, Kt, 32 * c);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int kc = 32 * c + 8 * n + cl + (i & 1), kg = j * BT + kc;
              const int row = r0 + 8 * (i >> 1);
              if (kg < Tk)
                m[i >> 1] = fmaxf(
                    m[i >> 1],
                    mask_score(s[n][i], scale,
                               !((bits >> kc) & 1) || (causal && kg > row)));
            }
        }
      });
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  // A row whose every score is masked is uniform over all Tk keys, those
  // past the diagonal included: such a row turns the causal skip off.
  const bool empty = (r0 < Tq && m[0] == NEG_FILL) ||
                     (r0 + 8 < Tq && m[1] == NEG_FILL);
  const int nt2 = __syncthreads_or(empty) ? ntk : nt1;

  // sweep 2: p = exp(s - m), den = sum p, acc += round(p * keep) v
  float acc[DH / 8][4] = {}, l[2] = {0.f, 0.f};
  sweep(
      nt2,
      [&](int j) {
        stage<DH>(Ks + (j & 1) * TE, k, b, j * BT, Tk, D, h);
        stage<DH>(Vs + (j & 1) * TE, v, b, j * BT, Tk, D, h);
      },
      [&](int j) {
        if (!live) return;
        const bf16 *Kt = Ks + (j & 1) * TE, *Vt = Vs + (j & 1) * TE;
        const unsigned long long bits = kb[j];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s[4][4];
          scores<DH>(s, Qs, Kt, 32 * c);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int kc = 32 * c + 8 * n + cl + (i & 1), kg = j * BT + kc;
              const int row = r0 + 8 * (i >> 1);
              float pk = 0.f;
              if (kg < Tk) {
                const float p = __expf(
                    mask_score(s[n][i], scale,
                               !((bits >> kc) & 1) || (causal && kg > row)) -
                    m[i >> 1]);
                l[i >> 1] += p;
                pk = p * keep_at(dr, sd, row, Tk, kg);
              }
              s[n][i] = pk;
            }
          uint32_t pf[2][4];
          to_a(pf, s);
          acc_pv<DH>(acc, pf, Vt, 32 * c);
        }
      });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const int row = r0 + 8 * r;
    if (row >= Tq) continue;
    store_rows<DH, true>(out + ((size_t)b * Tq + row) * D + h * DH + cl, acc,
                         r, den);
    if ((lane & 3) == 0) {
      Mo[((size_t)b * H + h) * Tq + row] = m[r];
      Lo[((size_t)b * H + h) * Tq + row] = den;
    }
  }
}

// p and dp (= (g v^T) * keep) of a 16 x 32 chunk at column c0 of key tile
// j, in place of the scores s and dp; zero past Tq or Tk
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      int j, int c0, unsigned long long bits,
                                      int r0, int cl, int Tq, int Tk,
                                      float scale, int causal, float m0,
                                      float m1, float rl0, float rl1,
                                      const Drop& dr, unsigned int sd) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = c0 + 8 * n + cl + (i & 1), kg = j * BT + kc;
      const int row = r0 + 8 * (i >> 1);
      float p = 0.f, d = 0.f;
      if (kg < Tk && row < Tq) {
        p = __expf(mask_score(s[n][i], scale,
                              !((bits >> kc) & 1) || (causal && kg > row)) -
                   (i < 2 ? m0 : m1)) *
            (i < 2 ? rl0 : rl1);
        d = dp[n][i] * keep_at(dr, sd, row, Tk, kg);
      }
      s[n][i] = p;
      dp[n][i] = d;
    }
}

// dq = (ds k) * scale per query tile, with D_i = sum_k dp * p from a first
// sweep; ds = round(p * (dp - D_i)), p = exp(s - M) / L in float32
template <int DH>
__global__ void __launch_bounds__(TC, bwd_blocks(DH))
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ kmask,
                const bf16* __restrict__ g, const float* __restrict__ Mi,
                const float* __restrict__ Li, float* __restrict__ Do,
                bf16* __restrict__ dq, int Tq, int Tk, int D, int H,
                float scale, int causal, Drop dr) {
  constexpr int TE = Tile<DH>::TE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntk = (Tk + BT - 1) / BT;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + TE;
  bf16* Ks = Gs + TE;                  // 2 slots
  bf16* Vs = Ks + 2 * TE;              // 2 slots
  unsigned long long* kb =
      reinterpret_cast<unsigned long long*>(Vs + 2 * TE);
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = q0 + 16 * w + (lane >> 2), cl = 2 * (lane & 3);
  const unsigned int sd = dr.seed + (unsigned int)(b * H + h);
  const size_t st = ((size_t)b * H + h) * Tq;
  const bool live = q0 + 16 * w < Tq;        // a warp past Tq only stages
  const bool ok0 = r0 < Tq, ok1 = r0 + 8 < Tq;
  const float m0 = ok0 ? Mi[st + r0] : 0.f, m1 = ok1 ? Mi[st + r0 + 8] : 0.f;
  const float rl0 = ok0 ? 1.f / Li[st + r0] : 1.f;        // 1 / L
  const float rl1 = ok1 ? 1.f / Li[st + r0 + 8] : 1.f;
  key_bits(kb, kmask, b, Tk, ntk);
  stage<DH>(Qs, q, b, q0, Tq, D, h);
  stage<DH>(Gs, g, b, q0, Tq, D, h);
  const bool empty = (ok0 && m0 == NEG_FILL) || (ok1 && m1 == NEG_FILL);
  const int nt = (causal && !__syncthreads_or(empty))
                     ? min(ntk, (min(q0 + BT, Tq) - 1) / BT + 1)
                     : ntk;

  auto load_kv = [&](int j) {
    stage<DH>(Ks + (j & 1) * TE, k, b, j * BT, Tk, D, h);
    stage<DH>(Vs + (j & 1) * TE, v, b, j * BT, Tk, D, h);
  };

  // sweep A: D_i
  float di0 = 0.f, di1 = 0.f;
  sweep(nt, load_kv, [&](int j) {
    if (!live) return;
    const int sl = j & 1;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s[4][4], dp[4][4];
      scores<DH>(s, Qs, Ks + sl * TE, 32 * c);
      scores<DH>(dp, Gs, Vs + sl * TE, 32 * c);
      probs(s, dp, j, 32 * c, kb[j], r0, cl, Tq, Tk, scale, causal, m0, m1,
            rl0, rl1, dr, sd);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        di0 += dp[n][0] * s[n][0] + dp[n][1] * s[n][1];
        di1 += dp[n][2] * s[n][2] + dp[n][3] * s[n][3];
      }
    }
  });
  di0 = quad_sum(di0);
  di1 = quad_sum(di1);

  // sweep B: acc += ds k
  float acc[DH / 8][4] = {};
  sweep(nt, load_kv, [&](int j) {
    if (!live) return;
    const int sl = j & 1;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s[4][4], dp[4][4];
      scores<DH>(s, Qs, Ks + sl * TE, 32 * c);
      scores<DH>(dp, Gs, Vs + sl * TE, 32 * c);
      probs(s, dp, j, 32 * c, kb[j], r0, cl, Tq, Tk, scale, causal, m0, m1,
            rl0, rl1, dr, sd);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] *= dp[n][i] - (i < 2 ? di0 : di1);
      uint32_t sf[2][4];
      to_a(sf, s);
      acc_pv<DH>(acc, sf, Ks + sl * TE, 32 * c);
    }
  });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Tq) continue;
    store_rows<DH, false>(dq + ((size_t)b * Tq + row) * D + h * DH + cl, acc,
                          r, scale);
    if ((lane & 3) == 0) Do[st + row] = r == 0 ? di0 : di1;
  }
}

// dv = round(p * keep)^T g and dk = (ds^T q) * scale per key tile: the
// block's warps own 16 keys each and sweep the query tiles; products are
// formed transposed (rows: keys, columns: queries). PART says which of dv
// (DV) and dk (DK) this launch forms; dv alone needs no dp.
template <int DH, int PART>
__global__ void __launch_bounds__(TC, bwd_blocks(DH))
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ kmask,
                  const bf16* __restrict__ g, const float* __restrict__ Mi,
                  const float* __restrict__ Li, const float* __restrict__ Di,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq,
                  int Tk, int D, int H, float scale, int causal, Drop dr) {
  constexpr int TE = Tile<DH>::TE;
  constexpr bool WANT_DV = PART & DV, WANT_DK = PART & DK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;                  // 2 slots
  bf16* Gs = Qs + 2 * TE;              // 2 slots
  float* Ss = reinterpret_cast<float*>(Gs + 2 * TE);   // [slot][M, L, D][64]
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int kr0 = k0 + 16 * w + (lane >> 2), cl = 2 * (lane & 3);
  const bool live = k0 + 16 * w < Tk;        // a warp past Tk only stages
  const unsigned int sd = dr.seed + (unsigned int)(b * H + h);
  const size_t st = ((size_t)b * H + h) * Tq;
  const int ntq = (Tq + BT - 1) / BT;
  bool kok[2], kmasked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kg = kr0 + 8 * r;
    kok[r] = kg < Tk;
    kmasked[r] = kok[r] && kmask != nullptr &&
                 kmask[(size_t)b * Tk + kg] == 0;
  }
  // causal: query tiles before this key tile see none of its keys, unless
  // one of their rows is fully masked (uniform over all keys)
  int t0 = 0;
  if (causal) {
    bool empty = false;
    for (int t = threadIdx.x; t < min(k0, Tq); t += TC)
      empty |= Mi[st + t] == NEG_FILL;
    t0 = __syncthreads_or(empty) ? 0 : blockIdx.x;
  }
  stage<DH>(Ks, k, b, k0, Tk, D, h);
  stage<DH>(Vs, v, b, k0, Tk, D, h);

  float dka[WANT_DK ? DH / 8 : 1][4] = {}, dva[WANT_DV ? DH / 8 : 1][4] = {};
  sweep(
      ntq - t0,
      [&](int jj) {
        const int j = t0 + jj, sl = jj & 1;
        stage<DH>(Qs + sl * TE, q, b, j * BT, Tq, D, h);
        stage<DH>(Gs + sl * TE, g, b, j * BT, Tq, D, h);
        stage_row(Ss + (3 * sl + 0) * BT, Mi + st, j * BT, Tq);
        stage_row(Ss + (3 * sl + 1) * BT, Li + st, j * BT, Tq);
        stage_row(Ss + (3 * sl + 2) * BT, Di + st, j * BT, Tq);
      },
      [&](int jj) {
        const int j = t0 + jj, sl = jj & 1;
        const float *Ms = Ss + 3 * sl * BT, *Ds = Ms + 2 * BT;
        float* Ls = Ss + (3 * sl + 1) * BT;         // L, then 1 / L
        if (threadIdx.x < BT) Ls[threadIdx.x] = 1.f / Ls[threadIdx.x];
        __syncthreads();
        if (!live) return;
        const bf16 *Qt = Qs + sl * TE, *Gt = Gs + sl * TE;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s[4][4], dp[4][4];
          scores<DH>(s, Ks, Qt, 32 * c);
          if constexpr (WANT_DK) scores<DH>(dp, Vs, Gt, 32 * c);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int qc = 32 * c + 8 * n + cl + (i & 1), qg = j * BT + qc;
              const int r = i >> 1, kg = kr0 + 8 * r;
              float pt = 0.f, ds = 0.f;
              if (qg < Tq && kok[r]) {
                const float p =
                    __expf(mask_score(s[n][i], scale,
                                      kmasked[r] || (causal && kg > qg)) -
                           Ms[qc]) *
                    Ls[qc];
                const float kp = keep_at(dr, sd, qg, Tk, kg);
                pt = p * kp;
                if constexpr (WANT_DK) ds = p * (dp[n][i] * kp - Ds[qc]);
              }
              s[n][i] = pt;
              dp[n][i] = ds;
            }
          uint32_t pf[2][4], sf[2][4];
          if constexpr (WANT_DV) to_a(pf, s);
          if constexpr (WANT_DK) to_a(sf, dp);
          if constexpr (WANT_DV) acc_pv<DH>(dva, pf, Gt, 32 * c);
          if constexpr (WANT_DK) acc_pv<DH>(dka, sf, Qt, 32 * c);
        }
      });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!kok[r]) continue;
    const size_t o = ((size_t)b * Tk + kr0 + 8 * r) * D + h * DH + cl;
    if constexpr (WANT_DK) store_rows<DH, false>(dk + o, dka, r, scale);
    if constexpr (WANT_DV) store_rows<DH, false>(dv + o, dva, r, 1.f);
  }
}

// dynamic shared memory of the bf16 kernels: a q tile (and a g tile in the
// dq pass), two K and two V slots, 8 bytes of key-mask bits per key tile;
// the dk/dv pass's k and v tiles, two slots of q and g tiles and of the 64
// row statistics M, L and D
template <int DH> size_t fwd_tc_smem(int ntk) {
  return 5 * Tile<DH>::TB + 8 * (size_t)ntk;
}
template <int DH> size_t dq_tc_smem(int ntk) {
  return 6 * Tile<DH>::TB + 8 * (size_t)ntk;
}
template <int DH> constexpr size_t dkdv_tc_smem() {
  return 6 * Tile<DH>::TB + 2 * 3 * BT * sizeof(float);
}

// the launch arguments every entry point passes on
struct Args {
  int B, Tq, Tk, D, H;
  float scale;
  int causal;
  Drop dr;
  cudaStream_t s;
};

template <int DH>
int forward_fp32(const void* q, const void* k, const void* v, const int* kmask,
                 void* out, float* M, float* L, const Args& a) {
  static SmemSet set;
  constexpr size_t smem = fwd_fp32_smem<DH>();
  cudaError_t err = allow_smem(flash_fwd<float, DH>, smem, set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd<float, DH><<<dim3((a.Tq + TS - 1) / TS, a.H, a.B), THREADS, smem,
                         a.s>>>(
      (const float*)q, (const float*)k, (const float*)v, kmask, (float*)out,
      M, L, a.Tq, a.Tk, a.D, a.H, a.scale, a.causal, a.dr);
  return (int)cudaGetLastError();
}

template <int DH>
int backward_fp32(const void* q, const void* k, const void* v,
                  const int* kmask, const void* g, const float* M,
                  const float* L, float* Dsum, void* dq, void* dk, void* dv,
                  const Args& a) {
  static SmemSet dq_set, dkdv_set;
  constexpr size_t dq_smem = dq_fp32_smem<DH>();
  constexpr size_t dkdv_smem = dkdv_fp32_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dq<float, DH>, dq_smem, dq_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<float, DH><<<dim3((a.Tq + TS - 1) / TS, a.H, a.B), THREADS,
                            dq_smem, a.s>>>(
      (const float*)q, (const float*)k, (const float*)v, kmask,
      (const float*)g, M, L, Dsum, (float*)dq, a.Tq, a.Tk, a.D, a.H,
      a.scale, a.causal, a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = allow_smem(flash_bwd_dkdv<float, DH>, dkdv_smem, dkdv_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<float, DH><<<dim3((a.Tk + TS - 1) / TS, a.H, a.B), THREADS,
                              dkdv_smem, a.s>>>(
      (const float*)q, (const float*)k, (const float*)v, kmask,
      (const float*)g, M, L, Dsum, (float*)dk, (float*)dv, a.Tq, a.Tk, a.D,
      a.H, a.scale, a.causal, a.dr);
  return (int)cudaGetLastError();
}

template <int DH>
int forward_bf16(const void* q, const void* k, const void* v,
                 const int* kmask, void* out, float* M, float* L,
                 const Args& a) {
  static SmemSet set;
  const size_t smem = fwd_tc_smem<DH>((a.Tk + BT - 1) / BT);
  cudaError_t err = allow_smem(flash_fwd_tc<DH>, smem, set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc<DH><<<dim3((a.Tq + BT - 1) / BT, a.H, a.B), TC, smem,
                            a.s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kmask, (bf16*)out, M,
      L, a.Tq, a.Tk, a.D, a.H, a.scale, a.causal, a.dr);
  return (int)cudaGetLastError();
}

template <int DH, int PART>
int dkdv_bf16(const void* q, const void* k, const void* v, const int* kmask,
              const void* g, const float* M, const float* L,
              const float* Dsum, void* dk, void* dv, const Args& a) {
  static SmemSet set;
  constexpr size_t smem = dkdv_tc_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_tc<DH, PART>, smem, set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_tc<DH, PART><<<dim3((a.Tk + BT - 1) / BT, a.H, a.B),
                                       TC, smem, a.s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kmask, (const bf16*)g,
      M, L, Dsum, (bf16*)dk, (bf16*)dv, a.Tq, a.Tk, a.D, a.H, a.scale,
      a.causal, a.dr);
  return (int)cudaGetLastError();
}

template <int DH>
int backward_bf16(const void* q, const void* k, const void* v,
                  const int* kmask, const void* g, const float* M,
                  const float* L, float* Dsum, void* dq, void* dk, void* dv,
                  const Args& a) {
  static SmemSet set;
  const size_t smem = dq_tc_smem<DH>((a.Tk + BT - 1) / BT);
  cudaError_t err = allow_smem(flash_bwd_dq_tc<DH>, smem, set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tc<DH><<<dim3((a.Tq + BT - 1) / BT, a.H, a.B), TC,
                               smem, a.s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kmask, (const bf16*)g,
      M, L, Dsum, (bf16*)dq, a.Tq, a.Tk, a.D, a.H, a.scale, a.causal,
      a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (DH <= 128) {
    return dkdv_bf16<DH, DV | DK>(q, k, v, kmask, g, M, L, Dsum, dk,
                                         dv, a);
  } else {
    const int e = dkdv_bf16<DH, DV>(q, k, v, kmask, g, M, L, Dsum, dk,
                                           dv, a);
    if (e) return e;
    return dkdv_bf16<DH, DK>(q, k, v, kmask, g, M, L, Dsum, dk, dv,
                                    a);
  }
}

// the shared memory of one width's kernels (see flash_attention_smem)
template <int DH>
int smem_fp32(long long* out) {
  cudaError_t err = smem_of(flash_fwd<float, DH>, fwd_fp32_smem<DH>(), out);
  if (err == cudaSuccess)
    err = smem_of(flash_bwd_dq<float, DH>, dq_fp32_smem<DH>(), out + 1);
  if (err == cudaSuccess)
    err = smem_of(flash_bwd_dkdv<float, DH>, dkdv_fp32_smem<DH>(), out + 2);
  return (int)err;
}

template <int DH>
int smem_bf16(int ntk, long long* out) {
  cudaError_t err =
      smem_of(flash_fwd_tc<DH>, fwd_tc_smem<DH>(ntk), out);
  if (err == cudaSuccess)
    err = smem_of(flash_bwd_dq_tc<DH>, dq_tc_smem<DH>(ntk), out + 1);
  if (err == cudaSuccess)
    err = smem_of(flash_bwd_dkdv_tc<DH, (DH <= 128 ? DV | DK : DK)>,
                  dkdv_tc_smem<DH>(), out + 2);
  return (int)err;
}

// the head width of a launch; 0 unless D = H * dh (by_width refuses a dh
// no instance has)
int head_width(int D, int H) {
  return H > 0 && D % H == 0 ? D / H : 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kmask (B, Tk) int32 or null. M, L
// (B, H, Tq) float32 receive each row's maximum and denominator. D / H is
// the head width: 32, 64, 96, 128, 192 or 256.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, const int* kmask, void* out,
    float* M, float* L, int B, int Tq, int Tk, int D, int H, float scale,
    int causal, int dtype, int drop_on, unsigned int seed,
    unsigned int thresh, float dscale, void* stream) {
  const int dh = head_width(D, H);
  if (!dh || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Args a{B, Tq, Tk, D, H, scale, causal,
               Drop{drop_on, seed, thresh, dscale}, (cudaStream_t)stream};
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    if (dtype == 0) return forward_fp32<DH>(q, k, v, kmask, out, M, L, a);
    return forward_bf16<DH>(q, k, v, kmask, out, M, L, a);
  });
}

// g: output cotangent (B, Tq, D); Dsum (B, H, Tq) float32 scratch; dq
// (B, Tq, D), dk/dv (B, Tk, D) in the compute dtype.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const int* kmask,
    const void* g, const float* M, const float* L, float* Dsum, void* dq,
    void* dk, void* dv, int B, int Tq, int Tk, int D, int H, float scale,
    int causal, int dtype, int drop_on, unsigned int seed,
    unsigned int thresh, float dscale, void* stream) {
  const int dh = head_width(D, H);
  if (!dh || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Args a{B, Tq, Tk, D, H, scale, causal,
               Drop{drop_on, seed, thresh, dscale}, (cudaStream_t)stream};
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    if (dtype == 0)
      return backward_fp32<DH>(q, k, v, kmask, g, M, L, Dsum, dq, dk, dv, a);
    return backward_bf16<DH>(q, k, v, kmask, g, M, L, Dsum, dq, dk, dv, a);
  });
}

// Shared memory each kernel of a dtype's route takes at head width dh for
// Tk keys, static plus dynamic: out[0] the forward, out[1] the dq pass,
// out[2] the dk/dv pass (the dk launch where it runs as two, which take
// the same). ops/cuda_attention.py flash_smem_bytes reckons the same
// without a card; the smoke run holds the two equal.
extern "C" int flash_attention_smem(int Tk, int dtype, int dh,
                                    long long* out) {
  const int ntk = (Tk + BT - 1) / BT;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return by_width(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    return dtype == 0 ? smem_fp32<DH>(out) : smem_bf16<DH>(ntk, out);
  });
}
