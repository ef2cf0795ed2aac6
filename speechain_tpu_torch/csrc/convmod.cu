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
// second small kernel (stats_reduce_kernel) adds them in a fixed order
// (deterministic, no atomics): 2 launches a call. Weights: W1 (2C, C)
// PyTorch layout, b1 (2C,) and dwb (C,) in the compute dtype, dwk (C, K)
// float32. Two instances, sharing the tail (fwd_tail: the 31-tap
// depthwise sum in float32, u rounded, the s/ss partials from the rounded
// u; O(N C K) on the FMA units):
//
// float32 (convmod_kernel): z on the FMA units (TF32 would break the
// float32 contract), 48 accumulators a thread.
//
// bf16 (convmod_fwd_tc): what bounds it at conformer-small (N = 16 x 199
// = 3184, C 256, K 31): the product, 0.83 GFLOP (0.8 us at 989 TFLOP/s;
// 1.47x that with the halo rows), against ~3.6 MB of x, W1 and u (1.1 us
// at 3.35 TB/s), so the bytes. Run on the FMA units it took 0.231 ms
// (PERF.md): z for 94 rows a 64-frame tile, x and W1 staged as float with
// no pipelining. Here z = round(x W1^T + b1) runs on the tensor cores
// (z_tile_tc, shared with the backward's row pass: mma.sync m16n8k16,
// bf16 operands by ldmatrix, float32 sums, x and W1 streamed in 64-deep
// chunks through a two-slot cp.async ring) for the tile's <= 96 rows and
// the block's 128 columns, kept in shared memory as bf16 (exactly its
// rounded value); a = GLU(z) then takes the ring's memory as float32.
// Rounding points as _fwd_kernel: z after the float32 product plus b1, u
// after the float32 depthwise sum plus dwb.
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
// Two instances, deterministic without atomics (every sum in a fixed
// order):
//
// float32 (convmod_bwd_rows, convmod_bwd_dx, convmod_bwd_wgrad): every
// product on the FMA units in float32 (on the tensor cores float32 means
// TF32, which breaks the 1e-4 contract a float32 step holds the card to
// against the CPU). convmod_bwd_rows: one block per (utterance, 64
// frames, 64 channels) recomputes z over the tile and its K-1 halo frames,
// forms du_tot over the halo, writes dz_c (N, 2C) and per-block partials
// of db1, ddwk and ddwb; convmod_bwd_dx (dz_c W1) and convmod_bwd_wgrad
// (dz_c^T x, one block per 64 x 64 tile, all N rows) are tiled products;
// convmod_bwd_sums adds the partials. 4 launches a call.
//
// bf16 (convmod_bwd_rows_tc, convmod_bwd_dx_tc, convmod_bwd_wgrad_tc): the
// three products on the tensor cores, mma.sync m16n8k16 with bf16
// operands by ldmatrix and float32 sums (mma.cuh), rounded where the TPU
// kernel rounds: z = round(x W1^T + b1), dz_c = round(dz), dx = round(dz_c
// W1); dW1 stays float32. What bounds it at conformer-small training (N =
// 16 x 199 = 3184, C 256, K 31): three products of 0.8 GFLOP each, 2.6 us
// at 989 TFLOP/s (the bytes, ~8 MB, take 2.4 us). Run in bf16, the
// float32 instance's design took 0.91 ms (PERF.md): its z recompute
// (1.47x the rows, for the halo) and both products ran on the FMA units,
// and dW1's 32 tiles, one block each summing all N rows in turn, left 100
// of 132 SMs idle. This design:
// - The row pass recomputes z for the 96 rows of a tile and its halo (64
//   + K - 1 <= 96) and the block's 128 columns on the tensor cores, x and
//   W1 streamed in 64-deep chunks through a two-slot cp.async ring; z is
//   kept in shared memory as bf16 (exactly its rounded value), and the
//   ring's memory then holds a and du_tot for the FMA-unit tail (GLU
//   backward, the transposed depthwise sum, the ddwk / ddwb / db1
//   partials: O(N C K), shared with the float32 instance).
// - dx: one block of 4 warps per 64 x 64 tile (200 at the path shape).
// - dW1: N is split into WG_SPLIT = 8 row ranges, one block per (64 x 64
//   tile, range): (C / 64) (2C / 64) 8 = 256 blocks at C 256, each
//   writing a float32 partial; convmod_bwd_sums adds the 8 in order.
// 5 launches a call: the row pass, dx, dW1's partials, and the two sums.
// K <= 33 and C a multiple of 64, as in float32.

#include "mma.cuh"
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

// The forward's tail, shared by both instances, after a (GLU output) is
// in shared memory: frames t0 - P + r at as[r * lda + c], r < TT + K - 1,
// c < CB, zero outside [0, T). The depthwise sum in float32 ('SAME':
// u[t] = sum_k dk[k] a[t + k - P], row tt + k), plus dwb, rounded to T;
// this block's s / ss partials from the rounded u, written to row b *
// tiles + tile of part (.., 2, C). One channel per thread, 16 frames
// each; dk holds the block's K x CB taps, red 4 x 2 CB floats. THREADS
// threads.
template <typename T>
__device__ __forceinline__ void fwd_tail(const float* as, int lda,
                                         const float* dk, float* red,
                                         const T* __restrict__ dwb,
                                         T* __restrict__ u,
                                         float* __restrict__ part, int t0,
                                         size_t xrow, int Tn, int C, int K,
                                         int c0, int tile) {
  constexpr int GROUPS = THREADS / CB;            // 4
  constexpr int FPT = TT / GROUPS;                // 16
  const int c = threadIdx.x % CB, g = threadIdx.x / CB;
  const float db = to_f(dwb[c0 + c]);
  float s = 0.f, ss = 0.f;
  for (int m = 0; m < FPT; ++m) {
    const int tt = g * FPT + m;
    const int t = t0 + tt;
    if (t >= Tn) break;
    float o = as[tt * lda + c] * dk[c];
    for (int kk = 1; kk < K; ++kk)
      o = fmaf(as[(tt + kk) * lda + c], dk[kk * CB + c], o);
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
    const size_t prow = (size_t)blockIdx.z * gridDim.x + tile;
    part[(prow * 2 + 0) * C + c0 + c] = st;
    part[(prow * 2 + 1) * C + c0 + c] = sst;
  }
}

// Forward (float32): z on the FMA units, then the tail.
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
  fwd_tail<T>(zs, 2 * CB, dk, red, dwb, u, part, t0, xrow, Tn, C, K, c0,
              tile);
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

// The backward row pass's tail, shared by both instances. Frames of the
// tile: t0 + tt, tt < TT. z and a over frames t0 - P + r (r < RZ):
// a[t + k - P] is row tt + k; zat(r, j) is z's row r, column j < 2 CB (CB
// GLU inputs, then their gates), rounded. du_tot over frames t0 - Q + r
// with Q = K - 1 - P: du_tot[t + P - k] is row tt + K - 1 - k, du_tot[t]
// row tt + Q. Writes a (float32) into as, du_tot into gs, dz rounded to T
// (row layout (N, 2C)), and this block's partials, row b * tiles + tile of
// part (.., 2C + C K + C): [db1 (2C) | ddwk (C, K) | ddwb (C)]. dk holds
// the block's K x CB depthwise taps, red 4 x 2 CB floats. THREADS threads.
template <typename T, typename Zat>
__device__ __forceinline__ void bwd_rows_tail(
    Zat zat, float* as, float* gs, const float* dk, float* red,
    const T* __restrict__ u, const T* __restrict__ du,
    const float* __restrict__ dsum, const float* __restrict__ dssum,
    T* __restrict__ dz, float* __restrict__ part, int t0, size_t xrow,
    int Tn, int C, int K, int c0, int tile) {
  const int RZ = TT + K - 1;
  const int P = (K - 1) / 2, Q = K - 1 - P;
  const int tid = threadIdx.x;
  for (int i = tid; i < RZ * CB; i += THREADS) {
    const int r = i / CB, c = i - r * CB;
    const int t = t0 - P + r;
    as[i] = (t >= 0 && t < Tn) ? zat(r, c) * sigmoid(zat(r, CB + c)) : 0.f;
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
    const float ag = zat(tt + P, c);
    const float gate = sigmoid(zat(tt + P, CB + c));
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

  float* prow = part + ((size_t)blockIdx.z * gridDim.x + tile) *
                           (2 * C + C * K + C);
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

// the block's K x CB depthwise taps: dk[k][c] = dwk[c0 + c][k]
__device__ __forceinline__ void load_taps(float* dk,
                                          const float* __restrict__ dwk,
                                          int c0, int K) {
  for (int i = threadIdx.x; i < K * CB; i += blockDim.x) {
    const int kk = i / CB, c = i - kk * CB;
    dk[i] = dwk[(size_t)(c0 + c) * K + kk];
  }
}

// Backward row pass (float32): z recomputed on the FMA units, then the tail.
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
  const int P = (K - 1) / 2;
  float* xs = smem;                        // [RZ][BK]
  float* ws = xs + RZ * BK;                // [2*CB][BK + 1]
  float* zs = ws + 2 * CB * (BK + 1);      // [RZ][2*CB]
  float* as = zs + RZ * 2 * CB;            // [RZ][CB] GLU output a
  float* gs = as + RZ * CB;                // [RZ][CB] du_tot
  float* dk = gs + RZ * CB;                // [K][CB]
  float* red = dk + K * CB;                // [4][2*CB]

  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int t0 = tile * TT;
  const size_t xrow = (size_t)b * Tn;

  load_taps(dk, dwk, c0, K);
  pointwise_rows<T>(x, w1, b1, xs, ws, zs, xrow, t0, RZ, P, Tn, C, c0);
  bwd_rows_tail<T>([&](int r, int j) { return zs[r * 2 * CB + j]; }, as,
                   gs, dk, red, u, du, dsum, dssum, dz, part, t0, xrow, Tn,
                   C, K, c0, tile);
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

// ---- bf16 backward: the products on the tensor cores --------------------

typedef __nv_bfloat16 bf16;

constexpr int RZP = 96;         // z rows of a tile: TT + K - 1 <= 96
constexpr int KC = 64;          // depth of a staged chunk (channels of x)
constexpr int LDK = KC + 8;     // its padded row: conflict-free ldmatrix
constexpr int ZW = 2 * CB;      // z columns of a block: CB inputs, CB gates
constexpr int LDZ = ZW + 8;     // row stride of the bf16 z tile
constexpr int MMT = 128;        // threads of the product kernels: 4 warps
constexpr int WG_SPLIT = 8;     // row ranges of dW1's partial sums
static_assert(RZP >= TT + KMAX - 1, "z rows cover the widest halo");
// the z product's ring (2 slots of RZP x rows and ZW W1 rows, KC deep),
// which a and du_tot (RZP x CB float32 each; the forward: a alone) replace
// after the product; the forward and the backward row pass alike take
// ROWS_TC_SMEM: the ring, the bf16 z tile, the taps and 4 x 2 CB sums
constexpr size_t RING_B = 2 * (size_t)(RZP + ZW) * LDK * 2;
static_assert(2 * (size_t)RZP * CB * 4 <= RING_B, "a, du_tot fit the ring");
constexpr size_t ROWS_TC_SMEM = RING_B + (size_t)RZP * LDZ * 2 +
                                (size_t)KMAX * CB * 4 + 4 * 2 * CB * 4;
// the product kernels' ring: 2 slots of two 64 x LDK tiles
constexpr size_t MM_SMEM = 2 * 2 * 64 * (size_t)LDK * 2;

// z = round(x W1^T + b1) over a tile's RZ = TT + K - 1 rows (frames t0 -
// P + r) and channel block c0's ZW columns (CB GLU inputs, then their CB
// gates) on the tensor cores, into zs ([RZP][LDZ] bf16: exactly the
// rounded value). The product streams x rows and W1 rows in KC-deep
// chunks through a two-slot cp.async ring (RING_B bytes at ring; zeros
// outside the array's frames); warp w forms rows 48 (w / 4) .. + 48 and
// columns 32 (w % 4) .. + 32 of the 96 x 128 tile (3 x 4 m16n8 tiles,
// both operands by ldmatrix: x W1^T has K along both rows). THREADS
// threads; ends synchronised, the ring free for the caller.
__device__ __forceinline__ void z_tile_tc(const bf16* __restrict__ x,
                                          const bf16* __restrict__ w1,
                                          const bf16* __restrict__ b1,
                                          bf16* ring, bf16* zs, size_t xrow,
                                          int t0, int RZ, int P, int Tn,
                                          int C, int c0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, mg = w >> 2, ng = w & 3;
  constexpr int SLOT = (RZP + ZW) * LDK;
  const auto load = [&](int j) {
    bf16* S = ring + (j & 1) * SLOT;
    const int kc0 = j * KC;
    for (int e = tid; e < (RZP + ZW) * (KC / 8); e += THREADS) {
      const int r = e >> 3, ch = (e & 7) * 8;
      const bf16* src;
      bool ok = true;
      if (r < RZP) {
        const int t = t0 - P + r;
        ok = r < RZ && t >= 0 && t < Tn;
        src = x + (xrow + (ok ? t : 0)) * C + kc0 + ch;
      } else {
        const int jj = r - RZP, wr = jj < CB ? c0 + jj : C + c0 + jj - CB;
        src = w1 + (size_t)wr * C + kc0 + ch;
      }
      cp_async16(S + r * LDK + ch, src, ok);
    }
  };
  float acc[3][4][4] = {};
  sweep(C / KC, load, [&](int j) {
    const bf16* X = ring + (j & 1) * SLOT;
    const bf16* W = X + RZP * LDK;
    const bf16* pa = X + (48 * mg + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDK +
                     8 * (lane >> 4);
    const bf16* pb = W + (32 * ng + (lane & 7) + 8 * (lane >> 4)) * LDK +
                     8 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[3][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
        ldmatrix_x4(a[mt], pa + 16 * mt * LDK + 16 * ks);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, pb + 16 * np * LDK + 16 * ks);
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
  });
  // z = round(acc + b1): columns j, j + 1 lie on one side of CB
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = 32 * ng + 8 * n + 2 * (lane & 3);
      const int wr = j < CB ? c0 + j : C + c0 + j - CB;
      const float bb0 = __bfloat162float(b1[wr]);
      const float bb1 = __bfloat162float(b1[wr + 1]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 48 * mg + 16 * mt + (lane >> 2) + 8 * hr;
        *reinterpret_cast<__nv_bfloat162*>(zs + r * LDZ + j) =
            __floats2bfloat162_rn(acc[mt][n][2 * hr] + bb0,
                                  acc[mt][n][2 * hr + 1] + bb1);
      }
    }
  __syncthreads();
}

// Forward (bf16): z on the tensor cores (z_tile_tc), then a = GLU(z) in
// float32 over the ring's memory, zero outside [0, T), and the FMA-unit
// tail (fwd_tail: the depthwise sum, u, the s / ss partials). One block
// per (64 frames, 64 channels, utterance), as the float32 kernel.
__global__ void __launch_bounds__(THREADS, 2)
convmod_fwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const float* __restrict__ dwk,
               const bf16* __restrict__ dwb, bf16* __restrict__ u,
               float* __restrict__ part, int Tn, int C, int K) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);
  float* as = reinterpret_cast<float*>(tc_smem);      // after the product
  bf16* zs = reinterpret_cast<bf16*>(tc_smem + RING_B);  // [RZP][LDZ]
  float* dk = reinterpret_cast<float*>(zs + RZP * LDZ);  // [KMAX][CB]
  float* red = dk + KMAX * CB;                           // [4][2 CB]
  const int RZ = TT + K - 1, P = (K - 1) / 2;
  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int t0 = tile * TT;
  const size_t xrow = (size_t)b * Tn;
  load_taps(dk, dwk, c0, K);
  z_tile_tc(x, w1, b1, ring, zs, xrow, t0, RZ, P, Tn, C, c0);
  for (int i = threadIdx.x; i < RZ * CB; i += THREADS) {
    const int r = i / CB, c = i - r * CB, t = t0 - P + r;
    as[i] = (t >= 0 && t < Tn)
                ? __bfloat162float(zs[r * LDZ + c]) *
                      sigmoid(__bfloat162float(zs[r * LDZ + CB + c]))
                : 0.f;
  }
  __syncthreads();
  fwd_tail<bf16>(as, CB, dk, red, dwb, u, part, t0, xrow, Tn, C, K, c0,
                 tile);
}

// Backward row pass (bf16): z on the tensor cores (z_tile_tc), then the
// FMA-unit tail; the ring's memory then holds a and du_tot.
__global__ void __launch_bounds__(THREADS, 2)
convmod_bwd_rows_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const float* __restrict__ dwk,
                    const bf16* __restrict__ u, const bf16* __restrict__ du,
                    const float* __restrict__ dsum,
                    const float* __restrict__ dssum, bf16* __restrict__ dz,
                    float* __restrict__ part, int Tn, int C, int K) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);
  float* as = reinterpret_cast<float*>(tc_smem);      // after the product
  float* gs = as + RZP * CB;
  bf16* zs = reinterpret_cast<bf16*>(tc_smem + RING_B);  // [RZP][LDZ]
  float* dk = reinterpret_cast<float*>(zs + RZP * LDZ);  // [KMAX][CB]
  float* red = dk + KMAX * CB;                           // [4][2 CB]
  const int RZ = TT + K - 1, P = (K - 1) / 2;
  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int t0 = tile * TT;
  const size_t xrow = (size_t)b * Tn;
  load_taps(dk, dwk, c0, K);
  z_tile_tc(x, w1, b1, ring, zs, xrow, t0, RZ, P, Tn, C, c0);
  bwd_rows_tail<bf16>(
      [&](int r, int jj) { return __bfloat162float(zs[r * LDZ + jj]); }, as,
      gs, dk, red, u, du, dsum, dssum, dz, part, t0, xrow, Tn, C, K, c0,
      tile);
}

// the 64 x 64 tile at (row0, col0) of M (rows x cols, row-major) -> S (row
// stride LDK) by 16-byte cp.async copies; zeros past the rows (cols is a
// multiple of 64)
__device__ __forceinline__ void stage64(bf16* S, const bf16* __restrict__ M,
                                        int row0, int col0, int rows,
                                        int cols) {
#pragma unroll
  for (int k = 0; k < 64 * 8 / MMT; ++k) {
    const int e = threadIdx.x + k * MMT, r = e >> 3, c = (e & 7) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(S + r * LDK + c,
               M + (size_t)(ok ? row0 + r : 0) * cols + col0 + c, ok);
  }
}

// dx (N, C) = round(dz W1), dz (N, 2C), W1 (2C, C): one block of 4 warps
// per 64 x 64 tile of dx (warp w: rows 32 (w % 2) .., columns 32 (w / 2)
// ..), K = 2C in 64-deep steps through a two-slot ring; W1 read
// transposed (its rows are K).
__global__ void __launch_bounds__(MMT, 3)
convmod_bwd_dx_tc(const bf16* __restrict__ dz, const bf16* __restrict__ w1,
                  bf16* __restrict__ dx, int N, int C) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* S = reinterpret_cast<bf16*>(tc_smem);
  constexpr int TEL = 64 * LDK;
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mw = 32 * (w & 1), nw = 32 * (w >> 1);
  float acc[2][4][4] = {};
  sweep(
      2 * C / 64,
      [&](int s) {
        bf16* St = S + (s & 1) * 2 * TEL;
        stage64(St, dz, i0, 64 * s, N, 2 * C);
        stage64(St + TEL, w1, 64 * s, j0, 2 * C, C);
      },
      [&](int s) {
        const bf16* At = S + (s & 1) * 2 * TEL;
        const bf16* Bt = At + TEL;
        const bf16* pa = At + (mw + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDK +
                         8 * (lane >> 4);
        const bf16* pb = Bt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDK +
                         nw + 8 * (lane >> 4);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[mt], pa + 16 * mt * LDK + 16 * ks);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, pb + 16 * ks * LDK + 16 * np);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
              mma16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
            }
          }
        }
      });
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = i0 + mw + 16 * mt + (lane >> 2) + 8 * hr;
      if (row >= N) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            dx + (size_t)row * C + j0 + nw + 8 * n + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[mt][n][2 * hr], acc[mt][n][2 * hr + 1]);
    }
}

// dW1's partial of row range s = blockIdx.z: part[s] (2C, C) = dz[rows]^T
// x[rows], rows the 64-row steps [s per, (s + 1) per) of N, per =
// ceil(ceil(N / 64) / WG_SPLIT): one block of 4 warps per (64 x 64 tile,
// s); both operands read transposed (their rows are K). convmod_bwd_sums
// adds the WG_SPLIT partials in order: deterministic, no atomics, and
// (C / 64) (2C / 64) WG_SPLIT blocks (256 at C 256) fill the card where the
// tiles alone (32) would not.
__global__ void __launch_bounds__(MMT, 3)
convmod_bwd_wgrad_tc(const bf16* __restrict__ dz, const bf16* __restrict__ x,
                     float* __restrict__ part, int N, int C) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* S = reinterpret_cast<bf16*>(tc_smem);
  constexpr int TEL = 64 * LDK;
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  const int steps = (N + 63) / 64, per = (steps + WG_SPLIT - 1) / WG_SPLIT;
  const int s0 = blockIdx.z * per, ns = max(0, min(steps, s0 + per) - s0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mw = 32 * (w & 1), nw = 32 * (w >> 1);
  float acc[2][4][4] = {};
  sweep(
      ns,
      [&](int s) {
        bf16* St = S + (s & 1) * 2 * TEL;
        stage64(St, dz, 64 * (s0 + s), i0, N, 2 * C);
        stage64(St + TEL, x, 64 * (s0 + s), j0, N, C);
      },
      [&](int s) {
        const bf16* At = S + (s & 1) * 2 * TEL;
        const bf16* Bt = At + TEL;
        const bf16* pa = At + ((lane & 7) + 8 * (lane >> 4)) * LDK + mw +
                         8 * ((lane >> 3) & 1);
        const bf16* pb = Bt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDK +
                         nw + 8 * (lane >> 4);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4_trans(a[mt], pa + 16 * ks * LDK + 16 * mt);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, pb + 16 * ks * LDK + 16 * np);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
              mma16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
            }
          }
        }
      });
  float* out = part + (size_t)blockIdx.z * 2 * C * C;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = i0 + mw + 16 * mt + (lane >> 2) + 8 * hr;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<float2*>(out + (size_t)row * C + j0 + nw + 8 * n +
                                   2 * (lane & 3)) =
            make_float2(acc[mt][n][2 * hr], acc[mt][n][2 * hr + 1]);
    }
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

// The bf16 forward's launch grids: convmod_fwd_tc (64 frames, 64
// channels, utterance) and the fixed-order s / ss sum.
struct FwdGrids {
  dim3 fwd, sums;
};
FwdGrids fwd_grids(int B, int Tn, int C) {
  return {dim3((Tn + TT - 1) / TT, C / CB, B), dim3((C + 127) / 128)};
}

// The bf16 forward: z on the tensor cores, the FMA-unit tail, then s and
// ss from the per-block partials in a fixed order: 2 launches a call.
int launch_fwd_tc(const void* x, const void* w1, const void* b1,
                  const float* dwk, const void* dwb, void* u, float* part,
                  float* s, float* ss, int B, int Tn, int C, int K,
                  cudaStream_t stream) {
  if (K > KMAX || C % CB != 0) return (int)cudaErrorInvalidValue;
  static SmemSet set;
  const FwdGrids g = fwd_grids(B, Tn, C);
  cudaError_t err = allow_smem(convmod_fwd_tc, ROWS_TC_SMEM, set);
  if (err != cudaSuccess) return (int)err;
  convmod_fwd_tc<<<g.fwd, THREADS, ROWS_TC_SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const bf16*)b1, dwk,
      (const bf16*)dwb, (bf16*)u, part, Tn, C, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<g.sums, 128, 0, stream>>>(part, s, ss,
                                                  B * (int)g.fwd.x, C);
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

// Float32 elements of the backward's part scratch: the row pass's
// per-block partials, (B * ceil(T / 64), 2C + C K + C), then in bf16
// dW1's WG_SPLIT partial sums (WG_SPLIT, 2C, C). The entry point refuses a
// shorter buffer; ops/cuda_convmod.py part_floats sizes it.
long long part_need(int dtype, int B, int Tn, int C, int K) {
  const long long rows =
      (long long)B * ((Tn + TT - 1) / TT) * (2LL * C + (long long)C * K + C);
  return rows + (dtype == 1 ? (long long)WG_SPLIT * 2 * C * C : 0);
}

// The bf16 backward's launch grids: the row pass (64 frames, 64 channels,
// utterance), dx (64 x 64 tiles of (N, C)), dW1's partials (64 x 64 tiles
// of (2C, C), WG_SPLIT row ranges) and the two fixed-order sums.
struct TcGrids {
  dim3 rows, dx, wgrad, sums_dw1, sums_part;
};
TcGrids tc_grids(int B, int Tn, int C, int K) {
  const int N = B * Tn, W = 2 * C + C * K + C;
  return {dim3((Tn + TT - 1) / TT, C / CB, B), dim3(C / 64, (N + 63) / 64),
          dim3(C / 64, 2 * C / 64, WG_SPLIT), dim3((2 * C * C + 255) / 256),
          dim3((W + 255) / 256)};
}

// The bf16 backward: the row pass (z on the tensor cores), dx, dW1's
// WG_SPLIT partials, then dW1 and the row partials in a fixed order: 5
// launches a call. part as part_need lays it out.
int launch_bwd_tc(const void* x, const void* w1, const void* b1,
                  const float* dwk, const void* u, const void* du,
                  const float* ds, const float* dss, void* dz, float* part,
                  void* dx, float* dw1, float* sums, int B, int Tn, int C,
                  int K, cudaStream_t stream) {
  if (K > KMAX || C % CB != 0) return (int)cudaErrorInvalidValue;
  static SmemSet rows_set, dx_set, wg_set;
  const TcGrids g = tc_grids(B, Tn, C, K);
  const int tiles = (Tn + TT - 1) / TT, N = B * Tn;
  const int W = 2 * C + C * K + C;
  float* wpart = part + (size_t)B * tiles * W;
  cudaError_t err = allow_smem(convmod_bwd_rows_tc, ROWS_TC_SMEM, rows_set);
  if (err != cudaSuccess) return (int)err;
  convmod_bwd_rows_tc<<<g.rows, THREADS, ROWS_TC_SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const bf16*)b1, dwk, (const bf16*)u,
      (const bf16*)du, ds, dss, (bf16*)dz, part, Tn, C, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(convmod_bwd_dx_tc, MM_SMEM, dx_set)) != cudaSuccess)
    return (int)err;
  convmod_bwd_dx_tc<<<g.dx, MMT, MM_SMEM, stream>>>(
      (const bf16*)dz, (const bf16*)w1, (bf16*)dx, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(convmod_bwd_wgrad_tc, MM_SMEM, wg_set)) !=
      cudaSuccess)
    return (int)err;
  convmod_bwd_wgrad_tc<<<g.wgrad, MMT, MM_SMEM, stream>>>(
      (const bf16*)dz, (const bf16*)x, wpart, N, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  convmod_bwd_sums<<<g.sums_dw1, 256, 0, stream>>>(wpart, dw1, WG_SPLIT,
                                                   2 * C * C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  convmod_bwd_sums<<<g.sums_part, 256, 0, stream>>>(part, sums, B * tiles, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (convmod_kernel, the FMA units), 1 = bfloat16
// (convmod_fwd_tc, z on the tensor cores). part: (B * ceil(T / 64), 2, C)
// float32 scratch. C must be a multiple of 64 and K <= 33.
extern "C" int convmod_forward(const void* x, const void* w1, const void* b1,
                               const float* dwk, const void* dwb, void* u,
                               float* part, float* s, float* ss, int B,
                               int Tn, int C, int K, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w1, b1, dwk, dwb, u, part, s, ss, B, Tn, C, K,
                         st);
  if (dtype == 1)
    return launch_fwd_tc(x, w1, b1, dwk, dwb, u, part, s, ss, B, Tn, C, K,
                         st);
  return (int)cudaErrorInvalidValue;
}

// du (B, T, C) in the compute dtype, ds / dss (C,) float32: the cotangents
// of u, s and ss. dz: (B * T, 2C) scratch in the compute dtype; part:
// float32 scratch of n_part elements, at least what
// convmod_layout says (cudaErrorInvalidValue otherwise). Results:
// dx (B, T, C) in the compute dtype, dw1 (2C, C) float32, sums (2C + C K +
// C) float32 = [db1 | ddwk (C, K) | ddwb].
extern "C" int convmod_backward(const void* x, const void* w1, const void* b1,
                                const float* dwk, const void* u,
                                const void* du, const float* ds,
                                const float* dss, void* dz, float* part,
                                void* dx, float* dw1, float* sums,
                                long long n_part, int B, int Tn, int C, int K,
                                int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((dtype != 0 && dtype != 1) || n_part < part_need(dtype, B, Tn, C, K))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, w1, b1, dwk, u, du, ds, dss, dz, part, dx,
                             dw1, sums, B, Tn, C, K, st);
  return launch_bwd_tc(x, w1, b1, dwk, u, du, ds, dss, dz, part, dx, dw1,
                       sums, B, Tn, C, K, st);
}

// The layout of a call (dtype 0 = float32, 1 = bfloat16): out[0] the
// float32 elements of the backward's part (part_need); in bf16 also
// out[1..4] the shared memory, static plus dynamic, of convmod_fwd_tc,
// convmod_bwd_rows_tc, convmod_bwd_dx_tc and convmod_bwd_wgrad_tc, and
// out[5..25] the (x, y, z) blocks of the forward's two launches
// (fwd_grids) and the backward's rows, dx, wgrad, dW1-sum and row-sum
// launches (tc_grids); zeros in float32. ops/cuda_convmod.py part_floats,
// tc_smem_bytes, fwd_tc_grids and bwd_tc_grids reckon the same without a
// card; the smoke run holds them equal.
extern "C" int convmod_layout(int dtype, int B, int Tn, int C, int K,
                              long long* out) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || Tn <= 0 || K > KMAX ||
      C <= 0 || C % CB != 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 26; ++i) out[i] = 0;
  out[0] = part_need(dtype, B, Tn, C, K);
  if (dtype == 0) return 0;
  cudaError_t err;
  if ((err = smem_of(convmod_fwd_tc, ROWS_TC_SMEM, out + 1)) ||
      (err = smem_of(convmod_bwd_rows_tc, ROWS_TC_SMEM, out + 2)) ||
      (err = smem_of(convmod_bwd_dx_tc, MM_SMEM, out + 3)) ||
      (err = smem_of(convmod_bwd_wgrad_tc, MM_SMEM, out + 4)))
    return (int)err;
  const FwdGrids f = fwd_grids(B, Tn, C);
  const TcGrids g = tc_grids(B, Tn, C, K);
  const dim3 grids[7] = {f.fwd, f.sums, g.rows, g.dx, g.wgrad, g.sums_dw1,
                         g.sums_part};
  for (int i = 0; i < 7; ++i) {
    out[5 + 3 * i] = grids[i].x;
    out[6 + 3 * i] = grids[i].y;
    out[7 + 3 * i] = grids[i].z;
  }
  return 0;
}
