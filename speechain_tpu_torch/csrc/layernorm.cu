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
// What bounds it on the H100: latency, not bytes. The conformer encoder's
// LayerNorm (N = 3184 rows, D = 256, bf16) moves 3.29 MB forward (0.98 us
// at 3.35 TB/s) and ~4.9 MB backward (1.47 us); the decode step's N = 256
// moves 0.26 MB. A kernel of that size is as fast as its longest chain of
// dependent memory round trips, and as the memory traffic it keeps in
// flight while it waits. So:
// - Forward: one warp a row, W warps a block (the wrapper's pick). A lane
//   issues its 16-byte loads of the row, then of scale and bias, before
//   the shuffle reduction of the sum and sum of squares, keeps the row in
//   registers and stores y: one round trip of loads, one of stores. mu and
//   rstd are stored only when the caller passes them (the backward's; a
//   no-grad call passes none). Several rows a warp, all loaded before the
//   first reduction, were tried and measured slower at every D 256 shape
//   of the path: the warps' own parallelism hides the latency better.
// - Backward: P blocks (at most one an SM, each a run of at least 8 rows
//   where N allows: the wrapper's pick), each a contiguous run of rows;
//   warp w of W takes the run's rows w, w + W, ... in order, R at a time
//   with all their loads issued first, and keeps its lanes' dscale and
//   dbias sums in registers over all its rows. The W warps' sums are added
//   in warp order through shared memory (W x D floats), and each block
//   writes one partial. A second kernel adds the P partials column by
//   column: eight warps each add a fixed segment of them in order, then
//   the eight segment sums in order (32 warps, each with all its loads in
//   flight at once, measured no faster). Every sum runs in a fixed order,
//   with no atomics, so the results are bit-equal from launch to launch.
//
// Rounding points: x widened to float32, all arithmetic float32, y and dx
// rounded once to x's type at the store, as the TPU kernel's astype.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace sct;

constexpr int MAX_D = 1024;       // a lane keeps <= 32 columns of a row
constexpr int MAX_WARPS = 8;      // warps a block, forward and backward
constexpr int MAX_CHUNK = 4;      // backward: R * NV, 16-byte loads of one
                                  // tensor a lane keeps in flight (or R 1)
constexpr int SUM_COLS = 32;      // the partials' sum: columns a block
constexpr int SUM_WARPS = 8;      // and warps, each a segment of partials

// values of T in one 16-byte load
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// the 16-byte vectors a lane keeps of a row: the least power of two
// covering D / (32 VN)
int vectors_of(int D, int vn) {
  const int need = (D + 32 * vn - 1) / (32 * vn);
  int nv = 1;
  while (nv < need) nv *= 2;
  return nv;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&out)[4]) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&in)[4]) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}
__device__ __forceinline__ uint4 pack(const float (&in)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e)      // round to nearest even, like astype
    h[e] = __floats2bfloat162_rn(in[2 * e], in[2 * e + 1]);
  return u;
}

// VN float32 values of p (16-byte aligned) into out
template <int VN>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&out)[VN]) {
#pragma unroll
  for (int e = 0; e < VN; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + e);
    out[e] = v.x;
    out[e + 1] = v.y;
    out[e + 2] = v.z;
    out[e + 3] = v.w;
  }
}

// Lane l keeps vectors j < NV of a row: columns (32 j + l) VN .. + VN,
// those below D.

// Forward: warp gw of the grid takes row gw.
template <typename T, int NV>
__global__ void __launch_bounds__(MAX_WARPS * 32)
ln_fwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ y,
            float* __restrict__ mu_out, float* __restrict__ rstd_out, int N,
            int D, float eps) {
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;
  // the row's loads, then scale and bias, all before the reduction
  bool on[NV];
  uint4 xv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    on[j] = (32 * j + lane) * VN < D;
    if (on[j])
      xv[j] = *reinterpret_cast<const uint4*>(x + (size_t)row * D +
                                              (32 * j + lane) * VN);
  }
  float sc[NV][VN], bi[NV][VN];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (on[j]) {
      load_f32<VN>(scale + (32 * j + lane) * VN, sc[j]);
      load_f32<VN>(bias + (32 * j + lane) * VN, bi[j]);
    }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (on[j]) {
      float v[VN];
      unpack(xv[j], v);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / (float)D;
  const float rstd = rsqrtf(ss / (float)D - mu * mu + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (on[j]) {
      float v[VN];
      unpack(xv[j], v);
#pragma unroll
      for (int e = 0; e < VN; ++e)
        v[e] = (v[e] - mu) * rstd * sc[j][e] + bi[j][e];
      *reinterpret_cast<uint4*>(y + (size_t)row * D + (32 * j + lane) * VN) =
          pack(v);
    }
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// Backward rows: block p takes rows [p rpb, min(N, (p + 1) rpb)), rpb =
// ceil(N / gridDim.x); warp w of W takes the run's rows w, w + W, ... in
// order, R at a time. part[p] = (dscale (D), dbias (D)): each warp's sums
// over its rows in row order, added in warp order. red: W x D floats.
template <typename T, int NV, int R>
__global__ void __launch_bounds__(MAX_WARPS * 32)
ln_bwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ mu, const float* __restrict__ rstd,
            const T* __restrict__ g, T* __restrict__ dx,
            float* __restrict__ part, int N, int D) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ float red[];
  const int W = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpb = (N + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * rpb, hi = min(N, lo + rpb);
  const float invD = 1.f / (float)D;
  bool on[NV];
  float sc[NV][VN], dsc[NV][VN], dbi[NV][VN];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (32 * j + lane) * VN;
    on[j] = c < D;
    if (on[j]) load_f32<VN>(scale + c, sc[j]);
#pragma unroll
    for (int e = 0; e < VN; ++e) dsc[j][e] = dbi[j][e] = 0.f;
  }
  for (int k0 = lo + warp; k0 < hi; k0 += W * R) {
    // rows k0 + W r: every load issued before the first reduction
    uint4 xv[R][NV], gv[R][NV];
    float m[R], rs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = k0 + W * r;
      if (row >= hi) continue;
      m[r] = mu[row];
      rs[r] = rstd[row];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (on[j]) {
          const size_t o = (size_t)row * D + (32 * j + lane) * VN;
          xv[r][j] = *reinterpret_cast<const uint4*>(x + o);
          gv[r][j] = *reinterpret_cast<const uint4*>(g + o);
        }
    }
    float s1[R], s2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s1[r] = s2[r] = 0.f;
      if (k0 + W * r >= hi) continue;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (on[j]) {
          float xf[VN], gf[VN];
          unpack(xv[r][j], xf);
          unpack(gv[r][j], gf);
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            const float xh = (xf[e] - m[r]) * rs[r];
            const float gs = gf[e] * sc[j][e];
            s1[r] += gs;
            s2[r] += gs * xh;
          }
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], o);
        s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], o);
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = k0 + W * r;
      if (row >= hi) break;
      const float m1 = s1[r] * invD, m2 = s2[r] * invD;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (on[j]) {
          float xf[VN], gf[VN];
          unpack(xv[r][j], xf);
          unpack(gv[r][j], gf);
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            const float xh = (xf[e] - m[r]) * rs[r];
            dsc[j][e] += gf[e] * xh;
            dbi[j][e] += gf[e];
            xf[e] = rs[r] * (gf[e] * sc[j][e] - m1 - xh * m2);
          }
          *reinterpret_cast<uint4*>(dx + (size_t)row * D +
                                    (32 * j + lane) * VN) = pack(xf);
        }
    }
  }
  // the block's partial: the warps' sums added in warp order
  float* out = part + (size_t)blockIdx.x * 2 * D;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (on[j]) {
        float* dst = red + warp * D + (32 * j + lane) * VN;
#pragma unroll
        for (int e = 0; e < VN; ++e) dst[e] = q == 0 ? dsc[j][e] : dbi[j][e];
      }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < W; ++w) t += red[w * D + c];
      out[q * D + c] = t;
    }
    __syncthreads();                 // red is refilled by the next q
  }
}

// out[c] = sum_p part[p][c] over the P partials (part (P, W2) float32),
// c < W2: block b takes columns 32 b .. + 32; warp w adds partials [w ps,
// min(P, (w + 1) ps)), ps = ceil(P / SUM_WARPS), in order; warp 0 adds the
// SUM_WARPS segment sums in order.
__global__ void __launch_bounds__(SUM_COLS * SUM_WARPS)
ln_bwd_sums(const float* __restrict__ part, float* __restrict__ out, int P,
            int W2) {
  __shared__ float seg[SUM_WARPS][SUM_COLS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * SUM_COLS + lane;
  const int ps = (P + SUM_WARPS - 1) / SUM_WARPS;
  const int p0 = w * ps, p1 = min(P, p0 + ps);
  float s = 0.f;
  if (c < W2) {
#pragma unroll 4
    for (int p = p0; p < p1; ++p) s += part[(size_t)p * W2 + c];
  }
  seg[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < W2) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < SUM_WARPS; ++k) t += seg[k][lane];
    out[c] = t;
  }
}

// fn(integral_constant<int, NV>) for nv in 1, 2, 4, 8;
// cudaErrorInvalidValue for any other
template <typename Fn>
int by_vectors(int nv, Fn fn) {
  switch (nv) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// fn(integral_constant<int, R>) for r in 1, 2, 4
template <typename Fn>
int by_rows(int r, Fn fn) {
  switch (r) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the (NV, R) pairs built for T: NV up to a row of MAX_D, R NV <= MAX_CHUNK
// unless R = 1 (the pairs layout() admits)
template <typename T, int NV, int R>
constexpr bool built() {
  return NV * 32 * Vec<T>::N <= MAX_D && (R == 1 || R * NV <= MAX_CHUNK);
}

// A call's launches, from the wrapper's choice (the forward's warps; the
// backward's blocks, warps and rows at a time): each kernel's grid and
// block, the backward's dynamic shared memory and the instance's NV.
// valid is false for a choice the kernels do not take.
struct Layout {
  bool valid;
  int nv, fwd_grid, fwd_threads, bwd_grid, bwd_threads, sum_grid,
      sum_threads;
  size_t bwd_smem;
};

bool rows_ok(int nv, int r) {
  return (r == 1 || r == 2 || r == 4) && (r == 1 || r * nv <= MAX_CHUNK);
}

Layout layout(int N, int D, int vn, int fwd_warps, int bwd_blocks,
              int bwd_warps, int bwd_rows) {
  Layout L{};
  L.nv = vectors_of(D, vn);
  L.valid = N > 0 && D > 0 && D <= MAX_D && D % vn == 0 &&
            rows_ok(L.nv, bwd_rows) && fwd_warps >= 1 &&
            fwd_warps <= MAX_WARPS && bwd_warps >= 1 &&
            bwd_warps <= MAX_WARPS && bwd_blocks >= 1 && bwd_blocks <= N;
  if (!L.valid) return L;
  L.fwd_grid = (N + fwd_warps - 1) / fwd_warps;
  L.fwd_threads = 32 * fwd_warps;
  L.bwd_grid = bwd_blocks;
  L.bwd_threads = 32 * bwd_warps;
  L.bwd_smem = (size_t)bwd_warps * D * sizeof(float);
  L.sum_grid = (2 * D + SUM_COLS - 1) / SUM_COLS;
  L.sum_threads = SUM_COLS * SUM_WARPS;
  return L;
}

template <typename T>
int forward(const void* x, const float* s, const float* b, void* y,
            float* mu, float* rstd, int N, int D, float eps, int warps,
            cudaStream_t st) {
  const Layout L = layout(N, D, Vec<T>::N, warps, 1, 1, 1);
  if (!L.valid) return (int)cudaErrorInvalidValue;
  return by_vectors(L.nv, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    if constexpr (!built<T, NV, 1>()) {
      return (int)cudaErrorInvalidValue;
    } else {
      ln_fwd_rows<T, NV><<<L.fwd_grid, L.fwd_threads, 0, st>>>(
          (const T*)x, s, b, (T*)y, mu, rstd, N, D, eps);
      return (int)cudaGetLastError();
    }
  });
}

template <typename T>
int backward(const void* x, const float* s, const float* mu,
             const float* rstd, const void* g, void* dx, float* part,
             float* sums, int N, int D, int blocks, int warps, int rows,
             cudaStream_t st) {
  const Layout L = layout(N, D, Vec<T>::N, 1, blocks, warps, rows);
  if (!L.valid) return (int)cudaErrorInvalidValue;
  const int err = by_vectors(L.nv, [&](auto nv) {
    return by_rows(rows, [&](auto r) {
      constexpr int NV = decltype(nv)::value, R = decltype(r)::value;
      if constexpr (!built<T, NV, R>()) {
        return (int)cudaErrorInvalidValue;
      } else {
        ln_bwd_rows<T, NV, R><<<L.bwd_grid, L.bwd_threads, L.bwd_smem,
                                st>>>((const T*)x, s, mu, rstd,
                                      (const T*)g, (T*)dx, part, N, D);
        return (int)cudaGetLastError();
      }
    });
  });
  if (err) return err;
  ln_bwd_sums<<<L.sum_grid, L.sum_threads, 0, st>>>(part, sums, blocks,
                                                     2 * D);
  return (int)cudaGetLastError();
}

// every pointer 16-byte aligned (the kernels move 16 bytes at a time)
template <typename... Ptr>
bool aligned16(const Ptr*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

}  // namespace

extern "C" {

// x, y (N, D) in float32 (dtype 0) or bf16 (dtype 1), 16-byte aligned;
// scale, bias (D,) float32, 16-byte aligned; mu, rstd (N,) float32 out, or
// both null (no statistics stored). D % (16 / sizeof(T)) == 0, D <= 1024;
// warps (1-8, one row each) a block, as the wrapper picks.
int layer_norm_forward(const void* x, const float* scale, const float* bias,
                       void* y, float* mu, float* rstd, int N, int D,
                       float eps, int dtype, int warps, void* stream) {
  if (N <= 0) return 0;
  if ((mu == nullptr) != (rstd == nullptr) || !aligned16(x, scale, bias, y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
             ? forward<float>(x, scale, bias, y, mu, rstd, N, D, eps, warps,
                              st)
             : forward<__nv_bfloat16>(x, scale, bias, y, mu, rstd, N, D, eps,
                                      warps, st);
}

// dx (N, D) in x's type; part (blocks, 2 D) float32 scratch; sums (2 D)
// float32 out: dscale then dbias; x, g, dx and scale 16-byte aligned.
// blocks (1..N) row runs, warps (1-8) a block, rows (1, 2, 4) a warp at a
// time, as the wrapper picks.
int layer_norm_backward(const void* x, const float* scale, const float* mu,
                        const float* rstd, const void* g, void* dx,
                        float* part, float* sums, int N, int D, int dtype,
                        int blocks, int warps, int rows, void* stream) {
  if (D <= 0 || D > MAX_D || !aligned16(x, scale, g, dx))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaMemsetAsync(sums, 0, 2 * D * sizeof(float),
                                          (cudaStream_t)stream);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
             ? backward<float>(x, scale, mu, rstd, g, dx, part, sums, N, D,
                               blocks, warps, rows, st)
             : backward<__nv_bfloat16>(x, scale, mu, rstd, g, dx, part, sums,
                                       N, D, blocks, warps, rows, st);
}

// The launches the entries above make for a call (none is made): out = {NV,
// forward grid, forward threads, backward grid, backward threads, its
// dynamic shared memory, the partials' sum grid, its threads}.
int layer_norm_layout(int N, int D, int dtype, int fwd_warps, int bwd_blocks,
                      int bwd_warps, int bwd_rows, long long* out) {
  const Layout L = layout(N, D, dtype == 0 ? 4 : 8, fwd_warps, bwd_blocks,
                          bwd_warps, bwd_rows);
  if (!L.valid) return (int)cudaErrorInvalidValue;
  const long long v[8] = {L.nv, L.fwd_grid, L.fwd_threads, L.bwd_grid,
                          L.bwd_threads, (long long)L.bwd_smem, L.sum_grid,
                          L.sum_threads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
