// The fused Conv2d-prenet core, forward and backward:
//   out = conv2(act(g1 * conv1(mel) + b1))      pre-BN2, (B, T2, F2, C)
// conv1 3x3/2 from one channel to C (w1 (9, C)), the BatchNorm-1 affine and
// the activation in the same pass, conv2 3x3/2 from C to C (w2 (9, C, C):
// tap, input channel, output channel), both VALID.
//
// Replaces speechain_tpu/ops/pallas_prenet.py::fused_prenet_core (forward
// pl.pallas_call at :492, body _fwd_kernel :278; backward at :536, body
// _bwd_kernel :320). Rounding points as there: the mel in the compute type
// T, w1 rounded to T before conv1 (:297), z * g1 + b1 in float32 (:269),
// h = act(.) rounded to T before each tap (:313), w2 rounded (:315), float32
// sums, the output in T. Backward (:320-400): dh = conv2^T(du) in float32,
// dy = act'(z g1 + b1) dh, dw2[t] = sum h(shifted by t)^T du, A = sum
// patch^T dy with patch and dy in T (:374), sum dy and sum dy z in float32;
// the wrapper forms dw1 = A g1 and returns zero for the mel (:404-426).
//
// What bounds it on the H100: the operations. At conformer-small (mel (16,
// 801, 80), C = 256) conv2 is 60,496 output positions x 9 x 256^2
// multiply-adds: 71.4 GFLOP, 0.072 ms at bf16's tensor-core rate, 1.07 ms
// at float32's 67 TFLOP/s; the backward ~145 GFLOP. In bf16 the three
// products run on the tensor cores (mma.sync m16n8k16, float32 sums:
// prenet_fwd_tc, prenet_bwd_dy_tc, prenet_bwd_dw2_tc); in float32 on the
// FMA units (prenet_fwd, prenet_bwd_dy, prenet_bwd_dw2). Both follow the
// design below (the bf16 forward and dw2 blocks own up to 256 output
// channels, not 64, so that conv1, recomputed on the FMA units, is
// computed once per row tile); wgmma / TMA pipelines are later work.
//
// Design. The TPU kernel's phase-split 16-lane patch matrix, 8-row halos
// and read-modify-write sums over a sequential grid exist for Mosaic and are
// not carried over.
// - Forward (prenet_fwd): conv2 as an implicit product. A block owns 64
//   output channels of RT = 64 / F2 output rows of one utterance (64
//   positions at most), stages the 4 RT + 3 mel rows they read once, and
//   for every 16 input channels recomputes conv1 + affine + activation for
//   the 2 RT + 1 conv1 rows it needs into shared memory (9 multiply-adds a
//   value against conv2's 9 x 64), then adds the 9 taps' products into a
//   4 x 4 register tile per thread. The conv1 activation never reaches
//   device memory.
// - Backward, dy pass (prenet_bwd_dy): conv1 positions are walked by stride
//   phase (t1 % 2, f1 % 2), so the 64 positions of a tile are read by the
//   same conv2 taps (4, 2, 2 or 1 of them); dh is their product with w2,
//   dy follows from z recomputed from the mel, and each block keeps its
//   A, sum dy and sum dy z in registers over the work items it owns, then
//   writes one partial row. Positions that no conv2 output reads get dh = 0
//   and add nothing, so every real conv1 position counts exactly once.
// - Backward, dw2 pass (prenet_bwd_dw2): per tap and 64 x 64 tile of dw2,
//   a product over the output positions, split over S2 blocks; h is
//   recomputed from the mel for each 32-position step.
// - Partial sums are added in block order by prenet_sum_parts: no atomics,
//   the same result every run.
// conv1 is summed with explicit float32 roundings (no fused multiply-add),
// in tap order, in every kernel: the backward sees the forward's z and y
// bit for bit, and so does ops/cuda_prenet.py::conv1_preact on the card.

#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace sct;

constexpr int TILE = 64;    // output positions (rows) of a block tile
constexpr int CO = 64;      // channels of a block tile
constexpr int CK = 16;      // input channels one forward step stages
constexpr int KC = 32;      // reduction depth one backward step stages
constexpr int NSUM = 11;    // dy pass sums per channel: A (9), dy, dy z

// z = sum_j m[j] w[j], j = 3 a + c reading m[a * rs + c] and w[j * ws]
__device__ __forceinline__ float conv1_z(const float* m, int rs,
                                         const float* w, int ws) {
  float z = __fmul_rn(m[0], w[0]);
#pragma unroll
  for (int j = 1; j < 9; ++j)
    z = __fadd_rn(z, __fmul_rn(m[(j / 3) * rs + j % 3], w[j * ws]));
  return z;
}

__device__ __forceinline__ float conv1_y(float z, float g, float b) {
  return __fadd_rn(__fmul_rn(z, g), b);
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) / 4 * 4;
}

// forward dynamic shared memory, in floats
__host__ __device__ __forceinline__ int fwd_smem_floats(int F, int F1,
                                                        int RT) {
  return round4((4 * RT + 3) * F) + (2 * RT + 1) * F1 * CK + 9 * CK * CO +
         9 * CK + 2 * CK;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prenet_fwd(const T* __restrict__ mel, const T* __restrict__ w1c,
           const float* __restrict__ g1, const float* __restrict__ b1,
           const T* __restrict__ w2c, T* __restrict__ out, int Tm, int F,
           int C, int U1, int F1, int T2, int F2, int RT, int act) {
  extern __shared__ float4 smem4[];
  float* mel_s = reinterpret_cast<float*>(smem4);       // (4RT+3) x F
  float* h_s = mel_s + round4((4 * RT + 3) * F);        // conv1 pos x CK
  float* w2_s = h_s + (2 * RT + 1) * F1 * CK;           // 9 x CK x CO
  float* w1_s = w2_s + 9 * CK * CO;                     // 9 x CK
  float* gb_s = w1_s + 9 * CK;                          // g1, b1 (CK each)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, co0 = blockIdx.y * CO, t2_0 = blockIdx.x * RT;
  const int nmel = (4 * RT + 3) * F, nh = (2 * RT + 1) * F1 * CK;
  const T* melb = mel + (size_t)b * Tm * F;
  for (int i = tid; i < nmel; i += THREADS) {
    const int r = i / F, t = 4 * t2_0 + r;
    mel_s[i] = t < Tm ? to_f(melb[(size_t)t * F + (i - r * F)]) : 0.f;
  }
  int base[4];
  bool ok[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u, lt = r / F2, f2 = r - lt * F2;
    ok[u] = r < RT * F2 && t2_0 + lt < T2;
    base[u] = ok[u] ? 2 * lt * F1 + 2 * f2 : 0;
  }
  float acc[4][4] = {};
  for (int ci0 = 0; ci0 < C; ci0 += CK) {
    __syncthreads();                   // the previous step's reads are done
    for (int i = tid; i < 9 * CK; i += THREADS)
      w1_s[i] = to_f(w1c[(size_t)(i / CK) * C + ci0 + i % CK]);
    if (tid < CK) {
      gb_s[tid] = g1[ci0 + tid];
      gb_s[CK + tid] = b1[ci0 + tid];
    }
    for (int i = tid; i < 9 * CK * CO; i += THREADS) {
      const int c = i % CO, k = (i / CO) % CK, t = i / (CO * CK);
      w2_s[i] = to_f(w2c[((size_t)t * C + ci0 + k) * C + co0 + c]);
    }
    __syncthreads();
    for (int i = tid; i < nh; i += THREADS) {
      const int k = i % CK, pos = i / CK, r1 = pos / F1, f1 = pos - r1 * F1;
      float h = 0.f;
      if (2 * t2_0 + r1 < U1) {
        const float z = conv1_z(mel_s + 2 * r1 * F + 2 * f1, F, w1_s + k, CK);
        h = round_to<T>(activate(conv1_y(z, gb_s[k], gb_s[CK + k]), act));
      }
      h_s[i] = h;
    }
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * F1 + t % 3;
      const float* wt = w2_s + t * CK * CO + 4 * tx;
#pragma unroll 4
      for (int k = 0; k < CK; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(wt + k * CO);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float a = h_s[(base[u] + off) * CK + k];
          acc[u][0] = fmaf(a, w.x, acc[u][0]);
          acc[u][1] = fmaf(a, w.y, acc[u][1]);
          acc[u][2] = fmaf(a, w.z, acc[u][2]);
          acc[u][3] = fmaf(a, w.w, acc[u][3]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!ok[u]) continue;
    const int r = ty + 16 * u, lt = r / F2, f2 = r - lt * F2;
    T* o = out + (((size_t)b * T2 + t2_0 + lt) * F2 + f2) * C + co0 + 4 * tx;
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = from_f<T>(acc[u][v]);
  }
}

// dy pass. grid (S1, C / CO). Work items (b, tile, phase), phase fastest;
// block s owns items [n s / S1, n (s + 1) / S1). part (S1, NSUM, C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
prenet_bwd_dy(const T* __restrict__ mel, const T* __restrict__ w1c,
              const float* __restrict__ g1, const float* __restrict__ b1,
              const T* __restrict__ w2c, const T* __restrict__ du,
              float* __restrict__ part, int Tm, int F, int C, int U1, int F1,
              int T2, int F2, int tiles, int n_items, int act) {
  __shared__ float Ds[TILE][KC + 1];     // du at one tap: position x co
  __shared__ __align__(16) float Ws[KC][CO + 4];  // w2[t][ci][co] as [co][ci]
  __shared__ float Ms[TILE][9];          // the positions' patches
  __shared__ float w1_s[9][CO], gb_s[2][CO];
  __shared__ float red[16][CO];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ci0 = blockIdx.y * CO, S = gridDim.x, s = blockIdx.x;
  for (int i = tid; i < 9 * CO; i += THREADS)
    w1_s[i / CO][i % CO] = to_f(w1c[(size_t)(i / CO) * C + ci0 + i % CO]);
  if (tid < CO) {
    gb_s[0][tid] = g1[ci0 + tid];
    gb_s[1][tid] = b1[ci0 + tid];
  }
  float accA[9][4] = {}, asdy[4] = {}, asdyz[4] = {};
  const int lo = (int)((long long)n_items * s / S);
  const int hi = (int)((long long)n_items * (s + 1) / S);
  for (int item = lo; item < hi; ++item) {
    const int p = item % 4, tile = (item / 4) % tiles, b = item / (4 * tiles);
    const int pt = p >> 1, pf = p & 1;
    const int Vq = (F1 - pf + 1) / 2, nq = (U1 - pt + 1) / 2 * Vq;
    const int q0 = tile * TILE;
    if (q0 >= nq) continue;                       // the same for the block
    __syncthreads();                 // the previous item's Ms reads are done
    for (int i = tid; i < TILE * 9; i += THREADS) {
      const int r = i / 9, j = i - r * 9, q = q0 + r;
      float m = 0.f;
      if (q < nq) {
        const int u = q / Vq, v = q - u * Vq;
        const int t1 = 2 * u + pt, f1 = 2 * v + pf;
        m = to_f(mel[((size_t)b * Tm + 2 * t1 + j / 3) * F + 2 * f1 + j % 3]);
      }
      Ms[r][j] = m;
    }
    float acc[4][4] = {};
    for (int dt = pt; dt < 3; dt += 2) {
      for (int df = pf; df < 3; df += 2) {
        const int t = dt * 3 + df, sht = (dt - pt) / 2, shf = (df - pf) / 2;
        for (int k0 = 0; k0 < C; k0 += KC) {
          __syncthreads();
          for (int i = tid; i < TILE * KC; i += THREADS) {
            const int r = i / KC, k = i - r * KC, q = q0 + r;
            float d = 0.f;
            if (q < nq) {
              const int u = q / Vq, v = q - u * Vq;
              const int t2 = u - sht, f2 = v - shf;
              if (t2 >= 0 && t2 < T2 && f2 >= 0 && f2 < F2)
                d = to_f(du[(((size_t)b * T2 + t2) * F2 + f2) * C + k0 + k]);
            }
            Ds[r][k] = d;
          }
          for (int i = tid; i < KC * CO; i += THREADS) {
            const int c = i / KC, k = i - c * KC;
            Ws[k][c] = to_f(w2c[((size_t)t * C + ci0 + c) * C + k0 + k]);
          }
          __syncthreads();
#pragma unroll 4
          for (int k = 0; k < KC; ++k) {
            const float4 w = *reinterpret_cast<const float4*>(&Ws[k][4 * tx]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float a = Ds[ty + 16 * u][k];
              acc[u][0] = fmaf(a, w.x, acc[u][0]);
              acc[u][1] = fmaf(a, w.y, acc[u][1]);
              acc[u][2] = fmaf(a, w.z, acc[u][2]);
              acc[u][3] = fmaf(a, w.w, acc[u][3]);
            }
          }
        }
      }
    }
    // dy and the sums, rows ty + 16 u, channels ci0 + 4 tx + v
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ty + 16 * u;
      const bool valid = q0 + r < nq;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = 4 * tx + v;
        const float z = conv1_z(&Ms[r][0], 3, &w1_s[0][c], CO);
        const float y = conv1_y(z, gb_s[0][c], gb_s[1][c]);
        const float dy = valid ? activate_grad(y, act) * acc[u][v] : 0.f;
        const float dyc = round_to<T>(dy);
#pragma unroll
        for (int j = 0; j < 9; ++j) accA[j][v] += Ms[r][j] * dyc;
        asdy[v] += dy;
        asdyz[v] += dy * z;
      }
    }
  }
  // the block's partial: the 16 row groups added in order
  float* o = part + (size_t)s * NSUM * C + ci0;
#pragma unroll
  for (int qi = 0; qi < NSUM; ++qi) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 4; ++v)
      red[ty][4 * tx + v] = qi < 9 ? accA[qi < 9 ? qi : 0][v]
                                   : (qi == 9 ? asdy[v] : asdyz[v]);
    __syncthreads();
    if (tid < CO) {
      float acc = 0.f;
      for (int w = 0; w < 16; ++w) acc += red[w][tid];
      o[(size_t)qi * C + tid] = acc;
    }
  }
}

// dw2 pass. grid (S2, (C / CO)^2, 9): split, (ci tile, co tile), tap.
// part (S2, 9, C, C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
prenet_bwd_dw2(const T* __restrict__ mel, const T* __restrict__ w1c,
               const float* __restrict__ g1, const float* __restrict__ b1,
               const T* __restrict__ du, float* __restrict__ part, int B,
               int Tm, int F, int C, int T2, int F2, int act) {
  __shared__ float Ms[KC][9];
  __shared__ float Hs[KC][CO];                  // h: position x ci
  __shared__ __align__(16) float Gs[KC][CO];   // du: position x co
  __shared__ float w1_s[9][CO], gb_s[2][CO];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nt = C / CO, t = blockIdx.z, dt = t / 3, df = t % 3;
  const int ci0 = (blockIdx.y / nt) * CO, co0 = (blockIdx.y % nt) * CO;
  const int S = gridDim.x, s = blockIdx.x, per_b = T2 * F2;
  for (int i = tid; i < 9 * CO; i += THREADS)
    w1_s[i / CO][i % CO] = to_f(w1c[(size_t)(i / CO) * C + ci0 + i % CO]);
  if (tid < CO) {
    gb_s[0][tid] = g1[ci0 + tid];
    gb_s[1][tid] = b1[ci0 + tid];
  }
  const long long n = (long long)B * per_b;
  const int lo = (int)(n * s / S), hi = (int)(n * (s + 1) / S);
  float acc[4][4] = {};
  for (int p0 = lo; p0 < hi; p0 += KC) {
    __syncthreads();
    for (int i = tid; i < KC * 9; i += THREADS) {
      const int k = i / 9, j = i - k * 9, p = p0 + k;
      float m = 0.f;
      if (p < hi) {
        const int b = p / per_b, rem = p - b * per_b;
        const int t2 = rem / F2, f2 = rem - t2 * F2;
        const int t1 = 2 * t2 + dt, f1 = 2 * f2 + df;
        m = to_f(mel[((size_t)b * Tm + 2 * t1 + j / 3) * F + 2 * f1 + j % 3]);
      }
      Ms[k][j] = m;
    }
    for (int i = tid; i < KC * CO; i += THREADS) {
      const int k = i / CO, c = i - k * CO, p = p0 + k;
      Gs[k][c] = p < hi ? to_f(du[(size_t)p * C + co0 + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < KC * CO; i += THREADS) {
      const int k = i / CO, c = i - k * CO;
      float h = 0.f;
      if (p0 + k < hi) {
        const float z = conv1_z(&Ms[k][0], 3, &w1_s[0][c], CO);
        h = round_to<T>(activate(conv1_y(z, gb_s[0][c], gb_s[1][c]), act));
      }
      Hs[k][c] = h;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 g = *reinterpret_cast<const float4*>(&Gs[k][4 * tx]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = Hs[k][ty + 16 * u];
        acc[u][0] = fmaf(a, g.x, acc[u][0]);
        acc[u][1] = fmaf(a, g.y, acc[u][1]);
        acc[u][2] = fmaf(a, g.z, acc[u][2]);
        acc[u][3] = fmaf(a, g.w, acc[u][3]);
      }
    }
  }
  float* o = part + ((size_t)s * 9 + t) * C * C;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      o[(size_t)(ci0 + ty + 16 * u) * C + co0 + 4 * tx + v] = acc[u][v];
}


// ---- bf16: the same kernels with their products on the tensor cores ----
// mma.sync m16n8k16 (bf16 in, float32 accumulate); each warp owns 16 rows
// and 32 columns (4 tiles of 8) of each 64 x 64 tile. The products of bf16
// values are exact in float32, so only the order of the float32 sums
// differs from the FMA kernels, and every rounding point is theirs. With
// the products this fast, recomputing conv1 on the FMA units bounds the
// kernels, so the forward and dw2 blocks own up to 4 tiles of 64 output
// channels and compute conv1 once for all of them.

constexpr int CKT = 32;     // input channels one forward step stages
constexpr int KT = 64;      // reduction depth one backward step stages
constexpr int HS = CKT + 8; // bf16 row strides of the staged tiles (the
constexpr int KS = KT + 8;  // pad spreads a fragment's rows over banks)

// the eight values of v to dst[0], dst[stride], ..., dst[7 stride]
__device__ __forceinline__ void scatter8(__nv_bfloat16* dst, int stride,
                                         uint4 v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j * stride] = e[j];
}

// h = act(g1 conv1 + b1) for the npos conv1 positions of a forward block
// and CKT channels from ci0, into h_s (positions x HS, bf16): a thread
// keeps a position's 9 mel values in registers for 16 channels.
__device__ __forceinline__ void conv1_tile(__nv_bfloat16* h_s,
                                           const float* mel_s,
                                           const float* w1_s,
                                           const float* gb_s, int npos,
                                           int F, int F1, int rows1,
                                           int act) {
  for (int it = threadIdx.x; it < npos * (CKT / 16); it += THREADS) {
    const int pos = it / (CKT / 16), k0 = (it % (CKT / 16)) * 16;
    const int r1 = pos / F1, f1 = pos - r1 * F1;
    __nv_bfloat162* hp =
        reinterpret_cast<__nv_bfloat162*>(h_s + pos * HS + k0);
    if (r1 >= rows1) {                       // past the last conv1 row
#pragma unroll
      for (int k = 0; k < 16; k += 2)
        hp[k / 2] = __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    float m[9];
    const float* mp = mel_s + 2 * r1 * F + 2 * f1;
#pragma unroll
    for (int j = 0; j < 9; ++j) m[j] = mp[(j / 3) * F + j % 3];
#pragma unroll
    for (int k = k0; k < k0 + 16; k += 2) {
      const float h0 = activate(
          conv1_y(conv1_z(m, 3, w1_s + k, CKT), gb_s[k], gb_s[CKT + k]), act);
      const float h1 = activate(
          conv1_y(conv1_z(m, 3, w1_s + k + 1, CKT), gb_s[k + 1],
                  gb_s[CKT + k + 1]), act);
      hp[(k - k0) / 2] = __floats2bfloat162_rn(h0, h1);
    }
  }
}

// A block owns RT output rows of one utterance and NCT (<= 4) tiles of 64
// output channels, so conv1 is computed once per row tile for all of them
// (the FMA kernel recomputes it per 64-channel tile).
constexpr int NCT = 4;

__global__ void __launch_bounds__(THREADS)
prenet_fwd_tc(const __nv_bfloat16* __restrict__ mel,
              const __nv_bfloat16* __restrict__ w1c,
              const float* __restrict__ g1, const float* __restrict__ b1,
              const __nv_bfloat16* __restrict__ w2c,
              __nv_bfloat16* __restrict__ out, int Tm, int F, int C, int U1,
              int F1, int T2, int F2, int RT, int act) {
  extern __shared__ float4 smem4[];
  const int nmel = (4 * RT + 3) * F, npos = (2 * RT + 1) * F1;
  float* mel_s = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* h_s =                                   // conv1 pos x HS
      reinterpret_cast<__nv_bfloat16*>(mel_s + round4(nmel));
  __nv_bfloat16* w_s = h_s + npos * HS;                  // (t, co) x HS
  float* w1_s = reinterpret_cast<float*>(w_s + 9 * CO * HS);  // 9 x CKT
  float* gb_s = w1_s + 9 * CKT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = 2 * (lane % 4);
  const int rg = warp % 4, ch = warp / 4;     // rows 16 rg.., cols 32 ch..
  const int b = blockIdx.z, t2_0 = blockIdx.x * RT;
  const int cb = blockIdx.y * NCT * CO, nct = min(NCT, (C - cb) / CO);
  const __nv_bfloat16* melb = mel + (size_t)b * Tm * F;
  for (int i = tid; i < nmel; i += THREADS) {
    const int r = i / F, t = 4 * t2_0 + r;
    mel_s[i] = t < Tm ? to_f(melb[(size_t)t * F + (i - r * F)]) : 0.f;
  }
  int base[2];
  bool ok[2];
#pragma unroll
  for (int hlf = 0; hlf < 2; ++hlf) {
    const int r = rg * 16 + g + 8 * hlf, lt = r / F2, f2 = r - lt * F2;
    ok[hlf] = r < RT * F2 && t2_0 + lt < T2;
    base[hlf] = ok[hlf] ? 2 * lt * F1 + 2 * f2 : 0;
  }
  float acc[NCT][4][4] = {};
  for (int ci0 = 0; ci0 < C; ci0 += CKT) {
    __syncthreads();
    for (int i = tid; i < 9 * CKT; i += THREADS)
      w1_s[i] = to_f(w1c[(size_t)(i / CKT) * C + ci0 + i % CKT]);
    if (tid < CKT) {
      gb_s[tid] = g1[ci0 + tid];
      gb_s[CKT + tid] = b1[ci0 + tid];
    }
    __syncthreads();
    conv1_tile(h_s, mel_s, w1_s, gb_s, npos, F, F1, U1 - 2 * t2_0, act);
#pragma unroll
    for (int ct = 0; ct < NCT; ++ct) {
      if (ct >= nct) break;
      const int co0 = cb + ct * CO;
      if (ct > 0) __syncthreads();             // w_s of the last tile read
      // w2 as [t][co][ci]; neighbouring threads take neighbouring ci, so
      // the transposing stores fall in distinct banks
      for (int i = tid; i < 9 * CKT * (CO / 8); i += THREADS) {
        const int k = i % CKT, c = ((i / CKT) % (CO / 8)) * 8;
        const int t = i / (CKT * (CO / 8));
        scatter8(w_s + (t * CO + c) * HS + k, HS,
                 ld8(w2c + ((size_t)t * C + ci0 + k) * C + co0 + c));
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int off = (t / 3) * F1 + t % 3;
#pragma unroll
        for (int kk = 0; kk < CKT; kk += 16)
          warp_mma_k16(acc[ct], h_s + (base[0] + off) * HS,
                       h_s + (base[1] + off) * HS,
                       w_s + (t * CO + ch * 32) * HS, HS, kk);
      }
    }
  }
#pragma unroll
  for (int hlf = 0; hlf < 2; ++hlf) {
    if (!ok[hlf]) continue;
    const int r = rg * 16 + g + 8 * hlf, lt = r / F2, f2 = r - lt * F2;
    __nv_bfloat16* o = out + (((size_t)b * T2 + t2_0 + lt) * F2 + f2) * C +
                       cb + ch * 32 + q;
#pragma unroll
    for (int ct = 0; ct < NCT; ++ct) {
      if (ct >= nct) break;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        o[ct * CO + nt * 8] = __float2bfloat16(acc[ct][nt][2 * hlf]);
        o[ct * CO + nt * 8 + 1] = __float2bfloat16(acc[ct][nt][2 * hlf + 1]);
      }
    }
  }
}

// the dy pass with dh on the tensor cores; dh goes through shared memory
// to the FMA kernel's epilogue mapping
__global__ void __launch_bounds__(THREADS)
prenet_bwd_dy_tc(const __nv_bfloat16* __restrict__ mel,
                 const __nv_bfloat16* __restrict__ w1c,
                 const float* __restrict__ g1, const float* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2c,
                 const __nv_bfloat16* __restrict__ du,
                 float* __restrict__ part, int Tm, int F, int C, int U1,
                 int F1, int T2, int F2, int tiles, int n_items, int act) {
  __shared__ __align__(16) __nv_bfloat16 Ds[TILE * KS];  // position x co
  __shared__ __align__(16) __nv_bfloat16 Wt[CO * KS];    // ci x co
  __shared__ float dh_s[TILE][CO + 1];
  __shared__ float Ms[TILE][9];
  __shared__ float w1_s[9][CO], gb_s[2][CO];
  __shared__ float red[16][CO];
  __shared__ long long rowoff[TILE];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = 2 * (lane % 4);
  const int rg = warp % 4, ch = warp / 4;
  const int ci0 = blockIdx.y * CO, S = gridDim.x, s = blockIdx.x;
  for (int i = tid; i < 9 * CO; i += THREADS)
    w1_s[i / CO][i % CO] = to_f(w1c[(size_t)(i / CO) * C + ci0 + i % CO]);
  if (tid < CO) {
    gb_s[0][tid] = g1[ci0 + tid];
    gb_s[1][tid] = b1[ci0 + tid];
  }
  float accA[9][4] = {}, asdy[4] = {}, asdyz[4] = {};
  const int lo = (int)((long long)n_items * s / S);
  const int hi = (int)((long long)n_items * (s + 1) / S);
  for (int item = lo; item < hi; ++item) {
    const int p = item % 4, tile = (item / 4) % tiles, b = item / (4 * tiles);
    const int pt = p >> 1, pf = p & 1;
    const int Vq = (F1 - pf + 1) / 2, nq = (U1 - pt + 1) / 2 * Vq;
    const int q0 = tile * TILE;
    if (q0 >= nq) continue;
    __syncthreads();
    for (int i = tid; i < TILE * 9; i += THREADS) {
      const int r = i / 9, j = i - r * 9, qq = q0 + r;
      float m = 0.f;
      if (qq < nq) {
        const int u = qq / Vq, v = qq - u * Vq;
        const int t1 = 2 * u + pt, f1 = 2 * v + pf;
        m = to_f(mel[((size_t)b * Tm + 2 * t1 + j / 3) * F + 2 * f1 + j % 3]);
      }
      Ms[r][j] = m;
    }
    float acc[4][4] = {};
    for (int dt = pt; dt < 3; dt += 2) {
      for (int df = pf; df < 3; df += 2) {
        const int t = dt * 3 + df, sht = (dt - pt) / 2, shf = (df - pf) / 2;
        __syncthreads();
        if (tid < TILE) {            // each row's du row at this tap, or -1
          const int qq = q0 + tid;
          long long o = -1;
          if (qq < nq) {
            const int u = qq / Vq, v = qq - u * Vq;
            const int t2 = u - sht, f2 = v - shf;
            if (t2 >= 0 && t2 < T2 && f2 >= 0 && f2 < F2)
              o = (((long long)b * T2 + t2) * F2 + f2) * C;
          }
          rowoff[tid] = o;
        }
        for (int k0 = 0; k0 < C; k0 += KT) {
          __syncthreads();
          for (int i = tid; i < TILE * (KT / 8); i += THREADS) {
            const int r = i / (KT / 8), k = (i % (KT / 8)) * 8;
            const long long o = rowoff[r];
            *reinterpret_cast<uint4*>(Ds + r * KS + k) =
                o >= 0 ? ld8(du + o + k0 + k) : make_uint4(0, 0, 0, 0);
          }
          for (int i = tid; i < CO * (KT / 8); i += THREADS) {
            const int c = i / (KT / 8), k = (i % (KT / 8)) * 8;
            *reinterpret_cast<uint4*>(Wt + c * KS + k) =
                ld8(w2c + ((size_t)t * C + ci0 + c) * C + k0 + k);
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KT; kk += 16)
            warp_mma_k16(acc, Ds + (rg * 16 + g) * KS,
                         Ds + (rg * 16 + g + 8) * KS, Wt + ch * 32 * KS, KS,
                         kk);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = ch * 32 + nt * 8 + q;
      dh_s[rg * 16 + g][c] = acc[nt][0];
      dh_s[rg * 16 + g][c + 1] = acc[nt][1];
      dh_s[rg * 16 + g + 8][c] = acc[nt][2];
      dh_s[rg * 16 + g + 8][c + 1] = acc[nt][3];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ty + 16 * u;
      const bool valid = q0 + r < nq;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = 4 * tx + v;
        const float z = conv1_z(&Ms[r][0], 3, &w1_s[0][c], CO);
        const float y = conv1_y(z, gb_s[0][c], gb_s[1][c]);
        const float dy = valid ? activate_grad(y, act) * dh_s[r][c] : 0.f;
        const float dyc = round_to<__nv_bfloat16>(dy);
#pragma unroll
        for (int j = 0; j < 9; ++j) accA[j][v] += Ms[r][j] * dyc;
        asdy[v] += dy;
        asdyz[v] += dy * z;
      }
    }
  }
  float* o = part + (size_t)s * NSUM * C + ci0;
#pragma unroll
  for (int qi = 0; qi < NSUM; ++qi) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 4; ++v)
      red[ty][4 * tx + v] = qi < 9 ? accA[qi < 9 ? qi : 0][v]
                                   : (qi == 9 ? asdy[v] : asdyz[v]);
    __syncthreads();
    if (tid < CO) {
      float sum = 0.f;
      for (int w = 0; w < 16; ++w) sum += red[w][tid];
      o[(size_t)qi * C + tid] = sum;
    }
  }
}

// the dw2 pass on the tensor cores: A = h as [ci][position], B = du as
// [co][position]; a block owns one tap, 64 input channels and NCT (<= 4)
// tiles of 64 output channels, so h is computed once for all of them.
// grid (S2, (C / CO) * ceil(C / (NCT CO)), 9).
constexpr int KP = 32;      // positions one dw2 step stages
constexpr int PS = KP + 8;  // bf16 row stride of the staged dw2 tiles

__global__ void __launch_bounds__(THREADS)
prenet_bwd_dw2_tc(const __nv_bfloat16* __restrict__ mel,
                  const __nv_bfloat16* __restrict__ w1c,
                  const float* __restrict__ g1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ du,
                  float* __restrict__ part, int B, int Tm, int F, int C,
                  int T2, int F2, int act) {
  __shared__ float Ms[KP][9];
  __shared__ __align__(16) __nv_bfloat16 Hs[CO * PS];        // ci x pos
  __shared__ __align__(16) __nv_bfloat16 Gs[NCT * CO * PS];  // co x pos
  __shared__ float w1_s[9][CO], gb_s[2][CO];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = 2 * (lane % 4), rg = warp % 4, ch = warp / 4;
  const int nci = C / CO, t = blockIdx.z, dt = t / 3, df = t % 3;
  const int ci0 = (blockIdx.y % nci) * CO;
  const int cb = (blockIdx.y / nci) * NCT * CO;
  const int nco = min(NCT * CO, C - cb);
  const int S = gridDim.x, s = blockIdx.x, per_b = T2 * F2;
  for (int i = tid; i < 9 * CO; i += THREADS)
    w1_s[i / CO][i % CO] = to_f(w1c[(size_t)(i / CO) * C + ci0 + i % CO]);
  if (tid < CO) {
    gb_s[0][tid] = g1[ci0 + tid];
    gb_s[1][tid] = b1[ci0 + tid];
  }
  const long long n = (long long)B * per_b;
  const int lo = (int)(n * s / S), hi = (int)(n * (s + 1) / S);
  float acc[NCT][4][4] = {};
  for (int p0 = lo; p0 < hi; p0 += KP) {
    __syncthreads();
    for (int i = tid; i < KP * 9; i += THREADS) {
      const int k = i / 9, j = i - k * 9, p = p0 + k;
      float m = 0.f;
      if (p < hi) {
        const int b = p / per_b, rem = p - b * per_b;
        const int t2 = rem / F2, f2 = rem - t2 * F2;
        const int t1 = 2 * t2 + dt, f1 = 2 * f2 + df;
        m = to_f(mel[((size_t)b * Tm + 2 * t1 + j / 3) * F + 2 * f1 + j % 3]);
      }
      Ms[k][j] = m;
    }
    for (int i = tid; i < KP * (NCT * CO / 8); i += THREADS) {
      // neighbouring threads take neighbouring positions, so the
      // transposing stores fall in distinct banks
      const int k = i % KP, c = (i / KP) * 8, p = p0 + k;
      if (c < nco)
        scatter8(Gs + c * PS + k, PS,
                 p < hi ? ld8(du + (size_t)p * C + cb + c)
                        : make_uint4(0, 0, 0, 0));
    }
    __syncthreads();
    for (int i = tid; i < KP * CO; i += THREADS) {
      const int k = i % KP, c = i / KP;
      float h = 0.f;
      if (p0 + k < hi) {
        const float z = conv1_z(&Ms[k][0], 3, &w1_s[0][c], CO);
        h = activate(conv1_y(z, gb_s[0][c], gb_s[1][c]), act);
      }
      Hs[c * PS + k] = __float2bfloat16(h);
    }
    __syncthreads();
#pragma unroll
    for (int ct = 0; ct < NCT; ++ct) {
      if (ct * CO >= nco) break;
#pragma unroll
      for (int kk = 0; kk < KP; kk += 16)
        warp_mma_k16(acc[ct], Hs + (rg * 16 + g) * PS,
                     Hs + (rg * 16 + g + 8) * PS,
                     Gs + (ct * CO + ch * 32) * PS, PS, kk);
    }
  }
  float* o = part + ((size_t)s * 9 + t) * C * C;
  const size_t r0 = (size_t)(ci0 + rg * 16 + g) * C, r1 = r0 + 8 * C;
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) {
    if (ct * CO >= nco) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = cb + ct * CO + ch * 32 + nt * 8 + q;
      o[r0 + c] = acc[ct][nt][0];
      o[r0 + c + 1] = acc[ct][nt][1];
      o[r1 + c] = acc[ct][nt][2];
      o[r1 + c + 1] = acc[ct][nt][3];
    }
  }
}

// forward dynamic shared memory of prenet_fwd_tc, in bytes
__host__ __forceinline__ size_t fwd_tc_smem_bytes(int F, int F1, int RT) {
  return sizeof(float) * (round4((4 * RT + 3) * F) + 9 * CKT + 2 * CKT) +
         sizeof(__nv_bfloat16) * ((2 * RT + 1) * F1 * HS + 9 * CO * HS);
}

__global__ void prenet_sum_parts(const float* __restrict__ part,
                                 float* __restrict__ out, int n_part, int W) {
  sum_parts(part, out, n_part, W);
}

template <typename T>
cudaError_t forward(const void* mel, const void* w1c, const float* g1,
                    const float* b1, const void* w2c, void* out, int B,
                    int Tm, int F, int C, int act, cudaStream_t st) {
  const int U1 = (Tm - 3) / 2 + 1, F1 = (F - 3) / 2 + 1;
  const int T2 = (U1 - 3) / 2 + 1, F2 = (F1 - 3) / 2 + 1;
  if (T2 < 1 || F2 < 1 || F2 > TILE || C % CO) return cudaErrorInvalidValue;
  const int RT = TILE / F2;
  dim3 grid((T2 + RT - 1) / RT, C / CO, B);
  cudaError_t e;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    grid.y = (C + NCT * CO - 1) / (NCT * CO);
    const size_t smem = fwd_tc_smem_bytes(F, F1, RT);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(prenet_fwd_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    prenet_fwd_tc<<<grid, THREADS, smem, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (T*)out, Tm, F,
        C, U1, F1, T2, F2, RT, act);
  } else {
    const size_t smem = sizeof(float) * fwd_smem_floats(F, F1, RT);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(prenet_fwd<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    prenet_fwd<T><<<grid, THREADS, smem, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (T*)out, Tm, F,
        C, U1, F1, T2, F2, RT, act);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* mel, const void* w1c, const float* g1,
                     const float* b1, const void* w2c, const void* du,
                     float* dw2, float* sums, float* part1, float* part2,
                     int B, int Tm, int F, int C, int act, int S1, int S2,
                     cudaStream_t st) {
  const int U1 = (Tm - 3) / 2 + 1, F1 = (F - 3) / 2 + 1;
  const int T2 = (U1 - 3) / 2 + 1, F2 = (F1 - 3) / 2 + 1;
  if (T2 < 1 || F2 < 1 || C % CO || S1 < 1 || S2 < 1)
    return cudaErrorInvalidValue;
  const int tiles = ((U1 + 1) / 2 * ((F1 + 1) / 2) + TILE - 1) / TILE;
  const int nt = C / CO;
  const dim3 grid1(S1, C / CO), grid2(S2, nt * nt, 9);
  const dim3 grid2_tc(S2, nt * ((C + NCT * CO - 1) / (NCT * CO)), 9);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    prenet_bwd_dy_tc<<<grid1, THREADS, 0, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (const T*)du,
        part1, Tm, F, C, U1, F1, T2, F2, tiles, B * tiles * 4, act);
  } else {
    prenet_bwd_dy<T><<<grid1, THREADS, 0, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (const T*)du,
        part1, Tm, F, C, U1, F1, T2, F2, tiles, B * tiles * 4, act);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    prenet_bwd_dw2_tc<<<grid2_tc, THREADS, 0, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)du, part2, B, Tm, F,
        C, T2, F2, act);
  } else {
    prenet_bwd_dw2<T><<<grid2, THREADS, 0, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)du, part2, B, Tm, F,
        C, T2, F2, act);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  prenet_sum_parts<<<(NSUM * C + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part1, sums, S1, NSUM * C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  prenet_sum_parts<<<(9 * C * C + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part2, dw2, S2, 9 * C * C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mel (B, Tm, F) in float32 (dtype 0) or bf16 (dtype 1); w1c (9, C) and
// w2c (9, C, C) in the same type; g1, b1 (C,) float32; out (B, T2, F2, C).
int prenet_core_forward(const void* mel, const void* w1c, const float* g1,
                        const float* b1, const void* w2c, void* out, int B,
                        int Tm, int F, int C, int act, int dtype,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? forward<float>(mel, w1c, g1, b1, w2c, out, B, Tm, F, C,
                                    act, st)
                   : forward<__nv_bfloat16>(mel, w1c, g1, b1, w2c, out, B,
                                            Tm, F, C, act, st));
}

// w2c (9, C, C) in the mel's type; du (B,
// T2, F2, C) in the mel's type; dw2 (9, C, C) and sums (11 C: A (9, C),
// sum dy, sum dy z) float32 out; part1 (S1, 11 C), part2 (S2, 9 C C)
// float32 scratch.
int prenet_core_backward(const void* mel, const void* w1c, const float* g1,
                         const float* b1, const void* w2c, const void* du,
                         float* dw2, float* sums, float* part1, float* part2,
                         int B, int Tm, int F, int C, int act, int dtype,
                         int S1, int S2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? backward<float>(mel, w1c, g1, b1, w2c, du, dw2, sums,
                                     part1, part2, B, Tm, F, C, act, S1, S2,
                                     st)
                   : backward<__nv_bfloat16>(mel, w1c, g1, b1, w2c, du, dw2,
                                             sums, part1, part2, B, Tm, F, C,
                                             act, S1, S2, st));
}

}  // extern "C"
