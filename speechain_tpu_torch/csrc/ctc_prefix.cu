// CTC prefix scoring (Watanabe's Algorithm 2), batched over beam rows.
//
// Port-only: the reference computes this with two lax.scans
// (speechain_tpu/infer/ctc_scorer.py: CTCPrefixScorer.score, scan at
// :107; update_state, scan at :148), not with a Pallas kernel. Run as a
// plain PyTorch loop over frames, each scan costs ~10 launches a frame,
// ~2,000 a decode step at T_enc 199; these two kernels run each scan in
// one launch.
//
//   x (B, T, V)     CTC log-probs, frames past enc_len masked (every token
//                   NEG_INF, blank 0), as CTCPrefixScorer.__init__ builds
//   x_blank (B, T)  x's blank column
//   r (T, 2, BK)    the lattice of the current prefixes: r_nb, r_b
//   psi, last (BK)  prefix scores and last tokens (-1: empty prefix)
// Row i of the BK = B x K beam rows reads utterance i / K of x.
//
// ctc_prefix_score: out (BK, V) = psi(g + c) - psi(g), the reference's
// score(). Its scan carries r_nb, r_b and psi_acc for every (row, token)
// column, but the output reads only psi_acc and psi_init, and psi_init
// (r_nb at frame max(L, 1) - 1 for a prefix of L tokens) is x[0, c] at
// L = 0 and at most NEG_INF for L >= 1: a prefix of L + 1 tokens cannot
// end before frame L. So the score is a log-sum-exp over frames, with no
// recursion:
//   psi(i, c) = LSE over t = 0 .. T - 1 of (phi'_t(i, c) + x[b, t, c]),
//   phi'_0 = 0 at L = 0 (NEG_INF otherwise), phi'_t = r_sum[t - 1, i]
//   (r_b[t - 1, i] where c is the row's last token),
// then the eos column (the row's r_sum at its last valid frame), the blank
// column (NEG_INF) and the subtraction of psi(g), as the reference.
// One block a (tile of VT tokens, KB = 16 rows of one utterance): x[b] is
// staged TC frames x VT tokens at a time by cp.async into a ring of STAGES
// slots, so each element is read from device memory once and used for 16
// rows; the rows' phi' (in log2 units) beside it. A thread owns a token and
// RG = 8 rows: for each chunk a max pass, one exp2 a row rescaling its
// running sum to the new maximum, and a sum pass of one exp2 a
// column-frame; one log2 a column at the end. The last-token column of
// each row is then recomputed by one warp with r_b as phi (lane l over
// frames 1 + l, 33 + l, ..., FU of them loaded at once; the lanes combined
// by a butterfly in a fixed order, lane 0's result written). A beam of 8
// or fewer rows fills half a block's threads (the recipes decode at 16).
// What bounds it: the special-function units. One exp2 a column-frame,
// 16 an SM a clock: conformer-small's decode step (BK 256, T 199, V 1000)
// is 5.07e7 column-frames, ~12 us at 1.98 GHz on 132 SMs, above its
// 12.7 MB of x (3.8 us at 3.35 TB/s); a column-frame also issues ~6
// float32 instructions (FFMA and max; FFMA, subtract, add). On the H100
// it runs at ~3x that floor at V 1000 (one block an SM) and ~1.8x at V
// 5000. Tried and dropped: the next chunk's max pass inside this one's sum
// pass (slower at both), 64-token tiles (slower), and each chunk's frames
// split between two halves of a block (faster at V 1000, slower at V 5000:
// 106 registers leave one block an SM).
//
// ctc_prefix_update: the reference's update_state(): the lattice of each
// chosen prefix, row beam_idx[i] extended by token[i], r_new (T, 2, BK),
// and psi_new = psi[beam_idx] + scores[beam_idx, token]. The recursion
//   r_nb_t = (r_nb_{t-1} (+) phi_{t-1}) (x) x_t(tok),
//   r_b_t  = (r_nb_{t-1} (+) r_b_{t-1}) (x) xb_t
// is affine in the log semiring ((+) logaddexp, (x) +), so the maps of
// frames 1 .. T - 1 compose: a warp a row, each lane composes the maps of
// ceil((T - 1) / 32) consecutive frames, a 5-step shuffle scan composes
// them across lanes, and each lane replays its frames from its prefix's
// state and writes them. The row's inputs (x[b, :, tok], x_blank[b],
// phi) are staged first into shared memory by the whole warp: 3 T floats
// a row, 4 rows a block, so T is at most 4,842 frames (227 KB); a longer
// T returns cudaErrorInvalidValue (the wrapper raises first). The
// dependent chain: ~2 T / 32 + 12 logaddexps, against T - 1 for one
// thread a row, each on the special-function units (exp2, then log2 of a
// value in [1, 2]: within ~2e-7 of the reference's formula).
// Latency-bound: ~1.2 MB moved.
//
// float32 throughout, NEG_INF = -1e20 as the reference; the score's r_sum
// and eos column take logaddexp(a, b) = max(a, b) + log1pf(expf(-|a -
// b|)), the reference's formula. No -inf arises anywhere (sums of
// NEG_INFs reach -1e22 at most, finite). The kernels differ from the
// plain versions in summation order, and the update in its logaddexp's
// special functions. No atomics: every output is written once.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using sct::cp_async16;
using sct::cp_async4;

constexpr float NEG_INF = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NO_MAX = -1e30f;   // a running max before any frame
constexpr int VT = 128;            // score: tokens a block, a thread each
constexpr int RG = 8;              // score: rows a thread (a row group)
constexpr int GB = 2;              // score: row groups a block
constexpr int KB = RG * GB;        // score: rows a block
constexpr int NT = VT * GB;        // score: threads a block
constexpr int TC = 32;             // score: frames a staged chunk
constexpr int STAGES = 3;          // score: chunks in the ring
constexpr int PH = TC * RG / VT;   // score: phi' entries a thread stages
constexpr int FU = 8;              // score: last-token frames a lane loads
constexpr int UPDATE_WARPS = 4;    // update: rows a block, a warp each

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float ex2(float v) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

// logaddexp on the special-function units: max + ln 2 log2(1 + 2^(-|a -
// b| log2 e)), within ~2e-7 of lae (log2 of an argument in [1, 2])
__device__ __forceinline__ float lae_sfu(float a, float b) {
  return fmaxf(a, b) + LN2 * __log2f(1.f + ex2(-fabsf(a - b) * LOG2E));
}

// the score kernel's dynamic shared memory: the x ring and two phi' chunks
constexpr size_t SCORE_SMEM =
    sizeof(float) * ((size_t)STAGES * TC * VT + 2 * TC * KB);

// (max, sum) of this lane's partial log-sum-exp (log2 units) and that of
// lane ^ off
__device__ __forceinline__ void lse_combine(float& m, float& s, int off) {
  const float mo = __shfl_xor_sync(0xffffffffu, m, off);
  const float so = __shfl_xor_sync(0xffffffffu, s, off);
  const float mm = fmaxf(m, mo);
  s = s * ex2(m - mm) + so * ex2(mo - mm);
  m = mm;
}

__global__ void __launch_bounds__(NT)
ctc_prefix_score_kernel(const float* __restrict__ x,
                        const float* __restrict__ xb,
                        const long long* __restrict__ enc_len,
                        const float* __restrict__ r,
                        const float* __restrict__ psi_prev,
                        const long long* __restrict__ last,
                        float* __restrict__ out, int BK, int K, int T, int V,
                        int prefix_len, int blank, int eos) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                       // [STAGES][TC][VT]
  float* s_phi = smem + STAGES * TC * VT;  // [2][TC][KB], log2 units
  const int tid = threadIdx.x;
  const int col = tid % VT, g = tid / VT;
  const int v0 = blockIdx.x * VT, v = v0 + col;
  const int nkb = (K + KB - 1) / KB;
  const int b = blockIdx.y / nkb, k0 = (blockIdx.y % nkb) * KB;
  const int rows = min(KB, K - k0);        // valid rows of this block
  const int i0 = b * K + k0;               // the block's first row
  const float* xu = x + (size_t)b * T * V;
  const size_t R = 2 * (size_t)BK;
  const int nch = (T + TC - 1) / TC;
  const bool vec = V % 4 == 0;

  auto load_x = [&](int j) {               // chunk j into its ring slot
    float* dst = s_x + (j % STAGES) * TC * VT;
    const int t0 = j * TC, n = min(TC, T - t0);
    if (vec) {
      for (int e = tid; e < n * (VT / 4); e += NT) {
        const int tt = e / (VT / 4), c = 4 * (e % (VT / 4));
        const bool ok = v0 + c < V;
        cp_async16(dst + tt * VT + c,
                   ok ? xu + (size_t)(t0 + tt) * V + v0 + c : xu, ok);
      }
    } else {
      for (int e = tid; e < n * VT; e += NT) {
        const int tt = e / VT, c = e % VT;
        const bool ok = v0 + c < V;
        cp_async4(dst + tt * VT + c,
                  ok ? xu + (size_t)(t0 + tt) * V + v0 + c : xu, ok);
      }
    }
  };
  // phi' of chunk j's frames for the block's rows, times log2(e), PH
  // entries a thread: the lattice values fetched into registers a chunk
  // ahead, so their latency hides behind chunk j - 1's passes
  float ra[PH], rc[PH];
  auto fetch_phi = [&](int j) {
#pragma unroll
    for (int u = 0; u < PH; ++u) {
      const int e = tid + u * NT, k = e % KB, t = j * TC + e / KB;
      if (t >= 1 && t < T && k < rows) {
        const size_t o = (size_t)(t - 1) * R + i0 + k;
        ra[u] = r[o];
        rc[u] = r[o + BK];
      }
    }
  };
  auto store_phi = [&](int j) {
#pragma unroll
    for (int u = 0; u < PH; ++u) {
      const int e = tid + u * NT, k = e % KB, t = j * TC + e / KB;
      float p = NEG_INF;
      if (t == 0)
        p = prefix_len == 0 ? 0.f : NEG_INF;
      else if (t < T && k < rows)
        p = lae(ra[u], rc[u]);
      s_phi[(j & 1) * TC * KB + e] = p * LOG2E;
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nch) load_x(j);
    sct::cp_async_commit();
  }
  fetch_phi(0);
  store_phi(0);
  float m[RG], s[RG];
#pragma unroll
  for (int q = 0; q < RG; ++q) {
    m[q] = NO_MAX;
    s[q] = 0.f;
  }
  for (int j = 0; j < nch; ++j) {
    sct::cp_async_wait<STAGES - 2>();
    __syncthreads();                       // chunk j and its phi' landed;
    if (j + STAGES - 1 < nch) load_x(j + STAGES - 1);   // slot j - 1 and
    sct::cp_async_commit();                // phi' buffer j + 1 are free
    if (j + 1 < nch) fetch_phi(j + 1);
    const float* xs = s_x + (j % STAGES) * TC * VT + col;
    const float4* ph =
        reinterpret_cast<const float4*>(s_phi + (j & 1) * TC * KB + g * RG);
    const int n = min(TC, T - j * TC);
    float mc[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) mc[q] = m[q];
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {       // the chunk's maximum
      const float xv = xs[tt * VT];
      const float4 p0 = ph[tt * (KB / 4)], p1 = ph[tt * (KB / 4) + 1];
      const float p[RG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int q = 0; q < RG; ++q) mc[q] = fmaxf(mc[q], fmaf(xv, LOG2E, p[q]));
    }
#pragma unroll
    for (int q = 0; q < RG; ++q) {         // the sum rescaled to it
      s[q] *= ex2(m[q] - mc[q]);
      m[q] = mc[q];
    }
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float xv = xs[tt * VT];
      const float4 p0 = ph[tt * (KB / 4)], p1 = ph[tt * (KB / 4) + 1];
      const float p[RG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int q = 0; q < RG; ++q) s[q] += ex2(fmaf(xv, LOG2E, p[q]) - m[q]);
    }
    if (j + 1 < nch) store_phi(j + 1);
  }

  if (v < V) {
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      const int k = g * RG + q;
      if (k >= rows) break;
      const int i = i0 + k;
      float psi;
      if (v == eos) {                      // the prefix's total at the
        long long lt = enc_len[b] - 1;     // last valid frame
        if (lt < 0) lt += T;
        psi = lae(r[lt * R + i], r[lt * R + BK + i]);
      } else if (v == blank) {
        psi = NEG_INF;
      } else if ((long long)v == last[i]) {
        continue;                          // the warps' pass below
      } else {
        psi = (m[q] + __log2f(s[q])) * LN2;
      }
      out[(size_t)i * V + v] = psi - psi_prev[i];
    }
  }

  // the last-token columns in this tile: phi'_t = r_b[t - 1] (t >= 1; at
  // t = 0 phi' is NEG_INF, a last token meaning L >= 1)
  const int lane = tid % 32, w = tid / 32;
  for (int k = w; k < rows; k += NT / 32) {
    const int i = i0 + k;
    const long long c = last[i];
    if (c < v0 || c >= min(v0 + VT, V) || c == eos || c == blank) continue;
    const float* xc = xu + c;
    const float* rb = r + BK + i;
    float mx = NO_MAX, sm = 0.f;
    for (int t0 = 1; t0 < T; t0 += 32 * FU) {   // FU frames a lane at once
      float tv[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const int t = t0 + lane + 32 * u;
        tv[u] = t < T ? fmaf(xc[(size_t)t * V], LOG2E, rb[(t - 1) * R] * LOG2E)
                      : NO_MAX;
      }
      float mc = mx;
#pragma unroll
      for (int u = 0; u < FU; ++u) mc = fmaxf(mc, tv[u]);
      sm *= ex2(mx - mc);
      mx = mc;
#pragma unroll
      for (int u = 0; u < FU; ++u)
        if (t0 + lane + 32 * u < T) sm += ex2(tv[u] - mx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lse_combine(mx, sm, off);
    if (lane == 0)
      out[(size_t)i * V + c] =
          (sm > 0.f ? (mx + __log2f(sm)) * LN2 : NEG_INF) - psi_prev[i];
  }
}

// A map of the log semiring from the lattice at one frame, (n, k) =
// (r_nb, r_b), to a later one: (lse(a + n, b + k, c), lse(d + n, e + k, f)).
struct Map {
  float a, b, c, d, e, f;
};

__device__ __forceinline__ Map identity_map() {
  return {0.f, NEG_INF, NEG_INF, NEG_INF, 0.f, NEG_INF};
}

// frame t's step after m: r_nb = (r_nb (+) phi) + xt, r_b = (r_nb (+) r_b)
// + xbt
__device__ __forceinline__ Map then_frame(const Map& m, float xt, float xbt,
                                          float phi) {
  return {m.a + xt, m.b + xt, lae_sfu(m.c, phi) + xt,
          lae_sfu(m.a, m.d) + xbt, lae_sfu(m.b, m.e) + xbt,
          lae_sfu(m.c, m.f) + xbt};
}

// f after g
__device__ __forceinline__ Map compose(const Map& f, const Map& g) {
  return {lae_sfu(f.a + g.a, f.b + g.d), lae_sfu(f.a + g.b, f.b + g.e),
          lae_sfu(lae_sfu(f.a + g.c, f.b + g.f), f.c),
          lae_sfu(f.d + g.a, f.e + g.d), lae_sfu(f.d + g.b, f.e + g.e),
          lae_sfu(lae_sfu(f.d + g.c, f.e + g.f), f.f)};
}

__device__ __forceinline__ Map shfl_up_map(const Map& m, int d) {
  const unsigned all = 0xffffffffu;
  return {__shfl_up_sync(all, m.a, d), __shfl_up_sync(all, m.b, d),
          __shfl_up_sync(all, m.c, d), __shfl_up_sync(all, m.d, d),
          __shfl_up_sync(all, m.e, d), __shfl_up_sync(all, m.f, d)};
}

__global__ void __launch_bounds__(32 * UPDATE_WARPS)
ctc_prefix_update_kernel(const float* __restrict__ x,
                         const float* __restrict__ xb,
                         const float* __restrict__ r,
                         const float* __restrict__ psi_prev,
                         const long long* __restrict__ last,
                         const float* __restrict__ scores,
                         const long long* __restrict__ beam_idx,
                         const long long* __restrict__ token,
                         float* __restrict__ r_new,
                         float* __restrict__ psi_new, int BK, int K, int T,
                         int V, int prefix_len) {
  extern __shared__ float s_row[];           // [UPDATE_WARPS][3][T]
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i = blockIdx.x * UPDATE_WARPS + w;
  if (i >= BK) return;                       // a whole warp; no block barrier
  const long long src = beam_idx[i], tok = token[i];
  const bool rep = tok == last[src];
  const int b = i / K;
  const size_t R = 2 * (size_t)BK;
  float* sx = s_row + (size_t)w * 3 * T;     // x[b, t, tok]
  float* sxb = sx + T;                       // x_blank[b, t]
  float* sphi = sxb + T;                     // phi of frame t + 1's step
  for (int t = lane; t < T; t += 32) {
    sx[t] = x[((size_t)b * T + t) * V + tok];
    sxb[t] = xb[(size_t)b * T + t];
    if (t < T - 1) {
      const float na = r[t * R + src], nb = r[t * R + BK + src];
      sphi[t] = rep ? nb : lae_sfu(na, nb);
    }
  }
  __syncwarp();

  // lane's frames [lo, hi) of 1 .. T - 1, their maps composed
  const int per = (T - 1 + 31) / 32;
  const int lo = min(T, 1 + lane * per), hi = min(T, lo + per);
  Map f = identity_map();
  for (int t = lo; t < hi; ++t) f = then_frame(f, sx[t], sxb[t], sphi[t - 1]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {         // inclusive scan over lanes
    const Map g = shfl_up_map(f, d);
    if (lane >= d) f = compose(f, g);
  }
  const Map pre = shfl_up_map(f, 1);         // lanes before this one

  const float nb0 = prefix_len == 0 ? sx[0] : NEG_INF;   // new length 1
  const float bb0 = NEG_INF;
  float n = nb0, k = bb0;
  if (lane > 0) {
    n = lae_sfu(lae_sfu(pre.a + nb0, pre.b + bb0), pre.c);
    k = lae_sfu(lae_sfu(pre.d + nb0, pre.e + bb0), pre.f);
  } else {
    r_new[i] = nb0;
    r_new[BK + i] = bb0;
    psi_new[i] = psi_prev[src] + scores[(size_t)src * V + tok];
  }
  for (int t = lo; t < hi; ++t) {
    const float nn = lae_sfu(n, sphi[t - 1]) + sx[t];
    k = lae_sfu(n, k) + sxb[t];
    n = nn;
    r_new[t * R + i] = n;
    r_new[t * R + BK + i] = k;
  }
}

}  // namespace

extern "C" {

// out (BK, V) float32; x (B, T, V), x_blank (B, T), r (T, 2, BK), psi (BK)
// float32; enc_len (B), last (BK) int64; BK = B K; prefix_len the prefixes'
// length (one for all rows).
int ctc_prefix_score(const float* x, const float* x_blank,
                     const long long* enc_len, const float* r,
                     const float* psi, const long long* last, float* out,
                     int B, int K, int T, int V, int prefix_len, int blank,
                     int eos, void* stream) {
  if (B <= 0 || K <= 0 || T <= 0 || V <= 0 || prefix_len < 0 || blank < 0 ||
      blank >= V || eos < 0 || eos >= V)
    return (int)cudaErrorInvalidValue;
  static sct::SmemSet set;
  cudaError_t err =
      sct::allow_smem(ctc_prefix_score_kernel, SCORE_SMEM, set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + VT - 1) / VT, B * ((K + KB - 1) / KB));
  ctc_prefix_score_kernel<<<grid, NT, SCORE_SMEM, (cudaStream_t)stream>>>(
      x, x_blank, enc_len, r, psi, last, out, B * K, K, T, V, prefix_len,
      blank, eos);
  return (int)cudaGetLastError();
}

// r_new (T, 2, BK), psi_new (BK) float32 out; scores (BK, V) the score
// entry's output for these prefixes; beam_idx, token (BK) int64, every
// beam_idx in [0, BK) and token in [0, V); prefix_len the length before
// the update.
int ctc_prefix_update(const float* x, const float* x_blank, const float* r,
                      const float* psi, const long long* last,
                      const float* scores, const long long* beam_idx,
                      const long long* token, float* r_new, float* psi_new,
                      int B, int K, int T, int V, int prefix_len,
                      void* stream) {
  const int BK = B * K;
  const size_t smem = sizeof(float) * 3 * (size_t)T * UPDATE_WARPS;
  if (BK <= 0 || T <= 0 || V <= 0 || prefix_len < 0 ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  static sct::SmemSet set;
  cudaError_t err = sct::allow_smem(ctc_prefix_update_kernel, smem, set);
  if (err != cudaSuccess) return (int)err;
  const int grid = (BK + UPDATE_WARPS - 1) / UPDATE_WARPS;
  ctc_prefix_update_kernel<<<grid, 32 * UPDATE_WARPS, smem,
                             (cudaStream_t)stream>>>(
      x, x_blank, r, psi, last, scores, beam_idx, token, r_new, psi_new, BK,
      K, T, V, prefix_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
