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
// ctc_prefix_score: out (BK, V) = psi(g + v) - psi(g), the reference's
// score(). One thread a (row, token) column; the frames are a sequential
// loop with r_nb, r_b, psi_acc and psi_init in registers. A warp holds 32
// neighbouring tokens of one row, so its loads of x[row, t, v0 .. v0 + 31]
// coalesce, and a block holds ROWS consecutive rows (the K beams of one
// utterance where K >= ROWS), whose warps read the same x lines through
// L1. x is read by utterance, never gathered to (BK, T, V). Each block
// stages its rows' r_sum = logaddexp(r_nb, r_b) and r_b, TC frames at a
// time, in shared memory.
// What bounds it: float32 operations. Per (row, token, frame) three
// logaddexps (max, subtract, absolute value, negate, exp, log1p, add),
// three adds and a select: 25 operations; conformer-small's decode step
// (BK 256, T 199, V 1000) does 5.07e7 column-frames, 1.27 GFLOP, 19 us at
// 67 TFLOP/s, against 12.7 MB of x (3.8 us at 3.35 TB/s). expf and
// log1pf run partly on the special-function units, so the kernel sits
// above that bound.
//
// ctc_prefix_update: the reference's update_state(): the lattice of each
// chosen prefix, row beam_idx[i] extended by token[i], r_new (T, 2, BK),
// and psi_new = psi[beam_idx] + scores[beam_idx, token]. One thread a
// row, a sequential recursion over T; the loads of each UNROLL frames
// (x[row, t, token], x_blank, the source row's lattice) do not depend on
// the recursion and are issued one group ahead of it, while the frames
// before them recurse. Latency-bound: ~1.2 MB moved.
//
// float32 throughout, NEG_INF = -1e20 as the reference; logaddexp(a, b) =
// max(a, b) + log1pf(expf(-|a - b|)), the reference's formula, so no -inf
// arises anywhere. No atomics: every output is written once.

#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e20f;
constexpr int ROWS = 8;       // score: warps a block, one beam row each
constexpr int TC = 32;        // score: frames of the rows' lattice staged
constexpr int UPDATE_THREADS = 128;
constexpr int UNROLL = 8;     // update: frames whose loads go out together

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__global__ void __launch_bounds__(32 * ROWS)
ctc_prefix_score_kernel(const float* __restrict__ x,
                        const float* __restrict__ xb,
                        const long long* __restrict__ enc_len,
                        const float* __restrict__ r,
                        const float* __restrict__ psi_prev,
                        const long long* __restrict__ last,
                        float* __restrict__ out, int BK, int K, int T, int V,
                        int prefix_len, int blank, int eos) {
  __shared__ float s_sum[TC][ROWS];
  __shared__ float s_b[TC][ROWS];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int v = blockIdx.x * 32 + lane;
  const int row0 = blockIdx.y * ROWS;
  const int i = row0 + w;
  const int ic = min(i, BK - 1);             // idle threads load row BK - 1
  const int vc = min(v, V - 1);
  const int b = ic / K;
  const float* xr = x + (size_t)b * T * V + vc;
  const float* xbr = xb + (size_t)b * T;
  const bool is_last = (long long)v == last[ic];
  const int start = max(prefix_len, 1);

  float r_nb = prefix_len == 0 ? xr[0] : NEG_INF;
  float r_b = NEG_INF;
  float psi_acc = NEG_INF;
  float psi_init = start == 1 ? r_nb : NEG_INF;
  const size_t R = 2 * (size_t)BK;
  for (int t0 = 0; t0 < T - 1; t0 += TC) {
    __syncthreads();                         // the last chunk's reads done
    for (int e = w * 32 + lane; e < TC * ROWS; e += 32 * ROWS) {
      const int tt = e / ROWS, rw = e % ROWS;
      const int t = t0 + tt, ii = row0 + rw;
      if (t < T && ii < BK) {
        const float a = r[t * R + ii], c = r[t * R + BK + ii];
        s_sum[tt][rw] = lae(a, c);
        s_b[tt][rw] = c;
      }
    }
    __syncthreads();
    const int n = min(TC, T - 1 - t0);
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt + 1;             // frame t reads frame t - 1
      const float phi = is_last ? s_b[tt][w] : s_sum[tt][w];
      const float xt = xr[(size_t)t * V];
      const float xbt = xbr[t];
      if (t == start) psi_init = r_nb;       // r_nb at frame start - 1
      const float nb = lae(r_nb, phi) + xt;
      const float bl = lae(r_nb, r_b) + xbt;
      psi_acc = lae(psi_acc, phi + xt);
      r_nb = nb;
      r_b = bl;
    }
  }
  if (i >= BK || v >= V) return;
  float psi = lae(psi_acc, psi_init);
  if (v == eos) {                            // the prefix's total at the
    long long lt = enc_len[b] - 1;           // last valid frame
    if (lt < 0) lt += T;
    psi = lae(r[lt * R + i], r[lt * R + BK + i]);
  }
  if (v == blank) psi = NEG_INF;
  out[(size_t)i * V + v] = psi - psi_prev[i];
}

__global__ void __launch_bounds__(UPDATE_THREADS)
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
  const int i = blockIdx.x * UPDATE_THREADS + threadIdx.x;
  if (i >= BK) return;
  const long long src = beam_idx[i], tok = token[i];
  const bool rep = tok == last[src];
  const int b = i / K;
  const float* xr = x + (size_t)b * T * V + tok;
  const float* xbr = xb + (size_t)b * T;
  const size_t R = 2 * (size_t)BK;

  float r_nb = prefix_len == 0 ? xr[0] : NEG_INF;   // new length 1
  float r_b = NEG_INF;
  r_new[i] = r_nb;
  r_new[BK + i] = r_b;
  // the loads of frames t0 .. t0 + UNROLL - 1, issued while the frames
  // before them recurse
  float xt[UNROLL], xbt[UNROLL], ra[UNROLL], rc[UNROLL];
  auto load = [&](int t0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = min(t0 + u, T - 1);
      xt[u] = xr[(size_t)t * V];
      xbt[u] = xbr[t];
      ra[u] = r[(t - 1) * R + src];
      rc[u] = r[(t - 1) * R + BK + src];
    }
  };
  if (T > 1) load(1);
  for (int t0 = 1; t0 < T; t0 += UNROLL) {
    float cx[UNROLL], cxb[UNROLL], phi[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      cx[u] = xt[u];
      cxb[u] = xbt[u];
      phi[u] = rep ? rc[u] : lae(ra[u], rc[u]);
    }
    if (t0 + UNROLL < T) load(t0 + UNROLL);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < T) {
        const float nb = lae(r_nb, phi[u]) + cx[u];
        const float bl = lae(r_nb, r_b) + cxb[u];
        r_nb = nb;
        r_b = bl;
        r_new[t * R + i] = nb;
        r_new[t * R + BK + i] = bl;
      }
    }
  }
  psi_new[i] = psi_prev[src] + scores[(size_t)src * V + tok];
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
  const int BK = B * K;
  if (BK <= 0 || T <= 0 || V <= 0 || prefix_len < 0 || blank < 0 ||
      blank >= V || eos < 0 || eos >= V)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + 31) / 32, (BK + ROWS - 1) / ROWS), block(32, ROWS);
  ctc_prefix_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, x_blank, enc_len, r, psi, last, out, BK, K, T, V, prefix_len, blank,
      eos);
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
  if (BK <= 0 || T <= 0 || V <= 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (BK + UPDATE_THREADS - 1) / UPDATE_THREADS;
  ctc_prefix_update_kernel<<<grid, UPDATE_THREADS, 0,
                             (cudaStream_t)stream>>>(
      x, x_blank, r, psi, last, scores, beam_idx, token, r_new, psi_new, BK,
      K, T, V, prefix_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
