// ColBERT MaxSim rank scan for Hopper (sm_90a): maxsim_rank_scan.
//
// Built at first use by vettore_tpu_torch/_build.py together with the other
// csrc/*.cu sources (one nvcc per source, one shared library) and bound
// through ctypes (plain C entry point at the end of this file). The entry
// point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// For every doc n (tokens x[n, 0:T, :], of which the first count[n] are
// real) and every query set b (query tokens qt[b*Q + 0:Q, :]):
//   sim(t, j)  = dot(x[n, t], qt[j])                                (dot metrics)
//              = clip((dot * tinv[n, t]) * qinv[j], -1, 1)          (cosine)
//   rank[b, n] = (count[n] == 0 ? 0 : -sum_j max_{t < count[n]} sim(t, j)) + dbias[n]
// with tinv = 1 / sqrt(|x[n, t]|^2) (0 for a zero row), an operand the scan
// cache keeps per token block. Pad query tokens are zero rows with qinv 0:
// each adds exactly 0 to a doc's total.
//
// Replaces BOTH Pallas kernels of vettore_tpu/ops/maxsim.py:
// fused_maxsim_rank_scan (body _mv_scan_body, per-token mask and norm
// operands) and fused_maxsim_rank_scan_uniform (body _mv_scan_body_u, every
// doc has T tokens, norms in the kernel). They are two kernels only because
// [NT, 1] operands pad 128x in TPU HBM. Here one kernel always reads the [N]
// counts (0.4 MB beside the 0.82 GB block at config 5), so a block whose
// docs all hold T tokens is simply the case count == T.
//
// Bound: bytes for bf16 blocks, operations for f32 ones. At BASELINE config
// 5 (N = 100,352 docs, T = 32, d = 128, B = 64 sets of Q = 4 tokens) it does
// 2*N*T*d*B*Q = 210 G operations on a 0.82 GB bf16 block: 0.253 ms at 3.35
// TB/s against 0.21 ms at the bf16 tensor-core peak. An f32 block keeps
// f32's accuracy as three TF32 products: 3 x 210 G at 495 TFLOP/s, 1.27 ms
// (the 1.64 GB block alone 0.49 ms).
//
// Design: the shared tensor-core scan skeleton (csrc/wgmma_scan.cuh: a
// persistent grid, a TMA ring across tiles, wgmma), with the flattened
// token block [N*T, d] as its rows and the query tokens [B*Q, d] as its
// columns: the Bf16 policy for bf16 blocks (queries rounded to bf16 by the
// wrapper, exact products in f32) and Tf32x3 for f32 blocks (the wrapper
// splits the queries with flat_scan.tf32_split). T and Q are powers of two
// (the wrapper pads others with zero rows) or T a multiple of 128, so a
// 128-row tile holds 128 / T whole docs and a query tile of QN columns
// QN / Q whole sets (Q <= QN). The epilogue works from the accumulator
// registers (register i = 4j + 2h + c of a thread: row 16w + l/4 + 8h,
// column 8j + 2(l%4) + c):
// - each value becomes dot * tinv of its row (cosine) or stays the dot, and
//   -inf on a pad token;
// - the max over each doc's T rows: for T <= 8 by shuffles over lane bits
//   2-4; for T >= 16 per warp (wg::warp_columns), then across the doc's
//   warps through shared memory; a doc of T >= 128 rows spans both
//   warpgroups and T / 128 chunks of a work item (a running max in each
//   warpgroup's region, then the two meet on the consumers' barrier);
// - the query scale and the clip go after the max: for qinv >= 0,
//   clip(fl(m * qinv)) is nondecreasing in m, so the max of the scaled
//   values is the scaled max, bit for bit, at a T-th of the work;
// - the sum over each set's Q columns (in the thread over c and j, by
//   shuffles over lane bits 0-1, or from shared memory), then 0 for a doc
//   with no token, the negation, dbias, and the [B, N] store.
// A set of Q > QN tokens spans Q / QN query tiles: each writes its part of
// the set's total to out[part] ([Q / QN, B, N]), dbias in part 0, and the
// wrapper sums the parts in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_scan.cuh"

namespace {

constexpr int GROUP = 64;          // rows of a consumer warpgroup
constexpr int MAX_Q = 8192;        // query tokens per set
constexpr float NEG_INF = -INFINITY;

struct MaxSimEpilogue {
  const float* tinv;   // [rows] inverse token norms (cosine)
  const int* counts;   // [n] live tokens per doc
  const float* dbias;  // [n]
  const float* qinv;   // [cols] inverse query-token norms (cosine)
  float* out;          // [parts][b][n]
  int n, tk, rows, cols, nq, b, cosine;  // rows = n * tk, cols = b * nq

  // loaded before the mainloop, used after it: for the thread's two rows,
  // the factor and the term that turn a dot into the value whose max is
  // taken (dot * scale + mask: scale the inverse norm for cosine, else 1;
  // mask 0 on a live token, -inf on a pad one), its doc's bias, and in
  // `flags` (bit h) whether its doc holds no token; the tile's inverse
  // query norms at columns t and t + 128 (staged in shared memory by
  // finish)
  struct Pre {
    float scale[2], mask[2], dbias[2], qv[2];
    int flags;
    __device__ __forceinline__ bool zero(int h) const { return flags >> h & 1; }
  };

  template <int QN>
  __device__ Pre prefetch(const wg::Frame& f) const {
    Pre p;
    p.flags = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.g * GROUP + wg::acc_row(f.t, h);
      const int doc = r / tk;
      int cnt = 0;
      p.scale[h] = 1.f;
      p.dbias[h] = 0.f;
      if (r < rows) {
        cnt = counts[doc];
        cnt = cnt < 0 ? 0 : (cnt > tk ? tk : cnt);
        p.dbias[h] = dbias[doc];
        if (cosine) p.scale[h] = tinv[r];
      }
      p.mask[h] = r - doc * tk < cnt ? 0.f : NEG_INF;
      p.flags |= (cnt == 0) << h;
      const int col = f.q0 + f.t + 128 * h;
      p.qv[h] = cosine && col < cols ? qinv[col] : 0.f;
    }
    return p;
  }

  // a doc's max of dot * tinv against query column col, made the column's
  // similarity: times qinv (staged in side), clipped (cosine)
  __device__ __forceinline__ float scaled(float m, const float* side, int col) const {
    return cosine ? fminf(fmaxf(__fmul_rn(m, side[col]), -1.f), 1.f) : m;
  }

  // rank[part][set][doc] from a (doc, set) total
  __device__ __forceinline__ void put(int doc, int set, int part, float total, bool zero,
                                      float db) const {
    if (doc < n && set < b)
      out[(static_cast<int64_t>(part) * b + set) * n + doc] =
          __fadd_rn(zero ? 0.f : -total, part == 0 ? db : 0.f);
  }

  template <int QN>
  __device__ void finish(float (&acc)[QN / 2], const wg::Frame& f, const Pre& p) const {
    const int qs = nq < QN ? nq : QN;     // columns of one set in the tile
    const int set0 = f.q0 / nq;           // the tile's first set
    const int part = (f.q0 % nq) / QN;    // its part of the set when Q > QN
    const int l = f.t % 32;
    wg::named_sync(f.bar, 128);  // the previous tile's readers of the region are done
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (f.t + 128 * h < QN) f.side[f.t + 128 * h] = p.qv[h];
    // dot * tinv (cosine) or the dot, -inf on a pad token, in place: one
    // fma, exact either way (x * s + 0 rounds once, as x * s; a pad row's
    // dot is 0, and 0 * s - inf = -inf). A select here had ptxas hold a
    // second copy of the accumulator and spill it.
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      const int h = (i / 2) % 2;
      acc[i] = fmaf(acc[i], p.scale[h], p.mask[h]);
    }

    if (tk <= 8) {
      // docs of T <= 8 rows: the rows of a doc are the lanes whose l/4
      // differ in its low log2(T) bits. One pass over j: the doc max of
      // each of the thread's 4 values, scaled; the set sums over c in the
      // thread, over lane bits 0-1 by shuffles, and for Q >= 16 over the
      // Q / 8 consecutive j of a set in a running total
      wg::named_sync(f.bar, 128);  // side holds the tile's qinv
      const bool row_writer = (l / 4) % tk == 0;
      const int per = qs / 8;  // j of one set (Q >= 16)
      int doc[2];
      float run[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) doc[h] = (f.g * GROUP + wg::acc_row(f.t, h)) / tk;
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = acc[4 * j + 2 * h + c];
#pragma unroll
            for (int e = 0; e < 3; ++e)
              if ((4 << e) < 4 * tk) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4 << e));
            v[c] = scaled(x, f.side, wg::acc_col(f.t, j, c));
            if (qs == 1 && row_writer)
              put(doc[h], set0 + wg::acc_col(f.t, j, c), part, v[c], p.zero(h), p.dbias[h]);
          }
          if (qs == 1) continue;
          float sum = __fadd_rn(v[0], v[1]);
          if (qs >= 4) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
          if (qs >= 8) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
          if (qs <= 8) {
            // the set of columns 8j + 2(l%4), rounded down to a multiple of Q
            if (row_writer && (l % 4) % (qs / 2) == 0)
              put(doc[h], set0 + (8 * j + 2 * (l % 4)) / qs, part, sum, p.zero(h), p.dbias[h]);
            continue;
          }
          run[h] = j % per == 0 ? sum : __fadd_rn(run[h], sum);
          if (j % per == per - 1 && row_writer && l % 4 == 0)
            put(doc[h], set0 + j / per, part, run[h], p.zero(h), p.dbias[h]);
        }
      return;
    }

    // docs of T >= 16 rows: each warp's 16 rows lie in one doc
    float* red = static_cast<float*>(f.red);
    wg::warp_columns<QN, float>(acc, red, f.t, wg::Max());
    // each doc of the warpgroup: its emptiness and bias in side[QN + 2 dl]
    const int span = tk < GROUP ? tk : GROUP;  // the doc's rows in this warpgroup
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg::acc_row(f.t, h);
      if (r % span == 0) {
        f.side[QN + 2 * (r / span)] = p.zero(h) ? 1.f : 0.f;
        f.side[QN + 2 * (r / span) + 1] = p.dbias[h];
      }
    }
    wg::named_sync(f.bar, 128);
    const int sets = QN / qs;
    if (tk < 2 * GROUP) {
      const int docs = GROUP / span, wpd = span / 16;  // docs in the warpgroup, warps per doc
      for (int o = f.t; o < docs * sets; o += 128) {
        const int dl = o % docs, s = o / docs;
        float total = 0.f;
        for (int k = 0; k < qs; ++k) {
          const int col = s * qs + k;
          float m = red[dl * wpd * QN + col];
          for (int w = 1; w < wpd; ++w) m = fmaxf(m, red[(dl * wpd + w) * QN + col]);
          total = __fadd_rn(total, scaled(m, f.side, col));
        }
        put((f.g * GROUP + dl * span) / tk, set0 + s, part, total, f.side[QN + 2 * dl] != 0.f,
            f.side[QN + 2 * dl + 1]);
      }
      return;
    }
    // T >= 128: one doc fills the work item, its T / 128 row tiles the
    // chunks; fold this chunk's rows into the warpgroup's running max (in
    // its tile), finish after the last chunk
    const int chunks = tk / wg::ROWS, c = (f.g / 2) % chunks;
    float* run = reinterpret_cast<float*>(f.tile);
    for (int col = f.t; col < QN; col += 128) {
      const float m = fmaxf(fmaxf(red[col], red[QN + col]), fmaxf(red[2 * QN + col], red[3 * QN + col]));
      run[col] = c == 0 ? m : fmaxf(run[col], m);
    }
    if (c + 1 < chunks) return;
    wg::named_sync(wg::CONSUMERS_BAR, 256);  // both warpgroups folded the doc's rows
    const float* other = reinterpret_cast<const float*>(wg::peer_tile<QN>(f));
    for (int s = (f.g % 2) * 128 + f.t; s < sets; s += 256) {
      float total = 0.f;
      for (int k = 0; k < qs; ++k) {
        const int col = s * qs + k;
        total = __fadd_rn(total, scaled(fmaxf(run[col], other[col]), f.side, col));
      }
      put(f.g * GROUP / tk, set0 + s, part, total, f.side[QN] != 0.f, f.side[QN + 1]);
    }
    wg::named_sync(wg::CONSUMERS_BAR, 256);  // both are done reading the running maxima
  }
};

// one query tile width: work items of T / 128 row tiles for T > 128
template <class Op, int QN>
cudaError_t launch_qn(const void* x, int ldx, const void* q, const void* q_lo, int ldq, int d,
                      const MaxSimEpilogue& epi, cudaStream_t st) {
  const int chunks = epi.tk > wg::ROWS ? epi.tk / wg::ROWS : 1;
  return wg::launch<Op, QN, MaxSimEpilogue, true>(x, ldx, q, q_lo, ldq, epi.rows, d, epi.cols,
                                                  epi, st, chunks);
}

template <class Op>
cudaError_t maxsim_scan(const void* x, int ldx, const void* q, const void* q_lo, int ldq, int d,
                        int qn, const MaxSimEpilogue& epi, cudaStream_t st) {
  if (!wg::operands_ok<Op>(x, ldx, q, q_lo, ldq, d)) return cudaErrorInvalidValue;
  if (qn == 64) return launch_qn<Op, 64>(x, ldx, q, q_lo, ldq, d, epi, st);
  if (qn == 128) return launch_qn<Op, 128>(x, ldx, q, q_lo, ldq, d, epi, st);
  if constexpr (Op::QN_MAX == 256)
    if (qn == 256) return launch_qn<Op, 256>(x, ldx, q, q_lo, ldq, d, epi, st);
  return cudaErrorInvalidValue;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// x: [n * t, d] token rows, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), with row
// stride ldx bytes; counts: [n] int32 live tokens per doc; dbias: [n] f32
// (0 live, +inf dead); tinv: [n * t] f32 inverse token norms (read only for
// cosine); q: [b * nq, d] query tokens, set-major, with row stride ldq
// bytes: rounded to bf16 for bf16 blocks, the TF32 part q_hi for f32
// blocks, whose remainder q - q_hi is q_lo (f32, stride ldq; unused for
// bf16); qinv: [b * nq] f32 inverse query-token norms (read only for
// cosine); out: [max(1, nq / qn), b, n] f32 ranks, one [b, n] part for
// each qn query columns of a set. t a power of two up to 128 or a multiple
// of 128; nq a power of two up to 8192; qn the query tile (64, 128, or 256
// for bf16 blocks). x, q and q_lo 16-byte aligned, ldx and ldq multiples of
// 16 (TMA's rule; the wrapper pads other operands).
int vt_maxsim_rank_scan(const void* x, int ldx, int x_bf16, const int* counts, const float* dbias,
                        const float* tinv, const void* q, const void* q_lo, int ldq,
                        const float* qinv, float* out, int n, int t, int d, int b, int nq,
                        int qn, int cosine, void* stream) {
  if (!counts || !dbias || !out || (cosine && (!tinv || !qinv)) || n <= 0 || b <= 0 ||
      !(t <= wg::ROWS ? pow2(t) : t % wg::ROWS == 0) || !pow2(nq) || nq > MAX_Q ||
      !(qn == 64 || qn == 128 || qn == 256) || (nq > qn && nq % qn) ||
      static_cast<int64_t>(n) * t > 0x7fffffff || static_cast<int64_t>(b) * nq > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const MaxSimEpilogue epi{tinv, counts, dbias, qinv, out, n, t, n * t, b * nq, nq, b, cosine};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return (int)maxsim_scan<wg::Bf16>(x, ldx, q, nullptr, ldq, d, qn, epi, st);
  return (int)maxsim_scan<wg::Tf32x3>(x, ldx, q, q_lo, ldq, d, qn, epi, st);
}

}  // extern "C"
