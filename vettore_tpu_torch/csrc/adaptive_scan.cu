// Adaptive-pipeline kernels for Hopper (sm_90a): K5 stage_gmin_scan,
// K6 sign_scan and K7 extract_group_rows.
//
// Built at first use by vettore_tpu_torch/_build.py together with
// flat_scan.cu (one nvcc per source, one shared library) and bound through
// ctypes (plain C entry points at the end of this file). Every entry point
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().
//
// The funnel's stage 1 runs K5 then K7; the quantized stage 1 runs K6 then
// K7 (vettore_tpu_torch/ops/pipeline.py). The plain PyTorch versions sit in
// vettore_tpu_torch/ops/flat_scan.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_scan.cuh"

namespace {

constexpr int GROUP = 64;            // rows per selection group

// metric codes: the order of FUSED_METRICS in ops/flat_scan.py
enum Metric { COSINE = 0, INNER = 1, NEG_INNER = 2, L2 = 3, L2_SQUARED = 4 };

// ---------------------------------------------------------------------------
// K5 stage_gmin_scan: for the first `dims` columns of x,
//   rank[b, r] = stage_rank(x[r, :dims] . q[b, :dims]) + bias[r]
//   gmin[b, g] = min over the 64 rows r of group g of rank[b, r]
// with stage_rank the true prefix metric (ops/flat_scan.py::_stage_rank):
// cosine renormalised over the prefix and clipped to [-1, 1], the inner
// products, and l2 / l2 squared from the expansion clamped at 0.
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_stage_gmin_scan
// (body _stage_gmin_body), the funnel's stage-1 scan.
//
// Bound: at the main-path shape (N = 1,000,448, dims = 128, B = 512) it does
// 2*N*dims*B = 131 G operations and writes the 2.05 GB rank matrix. f32
// blocks keep f32's accuracy as three TF32 products: 3 x 131 G at 495
// TFLOP/s, 0.795 ms (the bytes 0.777 ms). bf16 blocks: the bytes, ~0.70 ms
// (the operations at the bf16 peak 0.13 ms).
//
// Design: the shared tensor-core scan skeleton (csrc/wgmma_scan.cuh: a
// persistent grid, a TMA ring that loads the next tile during this one's
// epilogue, tiles of 128 rows x up to 256 queries), K1's policies as they
// are: Bf16 for bf16 blocks (the query prefix rounded to bf16 by the
// wrapper), Tf32x3 for f32 blocks (the prefix split by flat_scan.tf32_split).
// x's tensor map has inner extent dims and x's own row stride, so TMA reads
// the prefix in place and zero-fills past dims: no prefix copy, no mask.
// The epilogue works from the accumulator registers: each dot becomes its
// rank plus the row's bias in place, by one formula for all metrics (the
// rows' prefix norms and biases and the tile's query norms loaded before
// the mainloop, inverse square roots taken once per row and per column),
// the group minima come from wg::column_min,
// and the ranks leave 32 query columns at a time through the warpgroup's
// tile as [query][row] (a 272-byte row stride: conflict-free), so that each
// query's 64 ranks are one coalesced 256-byte row of the [B, N] matrix, 16
// bytes a lane, stored evict-first: the matrix is written once and read
// later by K7 for the groups that win. Like _stage_gmin_body it runs no
// finiteness pass: the wrapper proves per batch that no rank can overflow.
// ---------------------------------------------------------------------------

struct StageEpilogue {
  const float* xsq;
  const float* bias;
  const float* qsq;
  float* gmin;
  float* rank;
  int n, ng, b, metric;

  // loaded before the mainloop, used after it: the prefix norm and bias of
  // the thread's two rows, and the tile's query prefix norms at columns t
  // and t + 128 (staged in shared memory by finish)
  struct Pre {
    float xr[2], br[2], qv[2];
  };

  template <int QN>
  __device__ Pre prefetch(const wg::Frame& f) const {
    Pre p;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = (int64_t)f.g * GROUP + wg::acc_row(f.t, h);
      p.xr[h] = xsq[r];
      p.br[h] = bias[r];
      const int qb = f.q0 + f.t + 128 * h;
      p.qv[h] = qb < b ? qsq[qb] : 0.f;
    }
    return p;
  }

  // The stage rank of every metric as one formula, so that the epilogue
  // runs the same few instructions whatever the metric (with a branch per
  // metric in the unrolled loop over the accumulator, the epilogue took
  // longer than the products at dims = 128):
  //   rank = clamp(dot * mr * mc + ar + ac, lo, hi)   (then sqrt for l2)
  // with per row (mr, ar) and per query column (mc, ac):
  //   cosine             -1/|x_p|, 1    1/|q_p|, 0    [0, 2]
  //   inner product      -1, 0          1, 0          (-inf, inf)
  //   neg. inner product  1, 0          1, 0          (-inf, inf)
  //   l2, l2 squared     -2, |x_p|^2    1, |q_p|^2    [0, inf)
  // For the dot metrics and l2 this is the plain version's arithmetic
  // bit for bit (dot * -2 is exact, and the fma rounds once, as the
  // subtraction); cosine multiplies by the inverse norms where the plain
  // version divides by their product, which moves a rank by a few ulps of
  // 1, far inside K5_ATOL. 1 - clip(sim, -1, 1) is clip(1 - sim, 0, 2).
  template <int QN>
  __device__ void finish(float (&acc)[QN / 2], const wg::Frame& f, const Pre& p) const {
    constexpr int LD = GROUP + 4;  // f32 tile row: 32 queries x 272 bytes in the int16 tile
    static_assert(32 * LD * 4 <= 64 * wg::TILE_LD * 2, "32 f32 query rows fit the tile");
    const bool cosine = metric == COSINE, l2 = metric >= L2;
    const float sign = metric == NEG_INNER ? 1.f : l2 ? -2.f : -1.f;
    const float lo = cosine || l2 ? 0.f : -INFINITY, hi = cosine ? 2.f : INFINITY;
    float mr[2], ar[2];
    // the previous tile's readers of side, red and the tile passed its
    // barriers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = p.xr[h], y = p.qv[h];
      mr[h] = cosine ? -(x > 0.f ? 1.f / __fsqrt_rn(x) : 0.f) : sign;
      ar[h] = cosine ? 1.f : l2 ? x : 0.f;
      if (f.t + 128 * h < QN) {
        f.side[f.t + 128 * h] = cosine ? (y > 0.f ? 1.f / __fsqrt_rn(y) : 0.f) : 1.f;
        f.side[QN + f.t + 128 * h] = l2 ? y : 0.f;
      }
    }
    wg::named_sync(f.bar, 128);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = wg::acc_col(f.t, j, c);
          float& v = acc[4 * j + 2 * h + c];
          v = __fadd_rn(fmaf(__fmul_rn(v, mr[h]), f.side[col], ar[h]), f.side[QN + col]);
          v = fminf(fmaxf(v, lo), hi);
        }
    if (metric == L2) {
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) acc[i] = __fsqrt_rn(acc[i]);
    }
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) acc[i] = __fadd_rn(acc[i], p.br[(i / 2) % 2]);
    float* red = static_cast<float*>(f.red);
    wg::column_min<QN, float>(acc, red, f.t, f.bar);
    for (int col = f.t; col < QN; col += 128)
      if (f.q0 + col < b) gmin[(int64_t)(f.q0 + col) * ng + f.g] = red[col];
    float* tile = reinterpret_cast<float*>(f.tile);
    const int64_t row0 = (int64_t)f.g * GROUP;
#pragma unroll
    for (int pass = 0; pass < QN / 32; ++pass) {
#pragma unroll
      for (int j = 4 * pass; j < 4 * pass + 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tile[(wg::acc_col(f.t, j, c) - 32 * pass) * LD + wg::acc_row(f.t, h)] =
                acc[4 * j + 2 * h + c];
      wg::named_sync(f.bar, 128);
      for (int i = f.t; i < 32 * 16; i += 128) {
        const int col = i / 16, chunk = i % 16, qb = f.q0 + 32 * pass + col;
        if (qb < b)
          __stcs(reinterpret_cast<float4*>(rank + (int64_t)qb * n + row0 + 4 * chunk),
                 *reinterpret_cast<const float4*>(tile + col * LD + 4 * chunk));
      }
      wg::named_sync(f.bar, 128);
    }
  }
};

// ---------------------------------------------------------------------------
// K6 sign_scan: for ±1 int8 sign rows s[r] and query signs qs[b],
//   ham[b, r]  = (d - s[r] . qs[b]) >> 1   (32767 where valid[r] == 0)
//   gmin[b, g] = min over the 64 rows of group g of ham[b, r]
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::fused_sign_scan
// (body _sign_gmin_body), the quantized mode's stage-1 scan. (d - dot) is
// even (d - dot = 2 * #disagreements), so the shift is exact.
//
// Bound: bytes. At the main-path shape (N = 1,000,448, d = 768, B = 512) it
// reads 0.77 GB of signs and writes the 1.02 GB int16 matrix: 0.545 ms at
// 3.35 TB/s, above the 787 G int8 operations' 0.398 ms on the tensor cores.
//
// Design: the dots run on the shared tensor-core scan skeleton with its s8
// policy (csrc/wgmma_scan.cuh: a persistent grid, a TMA ring that loads the
// next tile during this one's epilogue, tiles of 128 rows x up to 256
// queries, rows read once from device memory). The epilogue works from the
// accumulator registers: it turns each dot into its Hamming value in place,
// takes the int32 group minima as K3 does (wg::column_min), and writes the int16 values 64 query
// columns at a time to a tile in shared memory as [query][row] (a 144-byte
// row stride: conflict-free), from which each query's 64 values leave as
// one coalesced 128-byte row of the [B, N] matrix, 16 bytes a lane, so the
// write that bounds the kernel streams.
// ---------------------------------------------------------------------------

constexpr int BIG16 = 32767;         // Hamming of invalid rows

struct SignEpilogue {
  const int8_t* valid;
  int* gmin;
  int16_t* ham;
  int n, ng, b, d;

  // the valid flags of the thread's two rows, loaded before the mainloop
  struct Pre {
    int8_t valid[2];
  };

  template <int QN>
  __device__ Pre prefetch(const wg::Frame& f) const {
    Pre p;
#pragma unroll
    for (int h = 0; h < 2; ++h) p.valid[h] = valid[(int64_t)f.g * GROUP + wg::acc_row(f.t, h)];
    return p;
  }

  template <int QN>
  __device__ void finish(int (&acc)[QN / 2], const wg::Frame& f, const Pre& p) const {
    constexpr int LD = wg::TILE_LD;
    const int64_t row0 = (int64_t)f.g * GROUP;
#pragma unroll
    for (int i = 0; i < QN / 2; ++i)
      acc[i] = p.valid[(i / 2) % 2] != 0 ? (d - acc[i]) >> 1 : BIG16;
    wg::named_sync(f.bar, 128);  // the previous tile's readers of the region are done
    int* red = static_cast<int*>(f.red);
    wg::column_min<QN, int>(acc, red, f.t, f.bar);
    for (int col = f.t; col < QN; col += 128)
      if (f.q0 + col < b) gmin[(int64_t)(f.q0 + col) * ng + f.g] = red[col];
    // 64 query columns at a time through the int16 tile, [query][row]: each
    // query's 64 values then leave as one 128-byte row, 8 lanes x 16 bytes
#pragma unroll
    for (int part = 0; part < QN / 64; ++part) {
#pragma unroll
      for (int j = 8 * part; j < 8 * part + 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            f.tile[(wg::acc_col(f.t, j, c) - 64 * part) * LD + wg::acc_row(f.t, h)] =
                (int16_t)acc[4 * j + 2 * h + c];
      wg::named_sync(f.bar, 128);
      for (int i = f.t; i < 64 * 8; i += 128) {
        const int col = i / 8, chunk = i % 8, qb = f.q0 + 64 * part + col;
        if (qb < b)
          *reinterpret_cast<uint4*>(ham + (int64_t)qb * n + row0 + 8 * chunk) =
              *reinterpret_cast<const uint4*>(f.tile + col * LD + 8 * chunk);
      }
      wg::named_sync(f.bar, 128);
    }
  }
};

// ---------------------------------------------------------------------------
// K7 extract_group_rows: out[b, c, :] = mat[b, gidx[b, c], :]
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::extract_group_rows
// (body _extract_body). The Pallas body streams a query's whole [R, L] row
// block through VMEM and rotates 8-row windows into place, because Mosaic
// cannot index rows dynamically; a GPU reads any row directly, so this is a
// plain gather of whole rows (64 f32 = 256 B or 64 int16 = 128 B each).
//
// Bound: bytes. At the quantized main path (B = 512, C = 500 int16 rows) it
// moves 2 x 32.8 MB; at the funnel's (C = 208 f32 rows) 2 x 27.3 MB.
//
// Design: one block per (query, tile of rows); the block's threads walk its
// rows in 16-byte units (uint4), so a warp reads two whole 256-byte rows (or
// four 128-byte ones) and writes its slice of the output contiguously. A
// block reads its own indices (no scalar prefetch on a GPU) and clamps each
// into [0, R), so no index reads out of range.
// ---------------------------------------------------------------------------

constexpr int K7_THREADS = 256;
constexpr int K7_UNITS = 4 * K7_THREADS;  // 16-byte units per block

__global__ void __launch_bounds__(K7_THREADS)
extract_rows_kernel(const uint4* __restrict__ mat, const int* __restrict__ gidx,
                    uint4* __restrict__ out, int rows, int c, int upr, int rpb) {
  const int bq = blockIdx.y;
  const int c0 = blockIdx.x * rpb;
  const int total = min(rpb, c - c0) * upr;
  const uint4* src = mat + (int64_t)bq * rows * upr;
  const int* idx = gidx + (int64_t)bq * c + c0;
  uint4* dst = out + ((int64_t)bq * c + c0) * upr;
  for (int u = threadIdx.x; u < total; u += K7_THREADS) {
    const int r = u / upr;
    int gi = __ldg(idx + r);
    gi = gi < 0 ? 0 : (gi >= rows ? rows - 1 : gi);
    dst[u] = __ldg(src + (int64_t)gi * upr + (u - r * upr));
  }
}

}  // namespace

extern "C" {

// x: [n, *] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1) with row stride ldx
// bytes, of which the first `dims` columns are read; xsq, bias: [n] f32;
// q: [b, dims] with row stride ldq bytes, the query prefix rounded to bf16
// for bf16 blocks, its TF32 part q_hi for f32 blocks, whose remainder
// q - q_hi is q_lo (f32, stride ldq; unused for bf16); qsq: [b] f32 of the
// f32 prefix; gmin: [b, n/64] f32 and rank: [b, n] f32 outputs; metric: the
// index in FUSED_METRICS. n % 64 == 0; x, q and q_lo 16-byte aligned, ldx
// and ldq multiples of 16 (TMA's rule; the wrapper pads other operands).
int vt_stage_gmin_scan(const void* x, int ldx, int x_bf16, const float* xsq, const float* bias,
                       const void* q, const void* q_lo, int ldq, const float* qsq, float* gmin,
                       float* rank, int n, int dims, int b, int metric, void* stream) {
  if (metric < COSINE || metric > L2_SQUARED) return (int)cudaErrorInvalidValue;
  const StageEpilogue epi{xsq, bias, qsq, gmin, rank, n, n / GROUP, b, metric};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return (int)wg::scan<wg::Bf16>(x, ldx, q, nullptr, ldq, n, dims, b, epi, st);
  return (int)wg::scan<wg::Tf32x3>(x, ldx, q, q_lo, ldq, n, dims, b, epi, st);
}

// signs: [n, d] int8 (±1) with row stride lds bytes; valid: [n] int8 (0 =
// invalid row); qsigns: [b, d] int8 (±1) with row stride ldq bytes; gmin:
// [b, n/64] int32 and ham: [b, n] int16 outputs. n % 64 == 0,
// 0 < d < 16383; signs and qsigns 16-byte aligned, lds and ldq multiples of
// 16 (TMA's rule; the wrapper pads other operands).
int vt_sign_scan(const int8_t* signs, int lds, const int8_t* valid, const int8_t* qsigns,
                 int ldq, int* gmin, int16_t* ham, int n, int d, int b, void* stream) {
  if (d >= BIG16 / 2) return (int)cudaErrorInvalidValue;
  const SignEpilogue epi{valid, gmin, ham, n, n / GROUP, b, d};
  return (int)wg::scan<wg::S8>(signs, lds, qsigns, nullptr, ldq, n, d, b, epi,
                               static_cast<cudaStream_t>(stream));
}

// mat: [b, rows, row_bytes] bytes; gidx: [b, c] int32; out: [b, c, row_bytes]
// bytes. row_bytes % 16 == 0 and mat, out 16-byte aligned.
int vt_extract_group_rows(const void* mat, const int* gidx, void* out, int b, int rows,
                          int c, int row_bytes, void* stream) {
  if (b <= 0 || b > 65535 || rows <= 0 || c < 0 || row_bytes <= 0 || row_bytes % 16 ||
      row_bytes / 16 > K7_UNITS)
    return (int)cudaErrorInvalidValue;
  if (c == 0) return (int)cudaGetLastError();
  const int upr = row_bytes / 16;
  const int rpb = K7_UNITS / upr;
  const dim3 grid((c + rpb - 1) / rpb, b);
  extract_rows_kernel<<<grid, K7_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(mat), gidx, static_cast<uint4*>(out), rows, c, upr, rpb);
  return (int)cudaGetLastError();
}

}  // extern "C"
