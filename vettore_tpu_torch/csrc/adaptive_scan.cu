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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_scan.cuh"

namespace {

constexpr int GROUP = 64;            // rows per selection group
constexpr int QT = 128;              // queries per block (K5)
constexpr int THREADS = 256;         // 16 row lanes x 16 query lanes
constexpr int RPT = GROUP / 16;      // rows per thread (4)
constexpr int QPT = QT / 16;         // queries per thread (8)
constexpr int DC = 32;               // d-chunk staged through shared memory
__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// metric codes: the order of FUSED_METRICS in ops/flat_scan.py
enum Metric { COSINE = 0, INNER = 1, NEG_INNER = 2, L2 = 3, L2_SQUARED = 4 };

// The true stage metric from a prefix dot (ops/flat_scan.py::_stage_rank):
// cosine renormalises over the prefix and clips to [-1, 1]; l2 clamps the
// expansion at 0. IEEE division and square root (no fast math), as the
// reference computes them.
__device__ __forceinline__ float stage_rank(float dot, float xsq, float qsq, int metric) {
  if (metric == COSINE) {
    const float denom = sqrtf(xsq) * sqrtf(qsq);
    const float sim = denom > 0.f ? dot / denom : 0.f;
    return 1.f - fminf(fmaxf(sim, -1.f), 1.f);
  }
  if (metric == INNER) return -dot;
  if (metric == NEG_INNER) return dot;
  const float sq = fmaxf(xsq - 2.f * dot + qsq, 0.f);
  return metric == L2 ? sqrtf(sq) : sq;
}

// ---------------------------------------------------------------------------
// K5 stage_gmin_scan: for the first `dims` columns of x,
//   rank[b, r] = stage_rank(x[r, :dims] . q[b, :dims]) + bias[r]
//   gmin[b, g] = min over the 64 rows r of group g of rank[b, r]
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_stage_gmin_scan
// (body _stage_gmin_body), the funnel's stage-1 scan.
//
// Bound: at the main-path shape (N = 1,000,448, dims = 128, B = 512) it does
// 2*N*dims*B = 131 GFLOP and writes the 2.05 GB rank matrix, about 64 FLOP
// per byte written: between the two roofs, with the FMA loop the larger
// share on CUDA cores.
//
// Design: CUDA-core FMAs. One block owns one 64-row group and a 128-query
// tile, so the group-min needs no reduction across blocks. x (row stride ld, only the
// first `dims` columns read: no prefix copy) and q stage through shared
// memory in d-chunks of 32; each of the 256 threads keeps a 4-row x 8-query
// register tile of f32 FMA accumulators (no TF32: the counterpart of
// Precision.HIGHEST; bf16 rows widen exactly, and the wrapper rounds the
// query to bf16). The epilogue writes the rank tile to shared memory as
// [query][row], so each query's 64 ranks leave as one coalesced 256-byte
// row of the [B, N] matrix, and 128 threads take the group minima from the
// same tile. Like _stage_gmin_body it runs no finiteness pass: the wrapper
// proves per batch that no rank can overflow.
//
// Left for later: K1's tensor-core mainloop (csrc/wgmma_scan.cuh, its Bf16
// and Tf32x3 policies), and writing the rank matrix in bf16 or only for the
// groups that can win.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
stage_gmin_scan_kernel(const T* __restrict__ x, const float* __restrict__ xsq,
                       const float* __restrict__ bias, const float* __restrict__ q,
                       const float* __restrict__ qsq, float* __restrict__ gmin,
                       float* __restrict__ rank, int n, int ld, int dims, int b,
                       int metric) {
  // main loop: xs [DC][GROUP+1] then qs [DC][QT+1]; epilogue: tile
  // [QT][GROUP+1] over the same bytes (+1 pads: conflict-free transposes)
  __shared__ float smem[QT * (GROUP + 1)];
  float(*xs)[GROUP + 1] = reinterpret_cast<float(*)[GROUP + 1]>(smem);
  float(*qs)[QT + 1] = reinterpret_cast<float(*)[QT + 1]>(smem + DC * (GROUP + 1));
  float(*tile)[GROUP + 1] = reinterpret_cast<float(*)[GROUP + 1]>(smem);

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int t = threadIdx.x;
  const int tx = t % 16;  // query lane: queries tx + 16*j
  const int ty = t / 16;  // row lane: rows ty + 16*i
  const int64_t row0 = (int64_t)g * GROUP;

  float acc[RPT][QPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < dims; k0 += DC) {
#pragma unroll
    for (int e = 0; e < GROUP * DC / THREADS; ++e) {
      const int idx = t + e * THREADS;
      const int r = idx / DC, c = idx % DC, k = k0 + c;
      xs[c][r] = k < dims ? load_x(x + (row0 + r) * ld + k) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < QT * DC / THREADS; ++e) {
      const int idx = t + e * THREADS;
      const int r = idx / DC, c = idx % DC, k = k0 + c, qb = q0 + r;
      qs[c][r] = (k < dims && qb < b) ? __ldg(q + (int64_t)qb * dims + k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      float a[RPT], w[QPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = xs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < QPT; ++j) w[j] = qs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the loop ended on a barrier: xs / qs are dead, the tile may reuse them
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    const float xr = xsq[row0 + r], br = bias[row0 + r];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int ql = tx + 16 * j;
      const float qv = q0 + ql < b ? qsq[q0 + ql] : 0.f;
      tile[ql][r] = stage_rank(acc[i][j], xr, qv, metric) + br;
    }
  }
  __syncthreads();

  const int ng = n / GROUP;
  if (t < QT && q0 + t < b) {
    float m = tile[t][0];
    for (int r = 1; r < GROUP; ++r) m = fminf(m, tile[t][r]);
    gmin[(int64_t)(q0 + t) * ng + g] = m;
  }
  const int warp = t / 32, lane = t % 32;
  for (int ql = warp; ql < QT && q0 + ql < b; ql += THREADS / 32) {
    float* dst = rank + (int64_t)(q0 + ql) * n + row0;
    dst[lane] = tile[ql][lane];
    dst[lane + 32] = tile[ql][lane + 32];
  }
}

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

// x: [n, ld] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), of which the first
// `dims` columns are read; xsq, bias: [n] f32; q: [b, dims] f32 (already
// rounded to bf16 values by the caller when x is bf16); qsq: [b] f32;
// gmin: [b, n/64] f32 and rank: [b, n] f32 outputs; metric: the index in
// FUSED_METRICS. n % 64 == 0.
int vt_stage_gmin_scan(const void* x, int x_bf16, const float* xsq, const float* bias,
                       const float* q, const float* qsq, float* gmin, float* rank, int n,
                       int ld, int dims, int b, int metric, void* stream) {
  if (n <= 0 || n % GROUP || dims <= 0 || dims > ld || b <= 0 || metric < 0 ||
      metric > L2_SQUARED || (b + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / GROUP, (b + QT - 1) / QT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    stage_gmin_scan_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xsq, bias, q, qsq, gmin, rank, n, ld, dims, b,
        metric);
  else
    stage_gmin_scan_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), xsq, bias, q, qsq, gmin, rank, n, ld, dims, b, metric);
  return (int)cudaGetLastError();
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
