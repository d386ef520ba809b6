// int8-storage flat search kernels for Hopper (sm_90a): K3 int8_gmin_scan
// and K4 int8_rescore.
//
// Built at first use by vettore_tpu_torch/_build.py together with the other
// csrc/*.cu sources (one nvcc per source, one shared library) and bound
// through ctypes (plain C entry points at the end of this file). Every entry
// point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// FlatIndex(storage="int8") runs K3, the group selection, then K4
// (vettore_tpu_torch/ops/flat_scan.py::fused_int8_search, where the plain
// PyTorch versions sit). Rows are per-row symmetric int8 with an f32
// dequant scale; queries are quantized the same way by the wrapper.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 64;         // rows per selection group
constexpr int QT = 128;           // queries per block (K3)
constexpr int THREADS = 256;      // 16 row lanes x 16 query lanes
constexpr int RPT = GROUP / 16;   // rows per thread (4)
constexpr int QPT = QT / 16;      // queries per thread (8)
constexpr int DC = 32;            // 4-byte words staged per chunk

// the 4 bytes at word w of an int8 row of d bytes, zero past the end (zero
// lanes add nothing to a dot); whole-word loads when the row is aligned
__device__ __forceinline__ int load_word(const int8_t* row, int w, int d, bool aligned) {
  const int k = 4 * w;
  if (k >= d) return 0;
  if (aligned && k + 4 <= d) return __ldg(reinterpret_cast<const int*>(row) + w);
  unsigned v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < d) v |= (unsigned)(uint8_t)row[k + i] << (8 * i);
  return (int)v;
}

// ---------------------------------------------------------------------------
// K3 int8_gmin_scan: for int8 rows x8[r] (dequant scale[r]) and int8
// queries q8[b] (dequant qscale[b]),
//   approx     = (float(x8[r] . q8[b]) * scale[r]) * qscale[b]
//   rank[b, r] = -approx                           (dot metrics)
//              = (xsq[r] - 2 * approx) + qsq[b]    (l2 metrics)
//   gmin[b, g] = min over the 64 rows r of group g of rank[b, r] + bias[r]
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_int8_gmin_scan
// (body _int8_gmin_body). The int32 dot is exact, so the result is bit-equal
// to the plain version only if the epilogue rounds in the same order: it is
// written with __fmul_rn / __fsub_rn / __fadd_rn, which nvcc never contracts
// into an FMA.
//
// Bound: operations. At the main-path shape (N = 1,000,448, d = 768,
// B = 512) it does 2*N*d*B = 787 G int8 operations on 0.77 GB of rows; the
// H100's int8 tensor-core peak (1,979 TOP/s) puts the bound at 0.40 ms, the
// bytes at 0.23 ms.
//
// Design: K6's (csrc/adaptive_scan.cu). One block owns one 64-row group and
// a 128-query tile, so the group-min needs no reduction across blocks. Rows
// and queries stage through shared memory as packed 32-bit words (4 int8
// each) in chunks of 32 words; each thread keeps 4 x 8 int32 accumulators
// and runs __dp4a on the packed words. A width d that is not a multiple of 4
// (or an unaligned block) loads bytes one by one and zero-fills the tail
// word. The epilogue dequantizes, applies the rank and bias, takes each
// thread's min over its 4 rows and then the min over the 16 row lanes
// through shared memory (K1's epilogue). No finiteness pass: the wrapper
// proves per batch that no rank can overflow (_int8_bounded).
//
// Left for later: s8 wgmma (the int8 tensor cores) fed by TMA; this kernel
// issues dp4a on the CUDA cores.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
int8_gmin_scan_kernel(const int8_t* __restrict__ x8, const float* __restrict__ scale,
                      const float* __restrict__ xsq, const float* __restrict__ bias,
                      const int8_t* __restrict__ q8, const float* __restrict__ qscale,
                      const float* __restrict__ qsq, float* __restrict__ gmin, int ng,
                      int d, int b, int l2, int aligned) {
  __shared__ int xs[DC][GROUP + 1];
  __shared__ int qw[DC][QT + 1];
  __shared__ float red[16][QT];

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int t = threadIdx.x;
  const int tx = t % 16;  // query lane: queries tx + 16*j
  const int ty = t / 16;  // row lane: rows ty + 16*i
  const int64_t row0 = (int64_t)g * GROUP;
  const int words = (d + 3) / 4;

  int acc[RPT][QPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < words; w0 += DC) {
#pragma unroll
    for (int e = 0; e < GROUP * DC / THREADS; ++e) {
      const int idx = t + e * THREADS;
      const int r = idx / DC, c = idx % DC;
      xs[c][r] = load_word(x8 + (row0 + r) * d, w0 + c, d, aligned);
    }
#pragma unroll
    for (int e = 0; e < QT * DC / THREADS; ++e) {
      const int idx = t + e * THREADS;
      const int r = idx / DC, c = idx % DC, qb = q0 + r;
      qw[c][r] = qb < b ? load_word(q8 + (int64_t)qb * d, w0 + c, d, aligned) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      int a[RPT], w[QPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = xs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < QPT; ++j) w[j] = qw[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) part[j] = INFINITY;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    const float sr = scale[r], xr = xsq[r], br = bias[r];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int qb = q0 + tx + 16 * j;
      const float qs = qb < b ? qscale[qb] : 0.f;
      const float qv = qb < b ? qsq[qb] : 0.f;
      const float approx = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sr), qs);
      const float rank = l2 ? __fadd_rn(__fsub_rn(xr, __fmul_rn(2.f, approx)), qv) : -approx;
      part[j] = fminf(part[j], __fadd_rn(rank, br));
    }
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) red[ty][tx + 16 * j] = part[j];
  __syncthreads();
  if (t < QT && q0 + t < b) {
    float m = red[0][t];
#pragma unroll
    for (int r = 1; r < 16; ++r) m = fminf(m, red[r][t]);
    gmin[(int64_t)(q0 + t) * ng + g] = m;
  }
}

// ---------------------------------------------------------------------------
// K4 int8_rescore: out[b, s, r] = rank(dot * scale) + bias for the 64 rows
// of group gidx[b, s], with dot = sum_k float(x8[row, k]) * q[b, k] against
// the FULL f32 query; non-finite values become +inf.
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_int8_rescore
// (body _int8_rescore_body). Like the JAX body it sums the products first
// and multiplies by the row scale after; each product is rounded before the
// add (__fmul_rn, __fadd_rn), as the body's elementwise product then sum.
// A block reads and clamps its own group index (no scalar prefetch on a
// GPU).
//
// Bound: bytes. At B = 512 and gsel = 24 it gathers 512 x 24 x 64 rows of
// 768 int8 (604 MB, part of it served from L2 when queries share groups):
// 0.18 ms at 3.35 TB/s.
//
// Design: K2's (csrc/flat_scan.cu). One block per (selected group, query),
// 8 warps of 8 rows each; the 32 lanes of a warp stride over d, so each row
// read is coalesced, and a warp shuffle finishes the dot.
//
// Left for later: one block per group serving every query that selected it
// (each row read once), and 16-byte loads of 16 int8 at a time.
// ---------------------------------------------------------------------------

constexpr int K4_ROWS_PER_WARP = GROUP / (THREADS / 32);

__global__ void __launch_bounds__(THREADS)
int8_rescore_kernel(const int8_t* __restrict__ x8, const float* __restrict__ scale,
                    const float* __restrict__ xsq, const float* __restrict__ bias,
                    const float* __restrict__ q, const float* __restrict__ qsq,
                    const int* __restrict__ gidx, float* __restrict__ out, int ng, int d,
                    int gsel, int l2) {
  const int s = blockIdx.x;
  const int bq = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int gi = gidx[(int64_t)bq * gsel + s];
  gi = gi < 0 ? 0 : (gi >= ng ? ng - 1 : gi);  // never read out of bounds
  const int64_t row0 = (int64_t)gi * GROUP;
  const float* qv = q + (int64_t)bq * d;
  for (int rr = 0; rr < K4_ROWS_PER_WARP; ++rr) {
    const int64_t r = row0 + warp * K4_ROWS_PER_WARP + rr;
    const int8_t* xr = x8 + r * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32)
      acc = __fadd_rn(acc, __fmul_rn((float)__ldg(xr + k), __ldg(qv + k)));
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float dot = __fmul_rn(acc, scale[r]);
      float rank = l2 ? __fadd_rn(__fsub_rn(xsq[r], __fmul_rn(2.f, dot)), qsq[bq]) : -dot;
      rank = __fadd_rn(rank, bias[r]);
      out[((int64_t)bq * gsel + s) * GROUP + (r - row0)] = isfinite(rank) ? rank : INFINITY;
    }
  }
}

}  // namespace

extern "C" {

// x8: [n, d] int8; scale, xsq, bias: [n] f32; q8: [b, d] int8; qscale,
// qsq: [b] f32; gmin: [b, n/64] f32 output. n % 64 == 0.
int vt_int8_gmin_scan(const int8_t* x8, const float* scale, const float* xsq,
                      const float* bias, const int8_t* q8, const float* qscale,
                      const float* qsq, float* gmin, int n, int d, int b, int l2,
                      void* stream) {
  if (n <= 0 || n % GROUP || d <= 0 || b <= 0 || (b + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  const int aligned = d % 4 == 0 && reinterpret_cast<uintptr_t>(x8) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(q8) % 4 == 0;
  const dim3 grid(n / GROUP, (b + QT - 1) / QT);
  int8_gmin_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x8, scale, xsq, bias, q8, qscale, qsq, gmin, n / GROUP, d, b, l2, aligned);
  return (int)cudaGetLastError();
}

// q: [b, d] f32 (unquantized); qsq: [b] f32; gidx: [b, gsel] int32;
// out: [b, gsel, 64] f32 output.
int vt_int8_rescore(const int8_t* x8, const float* scale, const float* xsq,
                    const float* bias, const float* q, const float* qsq, const int* gidx,
                    float* out, int n, int d, int b, int gsel, int l2, void* stream) {
  if (n <= 0 || n % GROUP || d <= 0 || b <= 0 || b > 65535 || gsel <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gsel, b);
  int8_rescore_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x8, scale, xsq, bias, q, qsq, gidx, out, n / GROUP, d, gsel, l2);
  return (int)cudaGetLastError();
}

}  // extern "C"
