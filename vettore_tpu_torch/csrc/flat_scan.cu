// Exact flat search kernels for Hopper (sm_90a): K1 gmin_scan and K2 rescore.
//
// Built at first use by vettore_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c flat_scan.cu
// linked with the other csrc/*.cu objects into one shared library, and bound
// through ctypes (plain C entry points at the end of this file).
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// Rank keys (ascending = better), shared by both kernels and by their plain
// PyTorch versions in vettore_tpu_torch/ops/flat_scan.py:
//   dot metrics (cosine, inner_product, negative_inner_product): -x.q
//   l2 metrics (l2, l2_squared):                                 xsq - 2 x.q + qsq
// plus a per-row bias (0 for live rows, +inf for dead rows; dead rows are
// all-zero, so their rank is exactly +inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 64;  // rows per selection group

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ---------------------------------------------------------------------------
// K1 gmin_scan: gmin[b, g] = min over the 64 rows r of group g of
//   rank(x[r] . q[b]) + bias[r]
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_gmin_scan
// (body _gmin_body). It is a GEMM with a group-min epilogue: the [B, N] rank
// matrix never reaches device memory, only the [B, N/64] group minima.
//
// Bound: operations. At the main-path shape (N = 1,000,448, d = 768,
// B = 512) it does 2*N*d*B = 0.79 TFLOP against 3 GB (f32) of x, about 250
// FLOP per byte, so the arithmetic rate decides.
//
// Design: one block per (64-row group, 128-query tile), so one block owns a
// whole group and no reduction crosses blocks. x and q tiles are staged
// through shared memory in d-chunks of 32; each of the 256 threads keeps a
// 4-row x 8-query register tile of f32 FMA accumulators. The f32 path uses
// plain FMAs (no TF32: the counterpart of Precision.HIGHEST); the bf16 path
// widens each element with __bfloat162float and accumulates in f32, so every
// product of two bf16 values is exact. The epilogue applies the rank formula
// and the bias, takes each thread's min over its 4 rows, then the min over
// the 16 row lanes through shared memory. Like _gmin_body it runs no
// finiteness pass: the caller proves per batch (Cauchy-Schwarz bound) that
// no rank can overflow.
//
// Left for later: tensor cores. The f32 path could run 3xTF32 split
// products on wgmma, and the bf16 path plain bf16 wgmma fed by TMA from a
// multi-stage shared-memory ring, with a persistent grid; this kernel uses
// CUDA-core FMAs only.
// ---------------------------------------------------------------------------

constexpr int K1_QT = 128;      // queries per block
constexpr int K1_DC = 32;       // d-chunk staged through shared memory
constexpr int K1_THREADS = 256; // 16 row lanes x 16 query lanes
constexpr int K1_RPT = GROUP / 16;  // rows per thread (4)
constexpr int K1_QPT = K1_QT / 16;  // queries per thread (8)

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
gmin_scan_kernel(const T* __restrict__ x, const float* __restrict__ xsq,
                 const float* __restrict__ bias, const float* __restrict__ q,
                 const float* __restrict__ qsq, float* __restrict__ gmin,
                 int ng, int d, int b, int l2) {
  // +1 pads keep the transposed stores free of bank conflicts
  __shared__ float xs[K1_DC][GROUP + 1];
  __shared__ float qs[K1_DC][K1_QT + 1];
  __shared__ float red[16][K1_QT];

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * K1_QT;
  const int t = threadIdx.x;
  const int tx = t % 16;  // query lane: queries tx + 16*j
  const int ty = t / 16;  // row lane: rows ty + 16*i
  const int64_t row0 = (int64_t)g * GROUP;

  float acc[K1_RPT][K1_QPT];
#pragma unroll
  for (int i = 0; i < K1_RPT; ++i)
#pragma unroll
    for (int j = 0; j < K1_QPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += K1_DC) {
    // a warp reads 32 consecutive elements of one row: coalesced
#pragma unroll
    for (int e = 0; e < GROUP * K1_DC / K1_THREADS; ++e) {
      const int idx = t + e * K1_THREADS;
      const int r = idx / K1_DC, c = idx % K1_DC, k = k0 + c;
      xs[c][r] = k < d ? load_x(x + (row0 + r) * d + k) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < K1_QT * K1_DC / K1_THREADS; ++e) {
      const int idx = t + e * K1_THREADS;
      const int r = idx / K1_DC, c = idx % K1_DC, k = k0 + c, qb = q0 + r;
      qs[c][r] = (k < d && qb < b) ? __ldg(q + (int64_t)qb * d + k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < K1_DC; ++c) {
      float a[K1_RPT], w[K1_QPT];
#pragma unroll
      for (int i = 0; i < K1_RPT; ++i) a[i] = xs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < K1_QPT; ++j) w[j] = qs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < K1_RPT; ++i)
#pragma unroll
        for (int j = 0; j < K1_QPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part[K1_QPT];
#pragma unroll
  for (int j = 0; j < K1_QPT; ++j) part[j] = INFINITY;
#pragma unroll
  for (int i = 0; i < K1_RPT; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    const float xr = xsq[r], br = bias[r];
#pragma unroll
    for (int j = 0; j < K1_QPT; ++j) {
      const int qb = q0 + tx + 16 * j;
      const float qv = qb < b ? qsq[qb] : 0.f;
      const float rank = (l2 ? xr - 2.f * acc[i][j] + qv : -acc[i][j]) + br;
      part[j] = fminf(part[j], rank);
    }
  }
#pragma unroll
  for (int j = 0; j < K1_QPT; ++j) red[ty][tx + 16 * j] = part[j];
  __syncthreads();
  if (t < K1_QT && q0 + t < b) {
    float m = red[0][t];
#pragma unroll
    for (int r = 1; r < 16; ++r) m = fminf(m, red[r][t]);
    gmin[(int64_t)(q0 + t) * ng + g] = m;
  }
}

// ---------------------------------------------------------------------------
// K2 rescore: out[b, s, r] = rank(x[gidx[b, s]*64 + r] . q[b]) + bias,
// non-finite values mapped to +inf.
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_rescore (body
// _rescore_body). A block reads its own group index from gidx; there is no
// scalar prefetch on a GPU.
//
// Bound: bytes. Each (query, group) pair streams 64 rows of x (192 KB at
// d = 768 f32) for 2 FLOP per element; at B = 512 and gsel = 24 that is
// 2.4 GB of row reads, part of it served from L2 when queries share groups.
//
// Design: one block per (selected group, query), 8 warps of 8 rows each. The
// 32 lanes of a warp stride over d, so every row read is coalesced; the dot
// accumulates in f32 against the f32 query (also under bf16 storage, as in
// _rescore_body) and finishes with a warp shuffle reduction.
//
// Left for later: one block per group serving every query that selected it
// (x read once per group instead of once per pair), and 16-byte vector loads.
// ---------------------------------------------------------------------------

constexpr int K2_THREADS = 256;
constexpr int K2_ROWS_PER_WARP = GROUP / (K2_THREADS / 32);

template <typename T>
__global__ void __launch_bounds__(K2_THREADS)
rescore_kernel(const T* __restrict__ x, const float* __restrict__ xsq,
               const float* __restrict__ bias, const float* __restrict__ q,
               const float* __restrict__ qsq, const int* __restrict__ gidx,
               float* __restrict__ out, int ng, int d, int gsel, int l2) {
  const int s = blockIdx.x;
  const int bq = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int gi = gidx[(int64_t)bq * gsel + s];
  gi = gi < 0 ? 0 : (gi >= ng ? ng - 1 : gi);  // never read out of bounds
  const int64_t row0 = (int64_t)gi * GROUP;
  const float* qv = q + (int64_t)bq * d;
  for (int rr = 0; rr < K2_ROWS_PER_WARP; ++rr) {
    const int r = warp * K2_ROWS_PER_WARP + rr;
    const T* xr = x + (row0 + r) * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) acc = fmaf(load_x(xr + k), __ldg(qv + k), acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float rank = l2 ? xsq[row0 + r] - 2.f * acc + qsq[bq] : -acc;
      rank += bias[row0 + r];
      out[((int64_t)bq * gsel + s) * GROUP + r] = isfinite(rank) ? rank : INFINITY;
    }
  }
}

}  // namespace

extern "C" {

// x: [n, d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); xsq, bias: [n] f32;
// q: [b, d] f32 (already rounded to bf16 values by the caller when x is
// bf16); qsq: [b] f32; gmin: [b, n/64] f32 output. n % 64 == 0.
int vt_gmin_scan(const void* x, int x_bf16, const float* xsq, const float* bias,
                 const float* q, const float* qsq, float* gmin, int n, int d,
                 int b, int l2, void* stream) {
  if (n <= 0 || n % GROUP || d <= 0 || b <= 0 || (b + K1_QT - 1) / K1_QT > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / GROUP, (b + K1_QT - 1) / K1_QT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    gmin_scan_kernel<__nv_bfloat16><<<grid, K1_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xsq, bias, q, qsq, gmin, n / GROUP, d, b, l2);
  else
    gmin_scan_kernel<float><<<grid, K1_THREADS, 0, st>>>(
        static_cast<const float*>(x), xsq, bias, q, qsq, gmin, n / GROUP, d, b, l2);
  return (int)cudaGetLastError();
}

// gidx: [b, gsel] int32 group indices; q: [b, d] f32 (never rounded);
// out: [b, gsel, 64] f32 output.
int vt_rescore(const void* x, int x_bf16, const float* xsq, const float* bias,
               const float* q, const float* qsq, const int* gidx, float* out,
               int n, int d, int b, int gsel, int l2, void* stream) {
  if (n <= 0 || n % GROUP || d <= 0 || b <= 0 || b > 65535 || gsel <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gsel, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    rescore_kernel<__nv_bfloat16><<<grid, K2_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xsq, bias, q, qsq, gidx, out, n / GROUP, d,
        gsel, l2);
  else
    rescore_kernel<float><<<grid, K2_THREADS, 0, st>>>(
        static_cast<const float*>(x), xsq, bias, q, qsq, gidx, out, n / GROUP, d, gsel, l2);
  return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
