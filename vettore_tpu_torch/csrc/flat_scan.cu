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

#include "wgmma_scan.cuh"

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
// B = 512) it does 2*N*d*B = 787 G operations. On bf16 blocks the bf16
// tensor cores (989 TFLOP/s) put the bound at 0.80 ms (the 1.54 GB block
// alone would take 0.46 ms). On f32 blocks the products
// must keep f32's accuracy (the counterpart of Precision.HIGHEST), which the
// tensor cores give as three TF32 products: 3 x 787 G at 495 TFLOP/s,
// 4.77 ms (the 3.07 GB block alone 0.92 ms).
//
// Design: the shared tensor-core scan skeleton (csrc/wgmma_scan.cuh: a
// persistent grid, a TMA ring, tiles of 128 rows x up to 256 queries), with
// its Bf16 policy for bf16 blocks (x as stored against the query rounded to
// bf16, exact products in f32) and its Tf32x3 policy for f32 blocks (the
// wrapper splits the query into q_hi + q_lo once per batch; the consumers
// split their rows in registers). The epilogue is K3's without the scales:
// each thread turns its 2 rows x QN/4 accumulators into ranks in place
// (the rows' norms and biases and the tile's query norms loaded before the
// mainloop), and the group-min is taken in the thread, across lanes by
// shuffles and across the 4 warps through shared memory
// (wg::column_min), so it never leaves the warpgroup. Like _gmin_body it
// runs no finiteness pass: the wrapper proves per batch (Cauchy-Schwarz
// bound) that no rank can overflow.
// ---------------------------------------------------------------------------

struct FlatEpilogue {
  const float* xsq;
  const float* bias;
  const float* qsq;
  float* gmin;
  int ng, b, l2;

  // loaded before the mainloop, used after it: the norm and bias of the
  // thread's two rows, and the tile's query norms at columns t and t + 128
  // (staged in shared memory by finish)
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

  template <int QN>
  __device__ void finish(float (&acc)[QN / 2], const wg::Frame& f, const Pre& p) const {
    // the previous tile's readers of side and red passed column_min's barriers
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (f.t + 128 * h < QN) f.side[f.t + 128 * h] = p.qv[h];
    wg::named_sync(f.bar, 128);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = wg::acc_col(f.t, j, c);
          float& v = acc[4 * j + 2 * h + c];
          const float rank =
              l2 ? __fadd_rn(__fsub_rn(p.xr[h], __fmul_rn(2.f, v)), f.side[col]) : -v;
          v = __fadd_rn(rank, p.br[h]);
        }
    float* red = static_cast<float*>(f.red);
    wg::column_min<QN, float>(acc, red, f.t, f.bar);
    for (int col = f.t; col < QN; col += 128)
      if (f.q0 + col < b) gmin[(int64_t)(f.q0 + col) * ng + f.g] = red[col];
  }
};

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

// x: [n, d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1) with row stride ldx
// bytes; xsq, bias: [n] f32; q: [b, d] with row stride ldq bytes, the
// query rounded to bf16 for bf16 blocks, its TF32 part q_hi for f32 blocks,
// whose remainder q - q_hi is q_lo (f32, stride ldq; unused for bf16);
// qsq: [b] f32 of the f32 query; gmin: [b, n/64] f32 output. n % 64 == 0;
// x, q and q_lo 16-byte aligned, ldx and ldq multiples of 16 (TMA's rule;
// the wrapper pads other operands).
int vt_gmin_scan(const void* x, int ldx, int x_bf16, const float* xsq, const float* bias,
                 const void* q, const void* q_lo, int ldq, const float* qsq, float* gmin, int n,
                 int d, int b, int l2, void* stream) {
  const FlatEpilogue epi{xsq, bias, qsq, gmin, n / GROUP, b, l2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return (int)wg::scan<wg::Bf16>(x, ldx, q, nullptr, ldq, n, d, b, epi, st);
  return (int)wg::scan<wg::Tf32x3>(x, ldx, q, q_lo, ldq, n, d, b, epi, st);
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
