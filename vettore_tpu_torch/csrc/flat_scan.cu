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

#include "group_rescore.cuh"
#include "wgmma_scan.cuh"

namespace {

constexpr int GROUP = 64;  // rows per selection group

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
// non-finite values mapped to +inf, for f32 and bf16 rows.
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_rescore (body
// _rescore_body). The dot sums in f32 against the f32 query, also under bf16
// storage, as _rescore_body does.
//
// Bound: bytes: the rows of every distinct selected group and the side
// values the metric reads (the bias; the row norm for l2), read once
// (0.502 ms for f32 rows under cosine at B = 512, gsel 24, d = 768 on the
// main path's selection), against 1.2 GFLOP of products.
//
// Design: the group-major rescore of csrc/group_rescore.cuh (for f32 rows
// a stable sort of the pairs by group on the card; windows of listed pairs
// times slices of the group's rows, each run of equal groups staged into
// shared memory once by 1-D bulk copies and served to every pair of the run
// with 16-byte loads). K2 is its f32 and bf16 instances with a fused
// multiply-add.
// ---------------------------------------------------------------------------

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

// groups: [p] int32 group indices of the pairs in the order the kernel
// walks them (ordered by group); pairs: [p] int64 pair index (b * gsel + s)
// of each, or null for the identity; q: [b, d] f32 (never rounded); out:
// [b, gsel, 64] f32 output. w, rows, rs, cols: the work geometry
// (ops/flat_scan.py::_rescore_plan); direct: the bulk-copy route.
int vt_rescore(const void* x, int x_bf16, const float* xsq, const float* bias,
               const float* q, const float* qsq, const int* groups, const int64_t* pairs,
               float* out, int n, int d, int p, int gsel, int w, int rows, int rs, int cols,
               int direct, int l2, void* stream) {
  const gr::Geometry geo{p, gsel, n / GROUP, d, w, rows, rs, cols, l2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)gr::launch<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(x), nullptr,
                                                 xsq, bias, q, qsq, groups, pairs, out, n, geo,
                                                 direct, st);
  return (int)gr::launch<float, false>(static_cast<const float*>(x), nullptr, xsq, bias, q, qsq,
                                       groups, pairs, out, n, geo, direct, st);
}

const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
