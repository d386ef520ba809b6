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

#include "group_rescore.cuh"
#include "wgmma_scan.cuh"

namespace {

constexpr int GROUP = 64;      // rows per selection group

// ---------------------------------------------------------------------------
// K3 int8_gmin_scan: for int8 rows x8[r] (dequant scale[r]) and int8
// queries q8[b] (dequant qscale[b]),
//   approx     = (float(x8[r] . q8[b]) * scale[r]) * qscale[b]
//   rank[b, r] = -approx                           (dot metrics)
//              = (xsq[r] - 2 * approx) + qsq[b]    (l2 metrics)
//   gmin[b, g] = min over the 64 rows r of group g of rank[b, r] + bias[r]
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_int8_gmin_scan
// (body _int8_gmin_body).
//
// Bound: operations. At the main-path shape (N = 1,000,448, d = 768,
// B = 512) it does 2*N*d*B = 787 G int8 operations on 0.77 GB of rows; the
// H100's int8 tensor-core peak (1,979 TOP/s) puts the bound at 0.398 ms, the
// bytes at 0.23 ms.
//
// Design: the int8 tensor cores. The dots run on the shared tensor-core
// scan skeleton with its s8 policy (csrc/wgmma_scan.cuh: a persistent
// grid, a TMA ring, tiles of 128 rows x up to 256 queries). The dot is an
// exact int32, so the result is bit-equal to the plain version only if the
// epilogue rounds in the same order: it is written with __fmul_rn /
// __fsub_rn / __fadd_rn, which nvcc never contracts into an FMA, straight
// from the accumulator registers.
// Each thread turns its 2 rows x QN/4 columns into ranks in place (the
// tile's query scales and norms staged in shared memory first); the
// group-min is taken in the thread, across the lanes by shuffles and across
// the 4 warps through shared memory (wg::column_min). No finiteness pass:
// the wrapper proves per batch that no rank can overflow (_int8_bounded).
// ---------------------------------------------------------------------------

struct Int8Epilogue {
  const float* scale;
  const float* xsq;
  const float* bias;
  const float* qscale;
  const float* qsq;
  float* gmin;
  int ng, b, l2;

  // loaded before the mainloop, used after it: the scale, norm and bias of
  // the thread's two rows, and the tile's query scales and norms at
  // columns t and t + 128 (staged in shared memory by finish)
  struct Pre {
    float sr[2], xr[2], br[2], qs[2], qv[2];
  };

  template <int QN>
  __device__ Pre prefetch(const wg::Frame& f) const {
    Pre p;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = (int64_t)f.g * GROUP + wg::acc_row(f.t, h);
      p.sr[h] = scale[r];
      p.xr[h] = xsq[r];
      p.br[h] = bias[r];
      const int qb = f.q0 + f.t + 128 * h;
      p.qs[h] = qb < b ? qscale[qb] : 0.f;
      p.qv[h] = qb < b ? qsq[qb] : 0.f;
    }
    return p;
  }

  template <int QN>
  __device__ void finish(int (&acc)[QN / 2], const wg::Frame& f, const Pre& p) const {
    const float* sr = p.sr;
    const float* xr = p.xr;
    const float* br = p.br;
    // the previous tile's readers of side and red passed column_min's barriers
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (f.t + 128 * h < QN) {
        f.side[f.t + 128 * h] = p.qs[h];
        f.side[QN + f.t + 128 * h] = p.qv[h];
      }
    wg::named_sync(f.bar, 128);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = wg::acc_col(f.t, j, c);
          int& v = acc[4 * j + 2 * h + c];
          const float approx = __fmul_rn(__fmul_rn(__int2float_rn(v), sr[h]), f.side[col]);
          const float rank =
              l2 ? __fadd_rn(__fsub_rn(xr[h], __fmul_rn(2.f, approx)), f.side[QN + col]) : -approx;
          v = __float_as_int(__fadd_rn(rank, br[h]));
        }
    float* red = static_cast<float*>(f.red);
    wg::column_min<QN, float>(acc, red, f.t, f.bar);
    for (int col = f.t; col < QN; col += 128)
      if (f.q0 + col < b) gmin[(int64_t)(f.q0 + col) * ng + f.g] = red[col];
  }
};

// ---------------------------------------------------------------------------
// K4 int8_rescore: out[b, s, r] = rank(dot * scale) + bias for the 64 rows
// of group gidx[b, s], with dot = sum_k float(x8[row, k]) * q[b, k] against
// the FULL f32 query; non-finite values become +inf.
//
// Replaces the Pallas kernel vettore_tpu/ops/flat_scan.py::_int8_rescore
// (body _int8_rescore_body). Like the JAX body it sums the products first
// and multiplies by the row scale after; each product is rounded before the
// add (__fmul_rn, __fadd_rn, never contracted), as the body's elementwise
// product then sum.
//
// Bound: bytes: the int8 rows of every distinct selected group with the
// f32 side values the metric reads (the scale and the bias; the row norm
// for l2), read once (about 0.13 ms under cosine at B = 512, gsel 24,
// d = 768 on the main path's selection).
//
// Design: the group-major rescore of csrc/group_rescore.cuh, its int8
// instance, on the pairs in their own order (sorting them by group saves
// int8 rows nothing: the kernel is bound by its per (pair, row) work): each
// run of equal groups staged into shared memory once by 1-D bulk copies,
// every pair of the run served from there, 16 int8 values a lane per
// 16-byte load.
// ---------------------------------------------------------------------------

}  // namespace

extern "C" {

// x8: [n, d] int8 with row stride ldx bytes; scale, xsq, bias: [n] f32;
// q8: [b, d] int8 with row stride ldq bytes; qscale, qsq: [b] f32; gmin:
// [b, n/64] f32 output. n % 64 == 0; x8 and q8 16-byte aligned, ldx and ldq
// multiples of 16 (TMA's rule; the wrapper pads other operands).
int vt_int8_gmin_scan(const int8_t* x8, int ldx, const float* scale, const float* xsq,
                      const float* bias, const int8_t* q8, int ldq, const float* qscale,
                      const float* qsq, float* gmin, int n, int d, int b, int l2, void* stream) {
  const Int8Epilogue epi{scale, xsq, bias, qscale, qsq, gmin, n / GROUP, b, l2};
  return (int)wg::scan<wg::S8>(x8, ldx, q8, nullptr, ldq, n, d, b, epi,
                               static_cast<cudaStream_t>(stream));
}

// q: [b, d] f32 (unquantized); qsq: [b] f32; groups, pairs and the
// geometry as vt_rescore (csrc/flat_scan.cu); out: [b, gsel, 64] f32
// output.
int vt_int8_rescore(const int8_t* x8, const float* scale, const float* xsq,
                    const float* bias, const float* q, const float* qsq, const int* groups,
                    const int64_t* pairs, float* out, int n, int d, int p, int gsel, int w,
                    int rows, int rs, int cols, int direct, int l2, void* stream) {
  const gr::Geometry geo{p, gsel, n / GROUP, d, w, rows, rs, cols, l2};
  return (int)gr::launch<int8_t, true>(x8, scale, xsq, bias, q, qsq, groups, pairs, out, n, geo,
                                       direct, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
