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
// with tinv = 1 / sqrt(|x[n, t]|^2) (0 for a zero row). Pad query tokens are
// zero rows with qinv 0: each adds exactly 0 to a doc's total.
//
// Replaces BOTH Pallas kernels of vettore_tpu/ops/maxsim.py:
// fused_maxsim_rank_scan (body _mv_scan_body, per-token mask and norm
// operands) and fused_maxsim_rank_scan_uniform (body _mv_scan_body_u, every
// doc has T tokens, norms in the kernel). They are two kernels only because
// [NT, 1] operands pad 128x in TPU HBM. Here one kernel computes the token
// norms itself and always reads the [N] counts (0.4 MB beside the 0.82 GB
// block at config 5), so a block whose docs all hold T tokens is simply the
// case count == T. The masked kernel's 1/max(sqrt(tsq), 1e-38) and the
// uniform kernel's 1/sqrt(xsq) are the same number in f32 (the square root
// of the least positive f32 is ~3.7e-23).
//
// Bound: bytes, on tensor cores. At BASELINE config 5 (N = 100,352 docs,
// T = 32, d = 128, bf16 block, B = 64 sets of Q = 4 tokens) it reads 0.82 GB
// of tokens and writes 25.7 MB of ranks for 2*N*T*d*B*Q = 210 GFLOP: 0.25 ms
// at 3.35 TB/s against 0.21 ms at the bf16 tensor-core peak. With an f32
// block and CUDA-core f32 arithmetic the bound is 210 GFLOP / 67 TFLOP/s.
//
// Design: a register-tiled GEMM (K1's: 256 threads, each a 4-row x 8-column
// tile of f32 FMA accumulators, x and query chunks of 32 columns staged
// through shared memory) over chunks of 64 token rows x 128 query-token
// columns. One block owns DT = max(1, 64 / T) whole docs and QB = max(1,
// 128 / Q) whole query sets, so the max over a doc's tokens and the sum over
// a set's tokens both finish inside the block. Each chunk's similarities go
// through a shared-memory tile into a running [DT, QB*Q] max in shared
// memory, folded by one thread per (doc, column); pad tokens (t >= count)
// are skipped there. The token norms accumulate from the staged x values in
// the same loop. bf16 blocks widen exactly and meet queries rounded to bf16
// by the wrapper, so every product is exact and sums run in f32 (the JAX
// kernel's default-precision bf16 dot).
//
// Left for later: bf16 wgmma (and 3xTF32 for f32 blocks) fed by TMA; this
// kernel runs CUDA-core FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // 16 row lanes x 16 column lanes
constexpr int ROWS = 64;          // token rows per chunk
constexpr int COLS = 128;         // query-token columns per chunk
constexpr int DC = 32;            // d-chunk staged through shared memory
constexpr int RPT = ROWS / 16;    // rows per thread (4)
constexpr int CPT = COLS / 16;    // columns per thread (8)
constexpr int RUN_CELLS = 8192;   // running-max cells per block
constexpr int TILE = ROWS * (COLS + 1);
constexpr int SMEM_FLOATS = TILE + ROWS + RUN_CELLS + ROWS;  // + counts (as int)

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxsim_rank_scan_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                        const float* __restrict__ dbias, const float* __restrict__ q,
                        const float* __restrict__ qinv, float* __restrict__ out, int n,
                        int tk, int d, int b, int nq, int cosine, int dt, int qb) {
  extern __shared__ float smem[];
  // main loop: xs [DC][ROWS+1] then qs [DC][COLS+1]; epilogue: the
  // similarity tile [ROWS][COLS+1] over the same bytes (+1 pads keep the
  // transposed accesses free of bank conflicts)
  float(*xs)[ROWS + 1] = reinterpret_cast<float(*)[ROWS + 1]>(smem);
  float(*qs)[COLS + 1] = reinterpret_cast<float(*)[COLS + 1]>(smem + DC * (ROWS + 1));
  float(*tile)[COLS + 1] = reinterpret_cast<float(*)[COLS + 1]>(smem);
  float* rinv = smem + TILE;                 // [ROWS] inverse token norms
  float* run = rinv + ROWS;                  // [dt][qb * nq] running maxima
  int* cnt = reinterpret_cast<int*>(run + RUN_CELLS);  // [dt] live tokens

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int warp = t / 32, lane = t % 32;
  const int doc0 = blockIdx.x * dt;
  const int set0 = blockIdx.y * qb;
  const int ndocs = min(dt, n - doc0);
  const int nsets = min(qb, b - set0);
  const int stride = qb * nq;               // run row stride
  const int cols = nsets * nq;              // live query-token columns
  const int rows = ndocs * tk;              // live token rows of the block
  const int64_t xrow0 = (int64_t)doc0 * tk;
  const int64_t col0 = (int64_t)set0 * nq;

  for (int i = t; i < dt * stride; i += THREADS) run[i] = -INFINITY;
  if (t < dt) {
    int c = 0;
    if (t < ndocs) {
      c = counts[doc0 + t];
      c = c < 0 ? 0 : (c > tk ? tk : c);
    }
    cnt[t] = c;
  }
  __syncthreads();

  for (int c0 = 0; c0 < cols; c0 += COLS) {
    for (int r0 = 0; r0 < rows; r0 += ROWS) {
      float acc[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
      float sq[ROWS * DC / THREADS];  // this lane's squares of rows warp + 8e
#pragma unroll
      for (int e = 0; e < ROWS * DC / THREADS; ++e) sq[e] = 0.f;

      for (int k0 = 0; k0 < d; k0 += DC) {
        const int k = k0 + lane;
#pragma unroll
        for (int e = 0; e < ROWS * DC / THREADS; ++e) {
          const int r = warp + 8 * e;
          const float v = (r0 + r < rows && k < d) ? load_x(x + (xrow0 + r0 + r) * d + k) : 0.f;
          xs[lane][r] = v;
          sq[e] = fmaf(v, v, sq[e]);
        }
#pragma unroll
        for (int e = 0; e < COLS * DC / THREADS; ++e) {
          const int cl = warp + 8 * e;
          qs[lane][cl] = (c0 + cl < cols && k < d) ? __ldg(q + (col0 + c0 + cl) * d + k) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          float a[RPT], w[CPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) a[i] = xs[c][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < CPT; ++j) w[j] = qs[c][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
      }

      // the loop ended on a barrier: the staging buffers are dead
      if (cosine) {
#pragma unroll
        for (int e = 0; e < ROWS * DC / THREADS; ++e) {
          float s = sq[e];
#pragma unroll
          for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) rinv[warp + 8 * e] = s > 0.f ? 1.f / sqrtf(s) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int cl = tx + 16 * j;
          float s = acc[i][j];
          if (cosine) {
            const float qi = c0 + cl < cols ? qinv[col0 + c0 + cl] : 0.f;
            s = fminf(fmaxf(__fmul_rn(__fmul_rn(s, rinv[r]), qi), -1.f), 1.f);
          }
          tile[r][cl] = s;
        }
      }
      __syncthreads();

      // one thread per (doc, column) of this chunk folds the doc's live
      // token rows into its running max
      const int dfirst = r0 / tk;
      const int dlast = min(ndocs - 1, (r0 + ROWS - 1) / tk);
      const int pairs = (dlast - dfirst + 1) * COLS;
      for (int p = t; p < pairs; p += THREADS) {
        const int cl = p % COLS, dl = dfirst + p / COLS;
        if (c0 + cl >= cols) continue;
        const int rs = max(dl * tk, r0), re = min(dl * tk + cnt[dl], r0 + ROWS);
        float m = run[dl * stride + c0 + cl];
        for (int r = rs; r < re; ++r) m = fmaxf(m, tile[r - r0][cl]);
        run[dl * stride + c0 + cl] = m;
      }
      __syncthreads();
    }
  }

  for (int p = t; p < ndocs * nsets; p += THREADS) {
    const int dl = p % ndocs, si = p / ndocs;
    float total = 0.f;
    for (int j = 0; j < nq; ++j) total += run[dl * stride + si * nq + j];
    const float rank = cnt[dl] == 0 ? 0.f : -total;
    out[(int64_t)(set0 + si) * n + doc0 + dl] = rank + dbias[doc0 + dl];
  }
}

template <typename T>
int launch(const T* x, const int* counts, const float* dbias, const float* q,
           const float* qinv, float* out, int n, int tk, int d, int b, int nq, int cosine,
           cudaStream_t st) {
  int qb = nq >= COLS ? 1 : COLS / nq;
  int dt = tk >= ROWS ? 1 : ROWS / tk;
  if (dt * qb * nq > RUN_CELLS) dt = RUN_CELLS / (qb * nq);
  const dim3 grid((n + dt - 1) / dt, (b + qb - 1) / qb);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int bytes = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(maxsim_rank_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  maxsim_rank_scan_kernel<T><<<grid, THREADS, bytes, st>>>(x, counts, dbias, q, qinv, out, n,
                                                          tk, d, b, nq, cosine, dt, qb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [n, t, d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); counts: [n] int32 live
// tokens per doc; dbias: [n] f32 (0 live, +inf dead); q: [b * nq, d] f32
// query tokens, set-major (rounded to bf16 values by the caller when x is
// bf16); qinv: [b * nq] f32 inverse query-token norms (read only for
// cosine); out: [b, n] f32 ranks. nq <= 8192.
int vt_maxsim_rank_scan(const void* x, int x_bf16, const int* counts, const float* dbias,
                        const float* q, const float* qinv, float* out, int n, int t, int d,
                        int b, int nq, int cosine, void* stream) {
  if (!counts || n <= 0 || t <= 0 || d <= 0 || b <= 0 || nq <= 0 || nq > RUN_CELLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), counts, dbias, q, qinv, out, n, t, d,
                  b, nq, cosine, st);
  return launch(static_cast<const float*>(x), counts, dbias, q, qinv, out, n, t, d, b, nq,
                cosine, st);
}

}  // extern "C"
