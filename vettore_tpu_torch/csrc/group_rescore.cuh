// The group-major rescore shared by K2 rescore (csrc/flat_scan.cu: f32 and
// bf16 rows) and K4 int8_rescore (csrc/int8_scan.cu: int8 rows, the row
// scale applied after the sum).
//
// Function: for every pair p = (b, s) of a [B, gsel] selection of 64-row
// groups, out[p, r] = rank(x[64 * gidx[b, s] + r] . q[b]) + bias for the 64
// rows r of the group, non-finite values mapped to +inf. The dot runs on
// the CUDA cores in f32 against the f32 query (also for bf16 and int8
// rows).
//
// Bound: bytes. Every distinct selected group's rows must be read once; the
// products are 2 FLOP per row element (1.2 GFLOP at B = 512, gsel 24,
// d = 768: 0.018 ms at the f32 CUDA-core peak).
//
// Design: group-major. The wrapper (ops/flat_scan.py::_rescore_plan) lists
// the B * gsel pairs, for f32 rows of a large batch ordered by group (a
// stable sort on the card; no host synchronisation; `pairs` gives each
// slot's own pair), else in their own order (`pairs` null), and picks the
// work geometry from the pair count and the SM count. A block takes a work
// item: a window of `w` consecutive listed pairs times a slice of `rows`
// of the 64 rows. It finds the runs of equal
// groups in its window, and walks them in steps: a step stages `rs` rows by
// `cols` columns of the run's group (column chunks only when one row
// exceeds a stage) into a ring of up to MAX_STAGES shared-memory stages.
// One producer warp stages each step once its slot is free (full and
// empty mbarriers), so the next steps' bytes arrive while this one is
// used. Every pair of the run is served from the stage by the 8 consumer
// warps: a task is (pair, RT rows), one query read from L2 for its RT
// rows; each lane strides over the columns with 16-byte loads, a
// butterfly of shuffles gives every lane the RT dots, and lanes 0..RT-1
// each finish one row (rank, bias, +inf for a non-finite value; the side
// values loaded beside the query) into the pair's own slot. Warps take the
// tasks in turn across steps, not per step, so a step with fewer tasks
// than warps leaves none idle and no step waits for a block-wide barrier.
// A group shared by more pairs than a window holds is staged once per
// window (the rest from L2).
//
// Routes: "direct" stages with one thread's 1-D bulk copies
// (cp.async.bulk, completing on an mbarrier) and reads 16 bytes a lane from
// shared memory and from the query; it needs x and q 16-byte aligned and a
// row of x (and each column chunk) a multiple of 16 bytes. "narrow" (any
// other d or base) is the same kernel with the producer warp copying
// element by element and the consumers reading one element a lane.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_scan.cuh"

namespace {
namespace gr {

constexpr int GROUP = 64;
constexpr int CONSUMERS = 8;                   // warps that compute
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int RT = 4;               // rows of one task: one query read serves them
constexpr int MAX_WINDOW = VT_RESCORE_MAX_WINDOW;  // pairs per work item (_build.py's LIMITS)
constexpr int MAX_STAGES = 3;
constexpr int STAGE_BYTES = VT_RESCORE_STAGE_BYTES;  // one ring stage (_build.py's LIMITS)

// The work geometry chosen by the wrapper.
struct Geometry {
  int p;     // pairs (B * gsel)
  int gsel;  // pairs per query
  int ng;    // groups in the block
  int d;
  int w;     // pairs per window
  int rows;  // rows per slice (64 / slices)
  int rs;    // rows per stage
  int cols;  // columns per stage (d unless one row exceeds a stage)
  int l2;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// one product added: K2 fuses it, K4 rounds the product before the add as
// _int8_rescore_body's elementwise product then sum does (__fmul_rn and
// __fadd_rn are never contracted)
template <bool SCALED>
__device__ __forceinline__ float madd(float acc, float x, float q) {
  if constexpr (SCALED) return __fadd_rn(acc, __fmul_rn(x, q));
  return fmaf(x, q, acc);
}

// a 16-byte vector of T as elem reads it: int8 bytes offset by 128 (b ^ 0x80
// = b + 128 as an unsigned byte), other types as they are
template <typename T>
__device__ __forceinline__ uint4 prep(uint4 v) {
  if constexpr (sizeof(T) == 1) {
    v.x ^= 0x80808080u;
    v.y ^= 0x80808080u;
    v.z ^= 0x80808080u;
    v.w ^= 0x80808080u;
  }
  return v;
}

// element i of a prepared 16-byte vector of T, exactly, as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int i) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else if constexpr (sizeof(T) == 2) {  // bf16: the upper 16 bits of an f32
    const uint32_t u = w[i / 2];
    return __uint_as_float(i % 2 ? (u & 0xffff0000u) : (u << 16));
  } else {
    // int8: the offset byte as the low mantissa of 2^23 (one byte permute),
    // less 2^23 + 128: exact, and at the adder's rate where a conversion
    // instruction runs at a quarter of it
    const uint32_t u = __byte_perm(w[i / 4], 0x4B000000u, 0x7540u | (i % 4));
    return __fsub_rn(__uint_as_float(u), 8388736.f);
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(wg::smem_addr(dst)), "l"(src), "r"(bytes), "r"(wg::smem_addr(bar))
      : "memory");
}

// one step of a block's walk: run k of its window, rows [row, row + rs) of
// that run's group, columns [c0, c0 + cw)
struct Step {
  int k, sub, ch, c0, cw;
  int64_t row;
};

template <typename T, bool SCALED, bool BULK>
__global__ void __launch_bounds__(THREADS)
group_rescore(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ xsq, const float* __restrict__ bias,
              const float* __restrict__ q, const float* __restrict__ qsq,
              const int* __restrict__ groups, const int64_t* __restrict__ pairs,
              float* __restrict__ out, const Geometry geo, const int nst) {
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ int win_group[MAX_WINDOW];
  __shared__ int win_pair[MAX_WINDOW];
  __shared__ int run_start[MAX_WINDOW + 1];
  __shared__ int nruns;
  __shared__ float part[MAX_WINDOW];  // sums over column chunks (rs == 1 then)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.x * geo.w;
  const int len = min(geo.w, geo.p - i0);
  const int slice0 = blockIdx.y * geo.rows;
  if (tid < len) {
    const int g = groups[i0 + tid];
    win_group[tid] = g < 0 ? 0 : (g >= geo.ng ? geo.ng - 1 : g);  // never read out of bounds
    win_pair[tid] = pairs ? static_cast<int>(pairs[i0 + tid]) : i0 + tid;
  }
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      wg::mbar_init(&full[s], BULK ? 1 : 32);  // the bulk copy's thread, or the whole warp
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    int nr = 0;
    for (int j = 0; j < len; ++j)
      if (j == 0 || win_group[j] != win_group[j - 1]) run_start[nr++] = j;
    run_start[nr] = len;
    nruns = nr;
  }
  __syncthreads();

  const int nsub = geo.rows / geo.rs;
  const int nch = (geo.d + geo.cols - 1) / geo.cols;
  const int nsteps = nruns * nsub * nch;
  const int stage_elems = geo.rs * geo.cols;
  const int tasks_per_pair = (geo.rs + RT - 1) / RT;
  auto step = [&](int t) {
    Step s;
    s.k = t / (nsub * nch);
    s.sub = (t / nch) % nsub;
    s.ch = t % nch;
    s.c0 = s.ch * geo.cols;
    s.cw = min(geo.cols, geo.d - s.c0);
    s.row = static_cast<int64_t>(win_group[run_start[s.k]]) * GROUP + slice0 + s.sub * geo.rs;
    return s;
  };

  if (warp == CONSUMERS) {  // the producer: stage step t once its slot is free
    for (int t = 0; t < nsteps; ++t) {
      const int st = t % nst;
      if (t >= nst) wg::mbar_wait(&empty[st], (t / nst - 1) & 1);
      const Step s = step(t);
      T* dst = ring + static_cast<int64_t>(st) * stage_elems;
      const T* src = x + s.row * geo.d + s.c0;
      if constexpr (BULK) {
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          wg::mbar_expect_tx(&full[st], geo.rs * s.cw * static_cast<int>(sizeof(T)));
          if (nch == 1) {
            bulk_load(dst, src, geo.rs * geo.d * static_cast<int>(sizeof(T)), &full[st]);
          } else {
            for (int r = 0; r < geo.rs; ++r)
              bulk_load(dst + r * geo.cols, src + static_cast<int64_t>(r) * geo.d,
                        s.cw * static_cast<int>(sizeof(T)), &full[st]);
          }
        }
      } else {
        for (int e = lane; e < geo.rs * s.cw; e += 32) {
          const int r = e / s.cw, c = e % s.cw;
          dst[r * geo.cols + c] = src[static_cast<int64_t>(r) * geo.d + c];
        }
        wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // the consumers: the tasks of every step in turn, across steps, so that a
  // warp with nothing to do in one step takes the next step's task; with
  // column chunks a pair keeps its warp (it carries the pair's running sum)
  int done = 0;
  for (int t = 0; t < nsteps; ++t) {
    const int st = t % nst;
    const Step s = step(t);
    const int j0 = run_start[s.k];
    const int ntasks = (run_start[s.k + 1] - j0) * tasks_per_pair;
    const int first = (warp - (nch == 1 ? done % CONSUMERS : 0) + CONSUMERS) % CONSUMERS;
    done += ntasks;
    wg::mbar_wait(&full[st], (t / nst) & 1);
    const T* stage = ring + static_cast<int64_t>(st) * stage_elems;
    for (int u = first; u < ntasks; u += CONSUMERS) {
      const int j = j0 + u / tasks_per_pair;
      const int r0 = (u % tasks_per_pair) * RT;
      const int pair = win_pair[j];
      const int bq = pair / geo.gsel;
      const float* qv = q + static_cast<int64_t>(bq) * geo.d + s.c0;
      // lane rr < RT finishes row r0 + rr: its side values load with the query
      const int rr = lane;
      const bool fin = rr < RT && r0 + rr < geo.rs && s.ch == nch - 1;
      const int64_t xr = s.row + r0 + rr;
      float side_x = 0.f, side_b = 0.f, side_s = 1.f, side_q = 0.f;
      if (fin) {
        side_b = bias[xr];
        if (geo.l2) {
          side_x = xsq[xr];
          side_q = qsq[bq];
        }
        if constexpr (SCALED) side_s = scale[xr];
      }
      float acc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = 0.f;
      if constexpr (BULK) {
        constexpr int V = 16 / sizeof(T);
#pragma unroll 2
        for (int v = lane * V; v < s.cw; v += 32 * V) {
          float qf[V];
#pragma unroll
          for (int i = 0; i < V; i += 4) {
            const float4 q4 = __ldg(reinterpret_cast<const float4*>(qv + v + i));
            qf[i] = q4.x;
            qf[i + 1] = q4.y;
            qf[i + 2] = q4.z;
            qf[i + 3] = q4.w;
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r0 + r < geo.rs) {
              const uint4 xv =
                  prep<T>(*reinterpret_cast<const uint4*>(stage + (r0 + r) * geo.cols + v));
#pragma unroll
              for (int i = 0; i < V; ++i) acc[r] = madd<SCALED>(acc[r], elem<T>(xv, i), qf[i]);
            }
          }
        }
      } else {
        for (int c = lane; c < s.cw; c += 32) {
          const float qc = __ldg(qv + c);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r0 + r < geo.rs)
              acc[r] = madd<SCALED>(acc[r], to_f(stage[(r0 + r) * geo.cols + c]), qc);
        }
      }
      // butterfly sums: every lane ends with all RT dots
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int off = 16; off; off >>= 1)
          acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], off));
      float dot = acc[0];
#pragma unroll
      for (int r = 1; r < RT; ++r)
        if (lane == r) dot = acc[r];
      if (nch > 1) {  // rs == 1: lane 0 carries the pair's one row over the chunks
        if (lane == 0) {
          dot = s.ch ? __fadd_rn(part[j], dot) : dot;
          part[j] = dot;
        }
        if (s.ch + 1 < nch) continue;
      }
      if (!fin) continue;
      float rank;
      if constexpr (SCALED) {
        dot = __fmul_rn(dot, side_s);
        rank = geo.l2 ? __fadd_rn(__fsub_rn(side_x, __fmul_rn(2.f, dot)), side_q) : -dot;
        rank = __fadd_rn(rank, side_b);
      } else {
        rank = geo.l2 ? side_x - 2.f * dot + side_q : -dot;
        rank += side_b;
      }
      out[static_cast<int64_t>(pair) * GROUP + slice0 + s.sub * geo.rs + r0 + rr] =
          isfinite(rank) ? rank : INFINITY;
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[st]);
  }
}

// Checks the geometry, picks the route's instance and launches it on `st`.
// direct: the bulk route (the caller has checked alignment, the kernel
// checks it again and refuses a direct launch it cannot serve).
template <typename T, bool SCALED>
cudaError_t launch(const T* x, const float* scale, const float* xsq, const float* bias,
                   const float* q, const float* qsq, const int* groups, const int64_t* pairs,
                   float* out, int n, const Geometry& geo, int direct, cudaStream_t st) {
  const int64_t elt = sizeof(T);
  const int nch = geo.cols > 0 ? (geo.d + geo.cols - 1) / geo.cols : 0;
  if (n <= 0 || n % GROUP || geo.ng != n / GROUP || geo.d <= 0 || geo.p <= 0 ||
      geo.gsel <= 0 || geo.p % geo.gsel || geo.w < 1 || geo.w > MAX_WINDOW ||
      geo.rows < 1 || GROUP % geo.rows || geo.rs < 1 || geo.rows % geo.rs || geo.cols < 1 ||
      geo.cols > geo.d || (nch > 1 && geo.rs != 1) || geo.rs * geo.cols * elt > STAGE_BYTES)
    return cudaErrorInvalidValue;
  if (direct && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
                 geo.d * elt % 16 || geo.cols * elt % 16))
    return cudaErrorInvalidValue;
  const dim3 grid((geo.p + geo.w - 1) / geo.w, GROUP / geo.rows);
  const int steps = geo.w * (geo.rows / geo.rs) * nch;  // most steps a block can take
  const int nst = steps < MAX_STAGES ? steps : MAX_STAGES;
  const int smem = static_cast<int>(nst * geo.rs * geo.cols * elt);
  auto kernel = direct ? group_rescore<T, SCALED, true> : group_rescore<T, SCALED, false>;
  if (smem > 46 * 1024) {  // the static arrays count toward the 48 KB a launch takes unasked
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, THREADS, smem, st>>>(x, scale, xsq, bias, q, qsq, groups, pairs, out, geo, nst);
  return cudaGetLastError();
}

}  // namespace gr
}  // namespace
