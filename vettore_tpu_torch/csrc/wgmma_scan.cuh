// The tensor-core scan skeleton shared by K1 gmin_scan (csrc/flat_scan.cu),
// K3 int8_gmin_scan (csrc/int8_scan.cu), K5 stage_gmin_scan and K6
// sign_scan (csrc/adaptive_scan.cu) and the MaxSim maxsim_rank_scan
// (csrc/maxsim.cu).
//
// Each kernel takes the dots of rows x [n, d] against queries q [b, d] on
// the tensor cores, then reduces each 64-row group of every query column in
// an epilogue of its own. What depends on the element type is an operand
// policy (Op below):
// - S8 (K3, K6): wgmma.m64nNk32.s32.s8.s8, both operands K-major from shared
//   memory. The int32 dot is exact, so the order of summation is free.
// - Bf16 (K1, K5 and MaxSim on bf16 blocks): wgmma.m64nNk16.f32.bf16.bf16,
//   both operands K-major from shared memory. A product of two bf16 values
//   is exact in the f32 accumulator; only the order of summation differs
//   from any other f32 sum.
// - Tf32x3 (K1, K5 and MaxSim on f32 blocks): three wgmma.m64nNk8.f32.tf32.tf32 per k-step,
//   x.q ~ x_lo.q_hi + x_hi.q_lo + x_hi.q_hi, each v_hi being v rounded to
//   TF32 (cvt.rna.tf32.f32: 10 mantissa bits) and v_lo = v - v_hi, exact in
//   f32. The tensor cores read shared memory only as its TF32 truncation,
//   so a lo part has to exist as data: the wrapper splits the queries once
//   per batch (q_hi and q_lo, two query buffers per stage), and each
//   consumer splits its rows in registers, x being wgmma's A operand from
//   registers. Dropped: x_lo.q_lo (<= 2^-22 |x_i q_i|) and the low bit or
//   two of each lo part, random in sign: about f32's own rounding. Each
//   window of PROMOTE stages is summed apart and added to the accumulator
//   on the CUDA cores in f32, since the tensor cores' own running sum
//   drifts toward zero by about half an ulp a step.
// A k-step is 32 bytes for every type (k32 s8, k16 bf16, k8 tf32), so a
// 128-byte stage is four k-steps for all three and the shared-memory
// descriptors advance 32 bytes a step inside the 128-byte swizzle.
//
// Design (Hopper, sm_90a):
// - A tile is 128 rows (two 64-row groups, one consumer warpgroup each, so
//   a group's min never leaves its warpgroup) by QN = 64, 128 or 256
//   queries (at most 128 for Tf32x3, whose stages carry two query
//   buffers), QN picked from b so small batches do not multiply zeros. The
//   grid is persistent: one block per SM walks the tiles in order, the
//   query tile varying fastest, so the blocks that read the same 128 rows
//   run side by side and the second read hits L2.
// - A ring of k-stages of 128 bytes of d in dynamic shared memory, as many
//   as fit beside the epilogue regions (at most 8): A = 128 rows x 128 B,
//   then QBUFS query buffers of QN x 128 B. One producer thread keeps TMA
//   loads (cp.async.bulk.tensor.2d, 128-byte swizzle) in flight behind full
//   and empty mbarriers, across tiles: the next tile's stages load while
//   the consumers run this tile's epilogue. TMA zero-fills past d, n and b;
//   zeros add nothing to a dot, so the mainloop has no masks.
// - Each consumer warpgroup issues its stage's wgmmas, holds a 64 x QN
//   accumulator in registers (QN / 2 per thread), and keeps IN_FLIGHT
//   stages of products in flight (S8 and Bf16 one; Tf32x3 none, since its
//   A fragments are registers that the next stage would overwrite, and its
//   window sums are added to the accumulator as soon as they are done).
//   setmaxnreg moves registers from the producer warpgroup to the
//   consumers.
// - Each consumer warpgroup then runs its epilogue on its own accumulator,
//   with a shared-memory region of its own outside the ring (Frame); the
//   group-min epilogues take the min of every column with column_min below.
// - A chunked kernel (MaxSim over docs of T >= 256 token rows) walks work
//   items of `chunks` consecutive 128-row tiles against one query tile: the
//   block runs them one after another (the chunk of a tile is its row tile
//   modulo chunks), so that its epilogue can carry a running reduction from
//   one chunk to the next in its region. The other kernels are chunks = 1.
//
// Operands must be 16-byte aligned with a row stride that is a multiple of
// 16 bytes (TMA's rule). The Python wrappers copy other operands into a
// zero-padded block with such a stride first (ops/flat_scan.py::_tma_rows)
// and count the route; the same kernel then runs.
//
// cuTensorMapEncodeTiled is a driver-API symbol: it is reached through the
// runtime's driver entry point, so the library links no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wg {

constexpr int GROUP = 64;               // rows per selection group
constexpr int ROWS = 2 * GROUP;         // rows per tile
constexpr int KB = 128;                 // bytes of d per ring stage
constexpr int THREADS = 384;            // producer warpgroup + two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = ROWS * KB;      // 16 KB
constexpr int WG_A_BYTES = GROUP * KB;  // one consumer's 64 rows
constexpr int TILE_LD = GROUP + 8;      // epilogue int16 tile row: 144 bytes
constexpr int SMEM_MAX = 232448;        // dynamic shared memory of one block

template <int QN, int QBUFS>
struct Layout {
  // a consumer's epilogue region: an int16 tile of 64 query columns x 64
  // rows, the column minima of its 4 warps, two floats per query
  static constexpr int EPI_TILE = 0;
  static constexpr int EPI_RED = 64 * TILE_LD * 2;
  static constexpr int EPI_SIDE = EPI_RED + 4 * QN * 4;
  static constexpr int EPI = EPI_SIDE + 2 * QN * 4;
  static constexpr int STAGE = A_BYTES + QBUFS * QN * KB;
  static constexpr int FIT = (SMEM_MAX - 2 * EPI - 1024 - 2 * 8 * 8) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BARS = RING + 2 * EPI;  // full[], empty[]
  static constexpr int ALLOC = BARS + 2 * STAGES * 8 + 1024;  // + room to align to 1024
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(STAGE % 1024 == 0, "stages must keep the 128-byte swizzle atoms aligned");
  static_assert(EPI % 16 == 0, "epilogue tiles are read 16 bytes at a time");
  static_assert(EPI_TILE == 0, "a region starts with its tile (peer_tile)");
  static_assert(ALLOC <= SMEM_MAX, "the ring must fit a block's shared memory");
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D TMA load of one box at (inner coordinate k in elements, row) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is unused for
// swizzled K-major layouts; layout type 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

template <int M>
__device__ __forceinline__ void fence_acc(int (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// commits the wgmmas issued so far as one group and waits until at most N
// groups are in flight; the accumulator d is not touched in between
template <int N, class A, int M>
__device__ __forceinline__ void wgmma_commit_wait(A (&d)[M]) {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  fence_acc(d);
  wgmma_wait<N>();
  fence_acc(d);
}

// ---- wgmma instructions ---------------------------------------------------------
//
// d (+)= A[64 x k] . B[QN x k]^T; `scale` 0 overwrites d. A and B come from
// shared-memory descriptors, except for the TF32 form, whose A is a
// register fragment.

#define WG_R0_31                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R32_63                                                                \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63"
#define WG_R64_95                                                                \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "  \
  "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "  \
  "%94, %95"
#define WG_R96_127                                                               \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "   \
  "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "     \
  "%121, %122, %123, %124, %125, %126, %127"
#define WG_I(v) "+r"(v)
#define WG_F(v) "+f"(v)
#define WG_ACC8(C, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define WG_ACC32(C, i) WG_ACC8(C, i), WG_ACC8(C, i + 8), WG_ACC8(C, i + 16), WG_ACC8(C, i + 24)

template <int QN>
struct MmaS8;

template <>
struct MmaS8<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" WG_R0_31 "}, %32, %33, p;\n}\n"
        : WG_ACC32(WG_I, 0)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct MmaS8<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_R0_31 ", " WG_R32_63
        "}, %64, %65, p;\n}\n"
        : WG_ACC32(WG_I, 0), WG_ACC32(WG_I, 32)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct MmaS8<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WG_R0_31 ", " WG_R32_63
        ", " WG_R64_95 ", " WG_R96_127 "}, %128, %129, p;\n}\n"
        : WG_ACC32(WG_I, 0), WG_ACC32(WG_I, 32), WG_ACC32(WG_I, 64), WG_ACC32(WG_I, 96)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <int QN>
struct MmaBf16;

template <>
struct MmaBf16<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R0_31
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(WG_F, 0)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct MmaBf16<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R0_31 ", " WG_R32_63
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(WG_F, 0), WG_ACC32(WG_F, 32)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct MmaBf16<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_R0_31 ", " WG_R32_63
        ", " WG_R64_95 ", " WG_R96_127 "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(WG_F, 0), WG_ACC32(WG_F, 32), WG_ACC32(WG_F, 64), WG_ACC32(WG_F, 96)
        : "l"(a), "l"(b), "r"(scale));
  }
};

// A from registers: the warpgroup's m64k8 TF32 fragment, four values a thread
template <int QN>
struct MmaTf32;

template <>
struct MmaTf32<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R0_31
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_ACC32(WG_F, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct MmaTf32<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_R0_31 ", " WG_R32_63
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_ACC32(WG_F, 0), WG_ACC32(WG_F, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

#undef WG_ACC32
#undef WG_ACC8
#undef WG_F
#undef WG_I
#undef WG_R96_127
#undef WG_R64_95
#undef WG_R32_63
#undef WG_R0_31

// ---- operand policies ---------------------------------------------------------
//
// Each gives the accumulator type, the tensor maps' element type and size,
// the query buffers per stage, the widest query tile, the stages of
// products kept in flight, PROMOTE (0: the tensor cores sum into acc; n:
// they sum each window of n stages into `part`, which is then added to acc
// in f32), and mma<QN>(acc, part, a, b, t, kb, nk): the warpgroup's
// products of stage kb of nk, from its 64 rows at `a` and the stage's
// first query buffer at `b`, issued and committed, returning with at most
// IN_FLIGHT stages' products still in flight; stage 0 overwrites acc.

// Both operands K-major from shared memory, one Mma<QN> per k-step, one
// stage's products in flight; `part` is unused (PROMOTE 0)
template <template <int> class Mma, class A, CUtensorMapDataType T, int E>
struct SmemOperands {
  using Acc = A;
  static constexpr CUtensorMapDataType TYPE = T;
  static constexpr int ELEM = E, QBUFS = 1, QN_MAX = 256, IN_FLIGHT = 1, PROMOTE = 0;

  template <int QN, int P>
  static __device__ __forceinline__ void mma(A (&acc)[QN / 2], A (&)[P], const uint8_t* a,
                                             const uint8_t* b, int, int kb, int) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk)
      Mma<QN>::run(acc, desc(a + 32 * kk), desc(b + 32 * kk), kb > 0 || kk > 0);
    wgmma_commit_wait<IN_FLIGHT>(acc);
  }
};

using S8 = SmemOperands<MmaS8, int, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1>;
using Bf16 = SmemOperands<MmaBf16, float, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2>;

struct Tf32x3 {
  using Acc = float;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int ELEM = 4, QBUFS = 2, QN_MAX = 128, IN_FLIGHT = 0, PROMOTE = 4;

  // b: q_hi [QN rows x 128 B], then q_lo. Thread t (warp w, lane l) holds
  // A's fragment values at rows 16w + l/4 (+8) and, in k-step kk, columns
  // 8kk + l%4 (+4): 4-byte words at chunks 2kk and 2kk + 1 of its rows, the
  // chunks XORed with the row's place in its 8-row swizzle atom (l/4). The
  // 8 row places x 4 lanes then hit 32 banks: no conflicts.
  //
  // The tensor cores add each product into the accumulator with less than
  // f32's rounding (the running sum loses about half an ulp a step, always
  // toward zero): over the 288 steps of d = 768 that is ~1e-5 of a dot,
  // the whole tolerance. So each window of PROMOTE stages (48 steps, 128
  // values of d) sums into a fresh accumulator `part`, which is then added
  // to acc on the CUDA cores with f32 rounding: a window's sum is a small
  // share of the dot, and the f32 adds do not drift.
  template <int QN>
  static __device__ __forceinline__ void mma(float (&acc)[QN / 2], float (&part)[QN / 2],
                                             const uint8_t* a, const uint8_t* b, int t, int kb,
                                             int nk) {
    const int l = t % 32, g = l / 4, c = l % 4;
    const uint8_t* r0 = a + (16 * (t / 32) + g) * KB + 4 * c;
    uint32_t hi[KB / 32][4], lo[KB / 32][4];
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk) {
      const int o0 = ((2 * kk) ^ g) * 16, o1 = ((2 * kk + 1) ^ g) * 16;
      const float v[4] = {*reinterpret_cast<const float*>(r0 + o0),
                          *reinterpret_cast<const float*>(r0 + 8 * KB + o0),
                          *reinterpret_cast<const float*>(r0 + o1),
                          *reinterpret_cast<const float*>(r0 + 8 * KB + o1)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi[kk][i]) : "f"(v[i]));
        lo[kk][i] = __float_as_uint(__fsub_rn(v[i], __uint_as_float(hi[kk][i])));
      }
    }
    const bool open = kb % PROMOTE == 0;  // the window's first stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk) {
      const uint64_t bh = desc(b + 32 * kk), bl = desc(b + QN * KB + 32 * kk);
      MmaTf32<QN>::run(part, lo[kk], bh, !open || kk > 0);
      MmaTf32<QN>::run(part, hi[kk], bl, 1);
      MmaTf32<QN>::run(part, hi[kk], bh, 1);
    }
    wgmma_commit_wait<0>(part);
    if ((kb + 1) % PROMOTE == 0 || kb + 1 == nk) {
#pragma unroll
      for (int i = 0; i < QN / 2; ++i)
        acc[i] = kb < PROMOTE ? part[i] : __fadd_rn(acc[i], part[i]);
    }
  }
};

// ---- epilogue helpers ------------------------------------------------------
//
// Accumulator register i = 4j + 2h + c of thread t (warp w = t / 32, lane l)
// of a consumer warpgroup holds row 16w + l/4 + 8h of its group and query
// column 8j + 2(l%4) + c of the tile.

__device__ __forceinline__ int acc_row(int t, int h) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col(int t, int j, int c) { return 8 * j + 2 * (t % 4) + c; }

__device__ __forceinline__ float min2(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ int min2(int a, int b) { return min(a, b); }
__device__ __forceinline__ float as(float, int v) { return __int_as_float(v); }
__device__ __forceinline__ float as(float, float v) { return v; }
__device__ __forceinline__ int as(int, int v) { return v; }

struct Min {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return min2(a, b); }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// red[w][col] = the reduction (op: Min or Max) over warp w's 16 rows of
// every query column of a warpgroup's tile, whose registers hold T values
// (floats as themselves or as their bits in an int accumulator). Each
// thread first reduces its two rows. The 8 lanes of a warp that share
// columns (lane bits 2-4) then reduce 8 columns at a time and scatter them:
// at each of the three exchanges (xor 16, 8, 4) a lane keeps half of its
// columns and sends the other half, so 7 shuffles leave each lane with one
// column's value over the warp's 16 rows (24 for a plain butterfly on every
// column). red is [4][QN]; no barrier.
template <int QN, typename T, class Op, typename A>
__device__ __forceinline__ void warp_columns(const A (&acc)[QN / 2], T* red, int t, Op op) {
  const int w = t / 32, l = t % 32;
  const bool hi4 = l & 16, hi3 = l & 8, hi2 = l & 4;
#pragma unroll
  for (int j0 = 0; j0 < QN / 8; j0 += 4) {
    // v[k]: column acc_col(t, j0 + k / 2, k % 2)
    T v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 4 * (j0 + k / 2) + k % 2;
      v[k] = op(as(T(), acc[i]), as(T(), acc[i + 2]));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = op(hi4 ? v[k + 4] : v[k], __shfl_xor_sync(0xffffffffu, hi4 ? v[k] : v[k + 4], 16));
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] = op(hi3 ? v[k + 2] : v[k], __shfl_xor_sync(0xffffffffu, hi3 ? v[k] : v[k + 2], 8));
    v[0] = op(hi2 ? v[1] : v[0], __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[1], 4));
    const int k = l / 4;  // the column this lane now holds: 4 hi4 + 2 hi3 + hi2
    red[w * QN + acc_col(t, j0 + k / 2, k % 2)] = v[0];
  }
}

// The min over the 64 rows of every query column of a warpgroup's tile:
// warp_columns, then the 4 warps meet through red [4][QN]. Ends on the
// warpgroup's barrier `bar`; red[col] then holds column col's min for the
// caller to store.
template <int QN, typename T, typename A>
__device__ __forceinline__ void column_min(const A (&acc)[QN / 2], T* red, int t, int bar) {
  warp_columns<QN, T>(acc, red, t, Min());
  named_sync(bar, 128);
  for (int col = t; col < QN; col += 128)
    red[col] = min2(min2(red[col], red[QN + col]), min2(red[2 * QN + col], red[3 * QN + col]));
  named_sync(bar, 128);
}

// What the epilogue of one consumer warpgroup is given: its own shared
// memory (Layout's EPI_* regions), its thread, its named barrier, its
// group (the warpgroup is g % 2 of its tile) and the tile's first query.
struct Frame {
  int16_t* tile;  // [64][TILE_LD]
  void* red;      // [4][QN] floats or ints
  float* side;    // [2][QN]
  int t;          // thread in the warpgroup
  int bar;        // the warpgroup's named barrier
  int g;          // its 64-row group
  int q0;         // the tile's first query
};

// the named barrier of both consumer warpgroups (256 threads); 2 and 3 are
// each warpgroup's own
constexpr int CONSUMERS_BAR = 1;

// the other consumer warpgroup's tile: the two epilogue regions lie side by
// side, and their size does not depend on the policy's query buffers
template <int QN>
__device__ __forceinline__ int16_t* peer_tile(const Frame& f) {
  constexpr int EPI = Layout<QN, 1>::EPI;
  return reinterpret_cast<int16_t*>(reinterpret_cast<uint8_t*>(f.tile) + (f.g % 2 ? -EPI : EPI));
}

// ---- the kernel --------------------------------------------------------------
//
// Epi provides, for each tile and each consumer warpgroup whose group lies
// inside n: prefetch<QN>(frame), run before the tile's mainloop, which
// loads into registers (an Epi::Pre) what the epilogue needs from device
// memory, so the loads' latency hides behind the products; and
// finish<QN>(acc, frame, pre) after it, which writes only its warpgroup's
// region and starts on the warpgroup's barrier (the previous tile's
// readers of the region are done). CHUNKED kernels walk work items of
// `chunks` row tiles; the others take chunks as 1, whatever is passed.

template <class Op, int QN, class Epi, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap qmap2, const Epi epi, int ng, int nk, int nqt,
            int items, int chunks) {
  using L = Layout<QN, Op::QBUFS>;
  using Acc = typename Op::Acc;
  constexpr int KE = KB / Op::ELEM;  // elements of d per stage
  const int nc = CHUNKED ? chunks : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + L::STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int s = 0, ph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        for (int c = 0; c < nc; ++c) {
          const int q0 = (item % nqt) * QN, row0 = ((item / nqt) * nc + c) * ROWS;
          for (int kb = 0; kb < nk; ++kb) {
            mbar_wait(&empty[s], ph ^ 1);
            mbar_expect_tx(&full[s], L::STAGE);
            uint8_t* stage = smem + s * L::STAGE;
            tma_load(stage, &xmap, kb * KE, row0, &full[s]);
            tma_load(stage + A_BYTES, &qmap, kb * KE, q0, &full[s]);
            if constexpr (Op::QBUFS == 2)
              tma_load(stage + A_BYTES + QN * KB, &qmap2, kb * KE, q0, &full[s]);
            if (++s == L::STAGES) s = 0, ph ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wgc = tid / 128 - 1;
    const int t = tid % 128;
    uint8_t* region = smem + L::RING + wgc * L::EPI;
    Acc acc[QN / 2];
    Acc part[Op::PROMOTE > 0 ? QN / 2 : 1];
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) acc[i] = 0;
    int s = 0, ph = 0;
    // the block's tiles: chunk c of work item `item`
    for (int item = blockIdx.x, c = 0; item < items;) {
      const Frame frame{reinterpret_cast<int16_t*>(region + L::EPI_TILE), region + L::EPI_RED,
                        reinterpret_cast<float*>(region + L::EPI_SIDE), t, 2 + wgc,
                        ((item / nqt) * nc + c) * 2 + wgc, (item % nqt) * QN};
      const bool inside = frame.g < ng;
      typename Epi::Pre pre{};
      if (inside) pre = epi.template prefetch<QN>(frame);
      fence_acc(acc);
      int prev = s;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[s], ph);
        const uint8_t* stage = smem + s * L::STAGE;
        Op::template mma<QN>(acc, part, stage + wgc * WG_A_BYTES, stage + A_BYTES, t, kb, nk);
        // the products of all but IN_FLIGHT stages are done: hand their
        // buffers back
        if constexpr (Op::IN_FLIGHT == 0) {
          if (t % 32 == 0) mbar_arrive(&empty[s]);
        } else {
          if (kb > 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
          prev = s;
        }
        if (++s == L::STAGES) s = 0, ph ^= 1;
      }
      if constexpr (Op::IN_FLIGHT > 0) {
        wgmma_wait<0>();
        fence_acc(acc);
        if (t % 32 == 0) mbar_arrive(&empty[prev]);
      }
      if (inside) epi.template finish<QN>(acc, frame, pre);
      if (++c == nc) c = 0, item += gridDim.x;
    }
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of an Op-typed matrix [rows, d] with row stride ld bytes,
// read in boxes of 128 bytes of d by box_rows rows, 128-byte swizzle
template <class Op>
bool encode(CUtensorMap* map, const void* base, int rows, int d, int64_t ld, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {KB / Op::ELEM, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, Op::TYPE, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the persistent grid over the row tiles of x [n, d] (a group
// lies inside n when its first row does) and the QN-query tiles of q
// [b, d]; a CHUNKED kernel walks work items of `chunks` consecutive row
// tiles (the row tiles a multiple of chunks).
template <class Op, int QN, class Epi, bool CHUNKED = false>
cudaError_t launch(const void* x, int64_t ldx, const void* q, const void* q2, int64_t ldq, int n,
                   int d, int b, const Epi& epi, cudaStream_t stream, int chunks = 1) {
  using L = Layout<QN, Op::QBUFS>;
  CUtensorMap xmap, qmap, qmap2;
  if (!encode<Op>(&xmap, x, n, d, ldx, ROWS) || !encode<Op>(&qmap, q, b, d, ldq, QN))
    return cudaErrorInvalidValue;
  if constexpr (Op::QBUFS == 2) {
    if (!encode<Op>(&qmap2, q2, b, d, ldq, QN)) return cudaErrorInvalidValue;
  } else {
    qmap2 = qmap;  // unread
  }
  auto kernel = scan_kernel<Op, QN, Epi, CHUNKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + ROWS - 1) / ROWS;
  if (chunks < 1 || (CHUNKED ? row_tiles % chunks : chunks != 1)) return cudaErrorInvalidValue;
  const int nqt = (b + QN - 1) / QN;
  const int64_t items = static_cast<int64_t>(row_tiles / chunks) * nqt;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  const int nk = static_cast<int>((static_cast<int64_t>(d) * Op::ELEM + KB - 1) / KB);
  kernel<<<blocks, THREADS, L::ALLOC, stream>>>(xmap, qmap, qmap2, epi, (n + GROUP - 1) / GROUP,
                                                nk, nqt, static_cast<int>(items), chunks);
  return cudaGetLastError();
}

inline bool tma_ok(const void* p, int64_t ld, int64_t row_bytes) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 16 == 0 &&
         ld >= row_bytes;
}

// What TMA needs of the operands: 16-byte aligned bases, row strides in
// bytes a multiple of 16 and at least a row of d elements; q2 (Tf32x3's
// q_lo, with q's stride) only for two-buffer policies.
template <class Op>
bool operands_ok(const void* x, int64_t ldx, const void* q, const void* q2, int64_t ldq, int d) {
  const int64_t row = static_cast<int64_t>(d) * Op::ELEM;
  return d > 0 && tma_ok(x, ldx, row) && tma_ok(q, ldq, row) &&
         (Op::QBUFS == 1 || tma_ok(q2, ldq, row));
}

// The shared entry of the group scans: checks the operands, picks the
// query tile from b, and launches. q2 is the second query operand (Tf32x3's
// q_lo, with q's stride), unused by the other policies. n % 64 == 0.
template <class Op, class Epi>
cudaError_t scan(const void* x, int64_t ldx, const void* q, const void* q2, int64_t ldq, int n,
                 int d, int b, const Epi& epi, cudaStream_t stream) {
  if (n <= 0 || n % GROUP || b <= 0 || !operands_ok<Op>(x, ldx, q, q2, ldq, d))
    return cudaErrorInvalidValue;
  if (b <= 64) return launch<Op, 64>(x, ldx, q, q2, ldq, n, d, b, epi, stream);
  if (b <= 128 || Op::QN_MAX == 128)
    return launch<Op, 128>(x, ldx, q, q2, ldq, n, d, b, epi, stream);
  if constexpr (Op::QN_MAX == 256)
    return launch<Op, 256>(x, ldx, q, q2, ldq, n, d, b, epi, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace
