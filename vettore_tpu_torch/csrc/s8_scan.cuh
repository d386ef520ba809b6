// The int8 tensor-core mainloop shared by K3 int8_gmin_scan
// (csrc/int8_scan.cu) and K6 sign_scan (csrc/adaptive_scan.cu).
//
// Both kernels take exact int32 dots of int8 rows x8 [n, d] against int8
// queries q8 [b, d], then reduce each 64-row group of every query column
// in an epilogue of their own. The dot is an exact integer, so the order of
// summation is free: the int8 tensor cores (wgmma s32.s8.s8) give the same
// bits as any other order.
//
// Design (Hopper, sm_90a):
// - A tile is 128 rows (two 64-row groups, one consumer warpgroup each, so
//   a group's min never leaves its warpgroup) by QN = 64, 128 or 256
//   queries, QN picked from b so small batches do not multiply zeros. The
//   grid is persistent: one block per SM walks the tiles in order, the
//   query tile varying fastest, so the blocks that read the same 128 rows
//   run side by side and the second read hits L2.
// - A ring of k-stages of 128 bytes of d in dynamic shared memory (4, 6 or
//   8 stages for QN = 256, 128, 64): A = 128 rows x 128 B, B = QN x 128 B.
//   One producer thread keeps TMA loads (cp.async.bulk.tensor.2d, 128-byte
//   swizzle) in flight behind full and empty mbarriers, across tiles: the
//   next tile's stages load while the consumers run this tile's epilogue.
//   TMA zero-fills past d, n and b; zero bytes add nothing to an integer
//   dot, so the mainloop has no masks.
// - Each consumer warpgroup runs four wgmma.m64n{QN}k32.s32.s8.s8 per stage,
//   both operands K-major from shared-memory descriptors (the only layout
//   8-bit wgmma takes, and already the layout of x8 and q8), keeps one
//   stage's products in flight, and holds a 64 x QN int32 accumulator in
//   registers (QN / 2 per thread). setmaxnreg moves registers from the
//   producer warpgroup to the consumers.
// - Each consumer warpgroup then runs its epilogue on its own accumulator,
//   with a shared-memory region of its own outside the ring (Frame); the
//   epilogues take the group-min of every column with column_min below.
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
namespace s8 {

constexpr int GROUP = 64;               // rows per selection group
constexpr int ROWS = 2 * GROUP;         // rows per tile
constexpr int KB = 128;                 // bytes of d per ring stage
constexpr int THREADS = 384;            // producer warpgroup + two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = ROWS * KB;      // 16 KB
constexpr int WG_A_BYTES = GROUP * KB;  // one consumer's 64 rows
constexpr int TILE_LD = GROUP + 8;      // epilogue int16 tile row: 144 bytes

template <int QN>
struct Layout {
  static constexpr int STAGES = QN == 256 ? 4 : QN == 128 ? 6 : 8;
  static constexpr int STAGE = A_BYTES + QN * KB;
  static constexpr int RING = STAGES * STAGE;
  // a consumer's epilogue region: an int16 tile of 64 query columns x 64
  // rows, the column minima of its 4 warps, two floats per query
  static constexpr int EPI_TILE = 0;
  static constexpr int EPI_RED = 64 * TILE_LD * 2;
  static constexpr int EPI_SIDE = EPI_RED + 4 * QN * 4;
  static constexpr int EPI = EPI_SIDE + 2 * QN * 4;
  static constexpr int BARS = RING + 2 * EPI;  // full[], empty[]
  static constexpr int ALLOC = BARS + 2 * STAGES * 8 + 1024;  // + room to align to 1024
  static_assert(STAGE % 1024 == 0, "stages must keep the 128-byte swizzle atoms aligned");
  static_assert(EPI % 16 == 0, "epilogue tiles are read 16 bytes at a time");
  static_assert(ALLOC <= 232448, "the ring must fit a block's shared memory");
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

// a 2-D TMA load of one box at (inner coordinate k, row) into shared memory,
// completing on `bar`
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

template <int M>
__device__ __forceinline__ void fence_acc(int (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define S8_R0_31                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define S8_R32_63                                                                \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63"
#define S8_R64_95                                                                \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "  \
  "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "  \
  "%94, %95"
#define S8_R96_127                                                               \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "   \
  "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "     \
  "%121, %122, %123, %124, %125, %126, %127"
#define S8_ACC8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define S8_ACC32(i) S8_ACC8(i), S8_ACC8(i + 8), S8_ACC8(i + 16), S8_ACC8(i + 24)

// d (+)= A[64 x 32] . B[QN x 32]^T in int32; `scale` 0 overwrites d
template <int QN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" S8_R0_31 "}, %32, %33, p;\n}\n"
        : S8_ACC32(0)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" S8_R0_31 ", " S8_R32_63
        "}, %64, %65, p;\n}\n"
        : S8_ACC32(0), S8_ACC32(32)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" S8_R0_31 ", " S8_R32_63
        ", " S8_R64_95 ", " S8_R96_127 "}, %128, %129, p;\n}\n"
        : S8_ACC32(0), S8_ACC32(32), S8_ACC32(64), S8_ACC32(96)
        : "l"(a), "l"(b), "r"(scale));
  }
};

#undef S8_ACC32
#undef S8_ACC8
#undef S8_R96_127
#undef S8_R64_95
#undef S8_R32_63
#undef S8_R0_31

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
__device__ __forceinline__ int as(int, int v) { return v; }

// The min over the 64 rows of every query column of a warpgroup's tile,
// whose registers hold T values (floats as their bits). Each thread first
// takes the min of its two rows. The 8 lanes of a warp that share columns
// (lane bits 2-4) then reduce 8 columns at a time and scatter them: at each
// of the three exchanges (xor 16, 8, 4) a lane keeps half of its columns and
// sends the other half, so 7 shuffles leave each lane with one column's min
// over the warp's 16 rows (24 for a plain butterfly on every column). The 4
// warps meet through red [4][QN]. Ends on the warpgroup's barrier `bar`;
// red[col] then holds column col's min for the caller to store.
template <int QN, typename T>
__device__ __forceinline__ void column_min(const int (&acc)[QN / 2], T* red, int t, int bar) {
  const int w = t / 32, l = t % 32;
  const bool hi4 = l & 16, hi3 = l & 8, hi2 = l & 4;
#pragma unroll
  for (int j0 = 0; j0 < QN / 8; j0 += 4) {
    // v[k]: column acc_col(t, j0 + k / 2, k % 2)
    T v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 4 * (j0 + k / 2) + k % 2;
      v[k] = min2(as(T(), acc[i]), as(T(), acc[i + 2]));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = min2(hi4 ? v[k + 4] : v[k], __shfl_xor_sync(0xffffffffu, hi4 ? v[k] : v[k + 4], 16));
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] = min2(hi3 ? v[k + 2] : v[k], __shfl_xor_sync(0xffffffffu, hi3 ? v[k] : v[k + 2], 8));
    v[0] = min2(hi2 ? v[1] : v[0], __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[1], 4));
    const int k = l / 4;  // the column this lane now holds: 4 hi4 + 2 hi3 + hi2
    red[w * QN + acc_col(t, j0 + k / 2, k % 2)] = v[0];
  }
  named_sync(bar, 128);
  for (int col = t; col < QN; col += 128)
    red[col] = min2(min2(red[col], red[QN + col]), min2(red[2 * QN + col], red[3 * QN + col]));
  named_sync(bar, 128);
}

// What the epilogue of one consumer warpgroup is given: its own shared
// memory (Layout's EPI_* regions), its thread, its named barrier, its
// group and the tile's first query.
struct Frame {
  int16_t* tile;  // [64][TILE_LD]
  void* red;      // [4][QN] floats or ints
  float* side;    // [2][QN]
  int t;          // thread in the warpgroup
  int bar;        // the warpgroup's named barrier
  int g;          // its 64-row group
  int q0;         // the tile's first query
};

// ---- the kernel --------------------------------------------------------------
//
// Epi provides, for each tile and each consumer warpgroup whose group lies
// inside n: prefetch<QN>(frame), run before the tile's mainloop, which
// loads into registers (an Epi::Pre) what the epilogue needs from device
// memory, so the loads' latency hides behind the products; and
// finish<QN>(acc, frame, pre) after it, which writes only its warpgroup's
// region and starts on the warpgroup's barrier (the previous tile's
// readers of the region are done).

template <int QN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
s8_scan_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
               const Epi epi, int ng, int nk, int nqt, int tiles) {
  using L = Layout<QN>;
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
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int q0 = (tile % nqt) * QN, row0 = (tile / nqt) * ROWS;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], L::STAGE);
          uint8_t* stage = smem + s * L::STAGE;
          tma_load(stage, &xmap, kb * KB, row0, &full[s]);
          tma_load(stage + A_BYTES, &qmap, kb * KB, q0, &full[s]);
          if (++s == L::STAGES) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wgc = tid / 128 - 1;
    const int t = tid % 128;
    uint8_t* region = smem + L::RING + wgc * L::EPI;
    int acc[QN / 2];
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) acc[i] = 0;
    int s = 0, ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Frame frame{reinterpret_cast<int16_t*>(region + L::EPI_TILE), region + L::EPI_RED,
                        reinterpret_cast<float*>(region + L::EPI_SIDE), t, 2 + wgc,
                        (tile / nqt) * 2 + wgc, (tile % nqt) * QN};
      const bool inside = frame.g < ng;
      typename Epi::Pre pre{};
      if (inside) pre = epi.template prefetch<QN>(frame);
      fence_acc(acc);
      int prev = s;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[s], ph);
        const uint8_t* a = smem + s * L::STAGE + wgc * WG_A_BYTES;
        const uint8_t* b = smem + s * L::STAGE + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          Mma<QN>::run(acc, desc(a + 32 * kk), desc(b + 32 * kk), kb > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(acc);
        // the previous stage's products are done: hand its buffers back
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        if (kb > 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == L::STAGES) s = 0, ph ^= 1;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (t % 32 == 0) mbar_arrive(&empty[prev]);
      if (inside) epi.template finish<QN>(acc, frame, pre);
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

// the tensor map of an int8 matrix [rows, d] with row stride ld bytes, read
// in boxes of 128 bytes of d by box_rows rows, 128-byte swizzle
inline bool encode(CUtensorMap* map, const int8_t* base, int rows, int d, int64_t ld,
                   int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {KB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QN, class Epi>
cudaError_t launch(const int8_t* x, int64_t ldx, const int8_t* q, int64_t ldq, int n, int d,
                   int b, const Epi& epi, cudaStream_t stream) {
  using L = Layout<QN>;
  CUtensorMap xmap, qmap;
  if (!encode(&xmap, x, n, d, ldx, ROWS) || !encode(&qmap, q, b, d, ldq, QN))
    return cudaErrorInvalidValue;
  auto kernel = s8_scan_kernel<QN, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nqt = (b + QN - 1) / QN;
  const int64_t tiles = static_cast<int64_t>((n + ROWS - 1) / ROWS) * nqt;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<blocks, THREADS, L::ALLOC, stream>>>(xmap, qmap, epi, n / GROUP, (d + KB - 1) / KB,
                                                nqt, static_cast<int>(tiles));
  return cudaGetLastError();
}

// The shared entry: checks what TMA needs (16-byte aligned bases, row
// strides a multiple of 16 bytes and at least d), picks the query tile from
// b, and launches. n % 64 == 0.
template <class Epi>
cudaError_t scan(const int8_t* x, int64_t ldx, const int8_t* q, int64_t ldq, int n, int d, int b,
                 const Epi& epi, cudaStream_t stream) {
  if (n <= 0 || n % GROUP || d <= 0 || b <= 0 || ldx < d || ldq < d || ldx % 16 || ldq % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return cudaErrorInvalidValue;
  if (b <= 64) return launch<64>(x, ldx, q, ldq, n, d, b, epi, stream);
  if (b <= 128) return launch<128>(x, ldx, q, ldq, n, d, b, epi, stream);
  return launch<256>(x, ldx, q, ldq, n, d, b, epi, stream);
}

}  // namespace s8
}  // namespace
