// Hopper building blocks (sm_90a): mbarriers, TMA tile loads, wgmma
// descriptors and the bf16 m64n128k16 product, register hand-over between
// warpgroups, and the host-side tensor-map encoder. Inline PTX, no
// library. Used by csrc/quant_matmul.cu (K6, K7); written for the other
// GEMM-shaped kernels (K10, the prefill attention) to share.
//
// Shared-memory tiles that wgmma reads are in the 128-byte swizzle that
// TMA writes (CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), every tile 1024-byte
// aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace xllm {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers (one 64-bit word in shared memory each)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// after every mbar_init of a block, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// one arrival that also announces `bytes` of TMA transactions to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA: a 2-d tile of a tensor map into shared memory, completing on `bar`.
// c0 is the inner (contiguous) coordinate, c1 the row. Reads out of the
// tensor's bounds land as zeros and still count as transaction bytes.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}
// generic-proxy writes to shared memory -> visible to wgmma / TMA (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier over `count` threads (a multiple of 32); id 0 is __syncthreads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// register hand-over between warpgroups (every warp of a warpgroup runs it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Matrix descriptor of a 128-byte-swizzled tile (layout type 1), in bytes:
// - K-major (x [rows, 64 k], k contiguous): sbo = 1024 (8 rows of 128 B),
//   lbo unused; a k16 step advances the address by 32 bytes;
// - MN-major (the weight [k rows, 64 n] per 128-byte column block, n
//   contiguous): lbo = the distance between 64-column blocks, sbo = 1024
//   (8 k rows); a k16 step advances the address by 2048 bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], bf16 in, f32 accumulators; A
// K-major, B MN-major (trans-b: the [K, N] row-major weight as it lies).
// Accumulator fragments (warp w of the warpgroup, lane l): d[4j + 2h + e]
// is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is a driver entry point; it is
// fetched once through the runtime (cudaGetDriverEntryPoint), so that the
// libraries link against nothing beyond the CUDA runtime.
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `elem` bytes per element, read in
// boxes of [box_rows, box_cols]; out-of-bounds reads fill zeros. ->
// cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                             int elem, uint64_t rows, uint64_t cols, uint32_t box_rows,
                             uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// encode_2d through a small per-thread cache: a map depends only on its
// arguments, so a hit is always the map encode_2d would write (a weight's
// maps recur every step; an activation's whenever its address does)
inline cudaError_t encode_2d_cached(CUtensorMap* map, const void* base,
                                    CUtensorMapDataType type, int elem, uint64_t rows,
                                    uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                                    CUtensorMapSwizzle swizzle) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    uint64_t rows, cols;
    uint32_t box_rows, box_cols;
    int type, swizzle;
  };
  constexpr int kEntries = 256;
  thread_local Entry cache[kEntries] = {};
  const uint64_t h = (reinterpret_cast<uintptr_t>(base) >> 8) ^ (rows * 0x9E3779B97F4A7C15ull) ^
                     (cols << 17) ^ ((uint64_t)box_rows << 7) ^ (uint64_t)type;
  Entry& e = cache[(h ^ (h >> 29)) % kEntries];
  if (e.base == base && base != nullptr && e.rows == rows && e.cols == cols &&
      e.box_rows == box_rows && e.box_cols == box_cols && e.type == (int)type &&
      e.swizzle == (int)swizzle) {
    *map = e.map;
    return cudaSuccess;
  }
  const cudaError_t err =
      encode_2d(map, base, type, elem, rows, cols, box_rows, box_cols, swizzle);
  if (err == cudaSuccess) {
    e.map = *map;
    e.base = base;
    e.rows = rows;
    e.cols = cols;
    e.box_rows = box_rows;
    e.box_cols = box_cols;
    e.type = (int)type;
    e.swizzle = (int)swizzle;
  }
  return err;
}

}  // namespace hopper
}  // namespace xllm
