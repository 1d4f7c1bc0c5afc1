// Hopper building blocks (sm_90a): mbarriers, TMA tile loads, wgmma
// descriptors, the bf16 m64n128k16 and m64nNk16 products (both operands
// from shared memory), the s8 m64nNk32 products and the s8 A fragment of
// an MN-major tile, register hand-over between warpgroups, the e4m3 ->
// bf16 stage upcast, and the host-side tensor-map encoder. Inline PTX, no
// library. Used by csrc/quant_matmul.cu (K5, K6, K7), csrc/gmm.cu (K10)
// and csrc/mla_prefill.cu (K11b, K11e).
//
// Shared-memory tiles that wgmma reads are in the 128-byte swizzle that
// TMA writes (CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), every tile 1024-byte
// aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

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
// waits until the barrier's phase with parity `parity` has completed; a
// wait of some 2^28 polls (seconds) traps, so that a pipeline fault ends the
// launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
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

// every thread of every block of the cluster arrives (its earlier memory
// operations released), then waits for all of them (acquiring theirs)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

// d[64 x N] (+)= A[64 x 16] . B[16 x N], bf16 in, f32 accumulators, both
// operands read from shared memory through descriptors (K11b / K11e). A is
// K-major. kTransB 0: B K-major ([N rows, k], as latent rows lie, for
// Q K^T); 1: B MN-major ([k rows, N], a latent stage's value lanes, for
// P V). scale_d 0 overwrites d (the first k16 step). Fragments as above:
// d[4j + 2h + e] is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int scale_d);
template <>
__device__ __forceinline__ void wgmma_bf16_ss<32, 0>(float (&d)[16], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16_ss<64, 1>(float (&d)[32], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16_ss<128, 1>(float (&d)[64], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16_ss<256, 1>(float (&d)[128], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// int accumulators: as fence_regs
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// s8 wgmma (K5): d[64 x N] += A[64 x 32] . B[32 x N], int8 in, exact s32
// accumulators, both operands K-major (8-bit wgmma has no transpose). "rs":
// A from registers (the fragment of s8_frag_mn below), B from a K-major
// 128-byte-swizzled tile. Accumulator fragments as the bf16 product's:
// d[4j + 2h + e] is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_m64n16k32_s8_rs(int* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The s8 A fragment of m64nNk32 for one warp's 16 rows, read from an
// MN-major tile: a weight stage [k rows of 128 bytes, n contiguous] in the
// 128-byte swizzle, as TMA lands the [K, N] row-major weight. wgmma wants
// A K-major: a thread's register holds 4 consecutive k of one row. One
// ldmatrix.x4.trans moves 2-byte (n, n + 1) pairs of four 8 x 8 matrices
// whose rows are k rows; each thread gets (k, k + 1) x (n, n + 1) byte
// blocks, and two byte permutes turn two of them into (k .. k + 3) of n and
// of n + 1. So A's rows are the warp's 16 columns in the order
// 2 g + h <-> row g + 8 h (g = lane / 4): row r = g + 8 h of the fragment is
// column 2 g + h of the warp's 16 (s8_frag_col).
// Matrix rows: k {0, 1, 4, 5, 10, 11, 14, 15} and {2, 3, 6, 7, 8, 9, 12, 13}
// (then + 16): a thread (lane % 4 = q) gets rows 2 q, 2 q + 1 of each, k
// 4 q .. 4 q + 3 between the two, and each matrix's eight k rows fall in
// eight different swizzle phases, so the 16-byte rows hit distinct banks.
// s8_frag_offset(ch, lane): the lane's byte offset in the stage for the
// warp's 16 columns, chunk ch (n / 16) of the 128-byte row; + 4096 kk for
// the k32 step kk.
__device__ __forceinline__ uint32_t s8_frag_offset(int ch, int lane) {
  const int i = lane >> 3, j = lane & 7;
  const int ka = (j & 1) + 4 * (j >> 1) + (j >= 4 ? 2 : 0);  // 0 1 4 5 10 11 14 15
  const int kr = 16 * (i >> 1) + ((i & 1) ? (ka ^ 2) : ka);
  return (uint32_t)(kr * 128 + ((ch ^ (kr & 7)) << 4));
}
__device__ __forceinline__ void s8_frag_mn(uint32_t (&a)[4], const unsigned char* p, int lane) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, p);
  const bool swap = lane & 2;  // lanes q = 2, 3 find k 4q, 4q + 1 in the second matrix
  const uint32_t lo0 = swap ? r[1] : r[0], hi0 = swap ? r[0] : r[1];
  const uint32_t lo1 = swap ? r[3] : r[2], hi1 = swap ? r[2] : r[3];
  a[0] = __byte_perm(lo0, hi0, 0x6420);  // row g (column 2 g), k 4q .. 4q + 3
  a[1] = __byte_perm(lo0, hi0, 0x7531);  // row g + 8 (column 2 g + 1)
  a[2] = __byte_perm(lo1, hi1, 0x6420);  // row g, k 16 + 4q ..
  a[3] = __byte_perm(lo1, hi1, 0x7531);  // row g + 8, k 16 + 4q ..
}
// the weight column (of the warp's 16) of fragment row g + 8 h
__device__ __forceinline__ int s8_frag_col(int g, int h) { return 2 * g + h; }

// ---------------------------------------------------------------------------
// e4m3 weights: a stage of [64 k x 128 n] bytes -> two swizzled bf16 blocks
// ---------------------------------------------------------------------------
// 4 e4m3 bytes -> 4 bf16 (two bf16x2 words, the low bytes first), exact:
// each byte's exponent and mantissa are shifted into bf16's fields and the
// pair is scaled by 2^120 (bf16's bias 127 less e4m3's 7), exact for every
// finite e4m3 value, subnormals included (bf16 products keep subnormal
// inputs). Integer and bf16x2 operations only, no cvt (the conversion
// unit's quarter rate). NaN bytes (0x7f, 0xff) are left to the caller.
__device__ __forceinline__ void e4m3x4_to_bf16(uint32_t in, uint32_t& lo, uint32_t& hi) {
  const uint32_t x0 = __byte_perm(in, 0, 0x1404);  // b1 << 24 | b0 << 8
  const uint32_t x1 = __byte_perm(in, 0, 0x3424);  // b3 << 24 | b2 << 8
  uint32_t a = ((x0 >> 4) & 0x07F007F0u) | (x0 & 0x80008000u);
  uint32_t b = ((x1 >> 4) & 0x07F007F0u) | (x1 & 0x80008000u);
  const uint32_t k2 = 0x7B807B80u;  // (2^120, 2^120)
  const __nv_bfloat162 ka = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                    *reinterpret_cast<const __nv_bfloat162*>(&k2));
  const __nv_bfloat162 kb = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&b),
                                    *reinterpret_cast<const __nv_bfloat162*>(&k2));
  lo = *reinterpret_cast<const uint32_t*>(&ka);
  hi = *reinterpret_cast<const uint32_t*>(&kb);
}
// nonzero when a byte of the 16 is an e4m3 NaN (low seven bits all set)
__device__ __forceinline__ uint32_t e4m3_nan_bytes(uint4 v) {
  const uint32_t m = 0x7F7F7F7Fu, one = 0x01010101u;
  return (((v.x & m) + one) | ((v.y & m) + one) | ((v.z & m) + one) | ((v.w & m) + one)) &
         0x80808080u;
}

constexpr int kStageBK = 64;               // k of a weight stage
constexpr int kStageBN = 128;              // n of a weight stage: two 64-column blocks
constexpr int kStageBlock = kStageBK * 128;  // bytes of one swizzled [64 x 64] bf16 block

// Thread c (0-127) of a converter warpgroup upcasts its four 16-byte chunks
// (a row's 16 columns each) of the stage's e4m3 bytes `raw` ([64 k x 128 n]
// as TMA lands them, rows of 128 bytes) into the two swizzled [64 x 64]
// bf16 blocks at `dst` that wgmma reads: loads first, then the four
// conversions in one straight line; NaN bytes through upcast2 (exact, NaN
// kept). The caller fences (fence_async_shared) and signals.
__device__ __forceinline__ void e4m3_stage_to_bf16(const unsigned char* raw, unsigned char* dst,
                                                   int c) {
  constexpr int kSteps = kStageBK * kStageBN / 16 / 128;
  uint4 v[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int q = c + i * 128;
    v[i] = *reinterpret_cast<const uint4*>(raw + (q >> 3) * kStageBN + (q & 7) * 16);
  }
  bool nan = false;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) nan |= e4m3_nan_bytes(v[i]) != 0;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int q = c + i * 128, r = q >> 3, cb = (q & 7) * 16;
    uint32_t o[8];
    if (!nan) {
      e4m3x4_to_bf16(v[i].x, o[0], o[1]);
      e4m3x4_to_bf16(v[i].y, o[2], o[3]);
      e4m3x4_to_bf16(v[i].z, o[4], o[5]);
      e4m3x4_to_bf16(v[i].w, o[6], o[7]);
    } else {
      const uint32_t in[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[2 * j] = upcast2<e4m3>(in[j]);
        o[2 * j + 1] = upcast2<e4m3>(in[j] >> 16);
      }
    }
    unsigned char* row = dst + (cb >> 6) * kStageBlock + r * 128;
    const int ch = (cb & 63) >> 3;  // first 16-byte chunk of the row
    *reinterpret_cast<uint4*>(row + ((ch ^ (r & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (r & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
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
