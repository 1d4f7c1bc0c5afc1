// Shared helpers of the hand-written Hopper kernels (built for sm_90a by
// xllm_tpu_torch/ops/cuda/_build.py, bound with ctypes through plain C
// entries that return cudaGetLastError()).
//
// Split paged KV cache layout, all layers stacked (the JAX package's):
//   k_cache, v_cache: [L, num_blocks, Hkv, block_size, D]
// A token's row of one head is D contiguous elements; one (layer, block,
// head) page is a contiguous [block_size, D] tile. The interleaved layout
// (kv_layout="interleaved", K8) keeps a page's K and V together in one
// array [L, num_blocks, 2, Hkv, block_size, D]; with row-major tails
// ("interleaved_rm", K9) a sequence's incomplete last page holds its
// content token-major (PageLayout below).
#pragma once

#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

// dtype codes (ops/cuda/_build.py DTYPE_*)
#define XLLM_DTYPE_F32 0
#define XLLM_DTYPE_BF16 1
#define XLLM_DTYPE_I8 2
#define XLLM_DTYPE_E4M3 3

namespace xllm {

constexpr int kThreads = 128;  // 4 warps per block in every kernel here
constexpr int kTile = 64;      // KV tokens per shared-memory tile
// Rows of a K/V tile in shared memory are padded by 2 elements: threads
// that read the same column of different rows then hit different banks
// (odd 32-bit word stride for bf16 pairs, conflict-free 64-bit half-warps
// for f32 pairs).
constexpr int kPad = 2;

// One byte of a float8_e4m3fn cache (a tag type: its conversions are the
// helpers below, never implicit).
struct e4m3 {
  uint8_t bits;
};

// Quantized (1-byte) caches are read through bf16 tiles: int8 codes and
// e4m3 values are exact in bf16 (the TPU kernels' _mxu upcast).
template <typename C>
struct TileOf {
  using type = C;
};
template <>
struct TileOf<int8_t> {
  using type = __nv_bfloat16;
};
template <>
struct TileOf<e4m3> {
  using type = __nv_bfloat16;
};
template <typename C>
constexpr bool kQuantCache = sizeof(C) == 1;
// P is rounded to bf16 wherever the V tile is bf16: every cache but f32
template <typename C>
constexpr bool kRoundP = sizeof(typename TileOf<C>::type) == 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two values -> two e4m3 bytes (a in the low byte) with the JAX package's
// bytes, through the hardware's paired cast: cvt.rn.satfinite.e4m3x2.f32
// rounds to nearest even and clamps to +-448 (PTX converts to e4m3 only
// with .satfinite; the NOSAT form is a software sequence), then a
// select writes the NaN byte 0x7f with the sign of x where the JAX
// package's cast gives NaN: a magnitude above 464, infinities and NaN
// inputs. ops/cuda/kv_write.e4m3_pair_model is this in PyTorch.
__device__ __forceinline__ uint32_t e4m3_jax_byte(float x, uint32_t sat) {
  return fabsf(x) <= 464.f ? sat : (signbit(x) ? 0xffu : 0x7fu);  // NaN fails <=
}
__device__ __forceinline__ uint32_t to_e4m3x2(float a, float b) {
  const uint32_t v = __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE, __NV_E4M3);
  return e4m3_jax_byte(a, v & 0xffu) | e4m3_jax_byte(b, (v >> 8) & 0xffu) << 8;
}

// A 1-byte cache value as the walk reads it (exact in bf16 and f32)
__device__ __forceinline__ float cache_to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float cache_to_float(e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.bits, __NV_E4M3)));
}

// P rounded to bf16 before P.V, as the TPU kernels do on bf16 and
// quantized caches (their P is cast to the dtype of the upcast V tile)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// two 1-byte cache values (low byte first) -> two bf16 (low half first)
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <typename C>
__device__ __forceinline__ uint32_t upcast2(uint32_t two);
template <>
__device__ __forceinline__ uint32_t upcast2<int8_t>(uint32_t two) {
  return bf16x2_bits((float)(int8_t)(two & 0xffu), (float)(int8_t)((two >> 8) & 0xffu));
}
template <>
__device__ __forceinline__ uint32_t upcast2<e4m3>(uint32_t two) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return bf16x2_bits(f.x, f.y);
}

// 16 one-byte values -> 16 bf16 at dst (4-byte aligned)
template <typename C>
__device__ __forceinline__ void upcast16(__nv_bfloat16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[2 * i] = upcast2<C>(w[i]);
    d[2 * i + 1] = upcast2<C>(w[i] >> 16);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// two consecutive elements starting at an even index, as float2
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Running maxima for P rounded against a walk's maximum after each "page"
// (K1 and its variants: the TPU kernel's tile of G pages; K3, K11: a
// page) when a block does not walk from position 0 (context splits) or a
// page is longer than its tile: a first pass writes each row's maximum
// per granule of gcd(page, tile) positions, and the walk reads them back.
// Granules of a row that the tile of `tile` positions at t0 needs: its
// own and, for a page longer than the tile, the rest of that page's (at
// most 32).
__device__ __forceinline__ int tile_granules(int t0, int tile, int bs, int gran, int gend) {
  return min(((t0 + tile - 1) / bs + 1) * bs / gran, gend) - t0 / gran;
}
// One warp's view of a row's running maxima over that tile: lane k holds
// the maximum of mrun (the granules before the tile) and the row's
// granules t0 / gran .. t0 / gran + k, read one a lane from gt (the row's
// granule t0 / gran first); a key at pos then takes lane page_lane(pos),
// the last granule of its page.
__device__ __forceinline__ float granule_prefix(const float* gt, float mrun, int t0,
                                                int tile, int bs, int gran, int gend,
                                                int lane) {
  const int ng = tile_granules(t0, tile, bs, gran, gend);
  float pre = lane < ng ? gt[lane] : -INFINITY;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float x = __shfl_up_sync(0xffffffffu, pre, o);
    if (lane >= o) pre = fmaxf(pre, x);
  }
  return fmaxf(pre, mrun);
}
__device__ __forceinline__ int page_lane(int t0, int pos, int bs, int gran, int gend) {
  return min((pos / bs + 1) * bs / gran, gend) - t0 / gran - 1;
}
// the lane holding the maximum over the tile's own granules (the running
// maximum before the next tile)
__device__ __forceinline__ int tile_lane(int t0, int tile, int gran, int gend) {
  return min((t0 + tile) / gran, gend) - t0 / gran - 1;
}

// The walk's own running maxima when a tile holds whole pages of bs <= 32
// CPL keys: each key's page maximum and the maxima of the tile's pages
// before it (v[u] at column lane + 32 u, -inf where not visible) ->
// mk[u]; the caller adds the maximum before the tile.
template <int CPL>
__device__ __forceinline__ void walk_page_maxima(const float (&v)[CPL], float (&mk)[CPL],
                                                 int bs, int lane) {
  const int seg = bs < 32 ? bs : 32;
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    mk[u] = v[u];
    for (int o = seg / 2; o > 0; o >>= 1)
      mk[u] = fmaxf(mk[u], __shfl_xor_sync(0xffffffffu, mk[u], o));
  }
  if (bs > 32) {  // a page spans both halves of the 64 keys
    if constexpr (CPL == 2) mk[0] = mk[1] = fmaxf(mk[0], mk[1]);
    return;
  }
#pragma unroll
  for (int u = 0; u < CPL; ++u)
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_up_sync(0xffffffffu, mk[u], o);
      if (lane >= o) mk[u] = fmaxf(mk[u], x);
    }
  if constexpr (CPL == 2) mk[1] = fmaxf(mk[1], __shfl_sync(0xffffffffu, mk[0], 31));
}

// Granule maxima of one row's tile of 32 * CPL scores (v[u] at column
// lane + 32 u, -inf where not visible), a warp a row: lanes whose column
// starts a granule write its maximum to gr[t0 / gran + ...].
template <int CPL>
__device__ __forceinline__ void write_granules(float* gr, const float (&v)[CPL], int t0,
                                               int gran, int lane) {
  float m[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) m[u] = v[u];
  const int seg = gran < 32 ? gran : 32;
#pragma unroll
  for (int u = 0; u < CPL; ++u)
    for (int o = seg / 2; o > 0; o >>= 1) m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], o));
  if (gran <= 32) {
    if (lane % gran == 0)
#pragma unroll
      for (int u = 0; u < CPL; ++u) gr[(t0 + 32 * u + lane) / gran] = m[u];
  } else if constexpr (CPL >= 2) {  // gran spans 32-column halves: 64 = the tile
    if (lane == 0)
#pragma unroll
      for (int u = 0; u + 1 < CPL; u += 2) gr[(t0 + 32 * u) / gran] = fmaxf(m[u], m[u + 1]);
  }
}

__host__ __device__ __forceinline__ size_t cache_row(int layer, int num_blocks,
                                                     int hkv, int bs, int blk,
                                                     int h, int off, int d) {
  return ((((size_t)layer * num_blocks + blk) * hkv + h) * bs + off) * d;
}

// Where a page's rows live. A (layer, block) page starts `page` elements
// after the previous one: Hkv * bs * D in the split arrays (K and V in two
// arrays), 2 * Hkv * bs * D in the interleaved array, whose V pointer is
// its K pointer plus Hkv * bs * D. Canonical rows: head h of slot w at
// (h * bs + w) * D in the page. Positions >= tail_from (K9: a sequence's
// incomplete last page, whose first position is a multiple of bs) sit in
// token-major content: slot w's row at w * 2 * Hkv * D holds the token's K
// heads, then its V heads, so V is read from the K pointer.
struct PageLayout {
  long long page;  // elements from one (layer, block) page to the next
  int tail_from;   // first token-major position of the sequence (INT_MAX: none)
};

// The K and V rows (D elements each) of kv head h at position pos in block blk.
template <typename T>
__device__ __forceinline__ void kv_rows(const PageLayout& lay, T* k_cache, T* v_cache,
                                        int layer, int num_blocks, int hkv, int bs, int d,
                                        int blk, int h, int pos, T*& krow, T*& vrow) {
  const size_t pb = ((size_t)layer * num_blocks + blk) * lay.page;
  const int w = pos % bs;
  if (pos >= lay.tail_from) {
    krow = k_cache + pb + ((size_t)w * 2 * hkv + h) * d;
    vrow = krow + (size_t)hkv * d;
  } else {
    const size_t o = pb + ((size_t)h * bs + w) * d;
    krow = k_cache + o;
    vrow = v_cache + o;
  }
}

// Loads the K and V rows of kv head `h` for positions t0 + [jlo, jhi) into
// padded shared tiles ks/vs (row j at j * (D + kPad)). Positions map to
// pages through the sequence's block-table row, rows to addresses through
// `lay`. 16-byte global loads, 4-byte shared stores (padded rows are
// 4-byte aligned only). Plain loads, not the read-only path: the decode
// kernel reads a row it wrote itself. kV false loads the K rows only (vs
// untouched).
template <typename T, int D, bool kV = true>
__device__ __forceinline__ void load_kv_tile(T* ks, T* vs, const T* k_cache,
                                             const T* v_cache, const PageLayout& lay,
                                             const int* bt_row, int layer,
                                             int num_blocks, int hkv, int h,
                                             int bs, int t0, int jlo,
                                             int jhi) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kVec;
  const int n = (jhi - jlo) * kChunks;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = jlo + idx / kChunks;
    const int c = idx % kChunks;
    const int pos = t0 + j;
    const T *krow, *vrow;
    kv_rows(lay, k_cache, v_cache, layer, num_blocks, hkv, bs, D, bt_row[pos / bs], h,
            pos, krow, vrow);
    const uint4 kv = *reinterpret_cast<const uint4*>(krow + c * kVec);
    uint32_t* kd = reinterpret_cast<uint32_t*>(ks + j * (D + kPad) + c * kVec);
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    if constexpr (kV) {
      const uint4 vv = *reinterpret_cast<const uint4*>(vrow + c * kVec);
      uint32_t* vd = reinterpret_cast<uint32_t*>(vs + j * (D + kPad) + c * kVec);
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
  }
}

// The same for a 1-byte cache C (int8 or e4m3): 16 values per 16-byte
// load, upcast to bf16 on their way into the padded bf16 tiles.
template <typename C, int D, bool kV = true>
__device__ __forceinline__ void load_kv_tile_upcast(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                                    const C* k_cache, const C* v_cache,
                                                    const PageLayout& lay,
                                                    const int* bt_row, int layer,
                                                    int num_blocks, int hkv, int h,
                                                    int bs, int t0, int jlo, int jhi) {
  constexpr int kVec = 16;
  constexpr int kChunks = D / kVec;
  const int n = (jhi - jlo) * kChunks;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = jlo + idx / kChunks;
    const int c = idx % kChunks;
    const int pos = t0 + j;
    const C *krow, *vrow;
    kv_rows(lay, k_cache, v_cache, layer, num_blocks, hkv, bs, D, bt_row[pos / bs], h,
            pos, krow, vrow);
    upcast16<C>(ks + j * (D + kPad) + c * kVec,
                *reinterpret_cast<const uint4*>(krow + c * kVec));
    if constexpr (kV)
      upcast16<C>(vs + j * (D + kPad) + c * kVec,
                  *reinterpret_cast<const uint4*>(vrow + c * kVec));
  }
}

// Either loader, by the cache type: S is the tile type (TileOf<C>::type).
template <typename C, int D, bool kV = true>
__device__ __forceinline__ void load_tile(typename TileOf<C>::type* ks,
                                          typename TileOf<C>::type* vs,
                                          const C* k_cache, const C* v_cache,
                                          const PageLayout& lay, const int* bt_row,
                                          int layer, int num_blocks, int hkv, int h, int bs,
                                          int t0, int jlo, int jhi) {
  if constexpr (kQuantCache<C>)
    load_kv_tile_upcast<C, D, kV>(ks, vs, k_cache, v_cache, lay, bt_row, layer,
                                  num_blocks, hkv, h, bs, t0, jlo, jhi);
  else
    load_kv_tile<C, D, kV>(ks, vs, k_cache, v_cache, lay, bt_row, layer, num_blocks, hkv,
                           h, bs, t0, jlo, jhi);
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks (K10, K11): cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_size = ok ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4 bytes (a granule maximum); !ok leaves 0 (never read)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_size = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_size));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g + 8, 2t..),
// a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t..2t+1, n g), b1 (k 2t + 8..,
// n g); d0, d1 (g, 2t..2t+1), d2, d3 (g + 8, 2t..2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kSmemMax = 232448;  // an H100 block's dynamic shared memory (227 KB)

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// allow_smem once per device (a launch function keeps one of these static
// for its kernel): the attribute stays set, and setting it costs host time
// at every launch
struct AllowSmemOnce {
  bool done[64] = {};
  template <typename K>
  cudaError_t operator()(K kernel, size_t bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
    err = allow_smem(kernel, bytes);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
    return err;
  }
};

}  // namespace xllm

extern "C" const char* xllm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
