// K2 + K4: batched paged KV-cache writers for prefill chunks (and, below,
// K11c + K11d, their latent-cache twins for the MLA families).
//
// Replaces two Pallas kernels of xllm_tpu/ops/pallas/kv_write.py with one
// row scatter behind two wrappers (ops/cuda/kv_write.py), each with its own
// launch counter:
//   K2 kv_write_prefill_batched_tpu: P head-major chunks [P, Hkv, S, D]
//      from page-aligned q_offsets (the scheduler's invariant, asserted
//      here per row);
//   K4 kv_write_rmw_batched_tpu: P token-major chunks [P, S, Hkv, D],
//      S <= block_size, at any alignment (they may start mid-page).
// The TPU needed two kernels because its DMAs move whole tiles: K2 writes
// full pages (clobbering the never-read slots of the tail page) and K4
// reads, patches and writes back at most two pages. The card writes any
// row directly, so one kernel serves both contracts and writes exactly the
// ntok valid rows of each chunk (ntok = 0 marks a padded row) and nothing
// else. The source layout reaches the kernel as element strides, so the
// head-major view costs no transpose copy. Launched with one chunk (P = 1),
// the same kernels are the single-chunk writers kv_write_prefill_tpu (K2b),
// kv_write_rmw_tpu (K4b), latent_write_prefill_tpu (K11f) and
// latent_write_rmw_tpu (K11g), each counted apart by ops/cuda/kv_write.py.
//
// Quantized caches: int8 codes arrive as int8 and are copied as bytes; bf16
// or f32 rows bound for an e4m3 cache are cast here, element by element,
// with to_cache (the JAX package's bytes, as K1 writes its new row), so the
// rows are read once in their own dtype and no cast runs before the launch.
//
// What bounds it: bytes (read each new row once, write it once; no math).
// One block per (chunk, token) copies the token's Hkv x D rows of K and V;
// neighbouring threads move neighbouring elements of one head row, so
// both the read and the write are coalesced.
#include <cassert>
#include <type_traits>

#include "common.cuh"

namespace xllm {

// A source element in the cache dtype C: a copy, or the e4m3 cast.
template <typename C, typename S>
__device__ __forceinline__ C as_cache(S x) {
  if constexpr (std::is_same_v<S, C>)
    return x;
  else
    return to_cache<C>(to_float(x));
}

template <typename S, typename C>
__global__ void __launch_bounds__(kThreads)
    kv_write_rows_kernel(const S* __restrict__ k_src, const S* __restrict__ v_src,
                         long long stride_p, long long stride_s,
                         long long stride_h,  // element strides; d is unit
                         C* k_cache, C* v_cache,  // [L, NB, Hkv, bs, D]
                         const int* __restrict__ block_tables,  // [P, nbmax]
                         const int* __restrict__ q_offsets,     // [P]
                         const int* __restrict__ ntoks,         // [P]
                         int layer, int num_blocks, int hkv, int bs, int head_dim,
                         int nbmax, int require_aligned) {
  const int p = blockIdx.x, j = blockIdx.y;
  if (j >= ntoks[p]) return;  // padding of the chunk (or a padded row)
  const int q_offset = q_offsets[p];
  if (require_aligned) {
    // full-page writer contract: chunks start on a page boundary
    assert(q_offset % bs == 0);
  }
  const int pos = q_offset + j;
  const int blk = block_tables[(size_t)p * nbmax + pos / bs];
  const size_t src0 = (size_t)p * stride_p + (size_t)j * stride_s;
  for (int i = threadIdx.x; i < hkv * head_dim; i += blockDim.x) {
    const int h = i / head_dim, d = i % head_dim;
    const size_t src = src0 + (size_t)h * stride_h + d;
    const size_t dst = cache_row(layer, num_blocks, hkv, bs, blk, h, pos % bs,
                                 head_dim) + d;
    k_cache[dst] = as_cache<C>(k_src[src]);
    v_cache[dst] = as_cache<C>(v_src[src]);
  }
}

template <typename S, typename C>
cudaError_t launch_rows(const void* k_src, const void* v_src, long long sp,
                        long long ss, long long sh, void* k_cache, void* v_cache,
                        const int* block_tables, const int* q_offsets,
                        const int* ntoks, int p, int s, int layer, int num_blocks,
                        int hkv, int bs, int head_dim, int nbmax,
                        int require_aligned, cudaStream_t stream) {
  kv_write_rows_kernel<S, C><<<dim3(p, s), kThreads, 0, stream>>>(
      static_cast<const S*>(k_src), static_cast<const S*>(v_src), sp, ss, sh,
      static_cast<C*>(k_cache), static_cast<C*>(v_cache), block_tables,
      q_offsets, ntoks, layer, num_blocks, hkv, bs, head_dim, nbmax,
      require_aligned);
  return cudaGetLastError();
}

// K11c + K11d: the latent (MLA) writers. The same row scatter into the
// single-head cache [L, NB, 1, bs, Dk]: one block per (chunk, token) copies
// one Dk-wide row. They replace latent_write_prefill_batched_tpu (K11c,
// page-aligned chunks; the TPU kernel moves whole pages and fills the
// never-read tail of the last one with padding) and
// latent_write_rmw_batched_tpu (K11d, S <= block_size at any alignment,
// read-patch-write of at most two pages). Here exactly the ntok valid rows
// of each chunk are written. Bound: bytes. An e4m3 latent cache takes bf16
// or f32 rows cast here with to_cache, as the K2 / K4 rows.
template <typename S, typename C>
__global__ void __launch_bounds__(kThreads)
    latent_write_rows_kernel(const S* __restrict__ src, long long stride_p,
                             long long stride_s,  // element strides; Dk is unit
                             C* cache,            // [L, NB, 1, bs, Dk]
                             const int* __restrict__ block_tables,  // [P, nbmax]
                             const int* __restrict__ q_offsets,     // [P]
                             const int* __restrict__ ntoks,         // [P]
                             int layer, int num_blocks, int bs, int dk, int nbmax,
                             int require_aligned) {
  const int p = blockIdx.x, j = blockIdx.y;
  if (j >= ntoks[p]) return;
  const int q_offset = q_offsets[p];
  if (require_aligned) assert(q_offset % bs == 0);
  const int pos = q_offset + j;
  const int blk = block_tables[(size_t)p * nbmax + pos / bs];
  const S* s = src + (size_t)p * stride_p + (size_t)j * stride_s;
  C* d = cache + cache_row(layer, num_blocks, 1, bs, blk, 0, pos % bs, dk);
  for (int i = threadIdx.x; i < dk; i += blockDim.x) d[i] = as_cache<C>(s[i]);
}

template <typename S, typename C>
cudaError_t launch_latent_rows(const void* src, long long sp, long long ss,
                               void* cache, const int* block_tables,
                               const int* q_offsets, const int* ntoks, int p, int s,
                               int layer, int num_blocks, int bs, int dk, int nbmax,
                               int require_aligned, cudaStream_t stream) {
  latent_write_rows_kernel<S, C><<<dim3(p, s), kThreads, 0, stream>>>(
      static_cast<const S*>(src), sp, ss, static_cast<C*>(cache), block_tables,
      q_offsets, ntoks, layer, num_blocks, bs, dk, nbmax, require_aligned);
  return cudaGetLastError();
}

}  // namespace xllm

extern "C" int xllm_latent_write_rows(int device, const void* src, long long stride_p,
                                      long long stride_s, void* cache,
                                      const void* block_tables, const void* q_offsets,
                                      const void* ntoks, int src_dtype, int dtype, int p,
                                      int s, int layer, int num_blocks, int bs, int dk,
                                      int nbmax, int require_aligned, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (s > 65535) return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* nt = static_cast<const int*>(ntoks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XLLM_ROWS(S, C)                                                               \
  return (int)xllm::launch_latent_rows<S, C>(src, stride_p, stride_s, cache, bt, qo, \
                                             nt, p, s, layer, num_blocks, bs, dk,    \
                                             nbmax, require_aligned, st);
  if (src_dtype == dtype) {  // a copy (of bytes, for an e4m3 cache)
    if (dtype == XLLM_DTYPE_BF16) { XLLM_ROWS(__nv_bfloat16, __nv_bfloat16) }
    if (dtype == XLLM_DTYPE_F32) { XLLM_ROWS(float, float) }
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_ROWS(uint8_t, uint8_t) }
  }
  if (dtype == XLLM_DTYPE_E4M3) {  // the e4m3 cast of a bf16 / f32 row
    if (src_dtype == XLLM_DTYPE_BF16) { XLLM_ROWS(__nv_bfloat16, xllm::e4m3) }
    if (src_dtype == XLLM_DTYPE_F32) { XLLM_ROWS(float, xllm::e4m3) }
  }
#undef XLLM_ROWS
  return (int)cudaErrorInvalidValue;
}

extern "C" int xllm_kv_write_rows(int device, const void* k_src,
                                  const void* v_src, long long stride_p,
                                  long long stride_s, long long stride_h,
                                  void* k_cache, void* v_cache,
                                  const void* block_tables, const void* q_offsets,
                                  const void* ntoks, int src_dtype, int dtype, int p,
                                  int s, int layer, int num_blocks, int hkv, int bs,
                                  int head_dim, int nbmax, int require_aligned,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* nt = static_cast<const int*>(ntoks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XLLM_ROWS(S, C)                                                            \
  return (int)xllm::launch_rows<S, C>(k_src, v_src, stride_p, stride_s, stride_h, \
                                      k_cache, v_cache, bt, qo, nt, p, s, layer,  \
                                      num_blocks, hkv, bs, head_dim, nbmax,       \
                                      require_aligned, st);
  if (src_dtype == dtype) {  // a copy (of bytes, for a 1-byte cache)
    if (dtype == XLLM_DTYPE_BF16) { XLLM_ROWS(__nv_bfloat16, __nv_bfloat16) }
    if (dtype == XLLM_DTYPE_F32) { XLLM_ROWS(float, float) }
    if (dtype == XLLM_DTYPE_I8 || dtype == XLLM_DTYPE_E4M3) { XLLM_ROWS(uint8_t, uint8_t) }
  }
  if (dtype == XLLM_DTYPE_E4M3) {  // the e4m3 cast of a bf16 / f32 row
    if (src_dtype == XLLM_DTYPE_BF16) { XLLM_ROWS(__nv_bfloat16, xllm::e4m3) }
    if (src_dtype == XLLM_DTYPE_F32) { XLLM_ROWS(float, xllm::e4m3) }
  }
#undef XLLM_ROWS
  return (int)cudaErrorInvalidValue;
}
