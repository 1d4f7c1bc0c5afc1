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
//
// K8 and K9: the same row scatter writes the interleaved cache [L, NB, 2,
// Hkv, bs, D] (another page stride, V Hkv * bs * D after K), under two more
// contracts of ops/cuda/kv_write.py: kv_write_prefill_batched_ilv_tpu and
// kv_write_rmw_batched_ilv_tpu (K8: K2 and K4 there); and, with rm set and
// the chunks' kv_lens, kv_write_prefill_batched_rm_tpu (K9,
// kv_layout="interleaved_rm"): a row whose page the sequence completes
// ((page + 1) * bs <= kv_len) goes canonical, a row of the sequence's final
// incomplete page token-major, to row w of the page seen as [bs, 2 * Hkv,
// D] (K heads, then V heads). The chunk starts on a page boundary, so a
// page it completes holds only its own rows. The TPU kernels move whole
// pages and so also copy the chunk's bucket-padding rows into its last
// page; nothing reads them, and here only the valid rows are written.
//
// K9's RMW writer (kv_write_rmw_batched_rm_tpu, kv_write_rmw_rm_kernel
// below) is a kernel of its own: a chunk of at most bs rows may complete a
// page whose earlier rows sit token-major, and the whole page is then
// rewritten canonical. The blocks of a (chunk, page) -- at most two pages
// a chunk -- take their page, so no two chunks touch one page; a first
// launch stages the page's earlier rows in a scratch page of the chunk's
// own, a second writes every row of the page canonical: the stream orders
// the reads of the old rows before any write over them.
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
                         C* k_cache, C* v_cache,  // PageLayout (common.cuh)
                         const int* __restrict__ block_tables,  // [P, nbmax]
                         const int* __restrict__ q_offsets,     // [P]
                         const int* __restrict__ ntoks,         // [P]
                         const int* __restrict__ kv_lens,       // [P] (rm only)
                         int layer, int num_blocks, int hkv, int bs, int head_dim,
                         int nbmax, int require_aligned, long long page, int rm) {
  const int p = blockIdx.x, j = blockIdx.y;
  if (j >= ntoks[p]) return;  // padding of the chunk (or a padded row)
  const int q_offset = q_offsets[p];
  if (require_aligned) {
    // full-page writer contract: chunks start on a page boundary
    assert(q_offset % bs == 0);
  }
  const int pos = q_offset + j;
  const int blk = block_tables[(size_t)p * nbmax + pos / bs];
  // K9: a row of a page the sequence does not complete goes token-major
  const PageLayout lay{page, rm && (pos / bs + 1) * bs > kv_lens[p] ? 0 : INT_MAX};
  const size_t src0 = (size_t)p * stride_p + (size_t)j * stride_s;
  for (int i = threadIdx.x; i < hkv * head_dim; i += blockDim.x) {
    const int h = i / head_dim, d = i % head_dim;
    const size_t src = src0 + (size_t)h * stride_h + d;
    C *kr, *vr;
    kv_rows(lay, k_cache, v_cache, layer, num_blocks, hkv, bs, head_dim, blk, h, pos, kr,
            vr);
    kr[d] = as_cache<C>(k_src[src]);
    vr[d] = as_cache<C>(v_src[src]);
  }
}

// K9's RMW writer (the head of this file), two launches of one kernel on
// the stream: blocks (p, k, y) share the chunk's first (k = 0) or last (k =
// 1) page, kRmwSplit of them. Phase 0: a page the sequence does not
// complete takes the chunk's rows token-major; of a page it completes, the
// rows before the chunk (token-major, the first page's q_offset % bs) are
// staged in scratch[p]. Phase 1, once every block of phase 0 has ended:
// every row of a completed page goes to its canonical place, from scratch
// or from the chunk. The page moves in 16-byte units, each a piece of one
// head's D-vector.
constexpr int kRmwThreads = 256;
constexpr int kRmwSplit = 8;

template <typename S, typename C>
__global__ void __launch_bounds__(kRmwThreads)
    kv_write_rmw_rm_kernel(const S* __restrict__ k_src, const S* __restrict__ v_src,
                           long long stride_p, long long stride_s,
                           long long stride_h,  // element strides; d is unit
                           C* cache,            // [L, NB, 2, Hkv, bs, D]
                           const int* __restrict__ block_tables,  // [P, nbmax]
                           const int* __restrict__ q_offsets,     // [P]
                           const int* __restrict__ ntoks,         // [P]
                           const int* __restrict__ kv_lens,       // [P]
                           C* scratch,                            // [P, page]
                           int layer, int num_blocks, int hkv, int bs, int head_dim,
                           int nbmax, int phase) {
  constexpr int kVec = 16 / sizeof(C);  // cache elements per 16-byte unit
  const int p = blockIdx.x, k = blockIdx.y;
  const int ntok = ntoks[p];
  if (ntok <= 0) return;
  const int q_offset = q_offsets[p];
  const int first = q_offset / bs, last = (q_offset + ntok - 1) / bs;
  if (k == 1 && last == first) return;
  const int pg = k ? last : first;
  const bool complete = (pg + 1) * bs <= kv_lens[p];
  const size_t page = (size_t)2 * hkv * bs * head_dim;
  uint4* dst = reinterpret_cast<uint4*>(
      cache + ((size_t)layer * num_blocks + block_tables[(size_t)p * nbmax + pg]) * page);
  uint4* st = reinterpret_cast<uint4*>(scratch + (size_t)p * page);
  const int w0 = max(q_offset - pg * bs, 0);          // the chunk's first row here
  const int w1 = min(q_offset + ntok - pg * bs, bs);  // and its end
  const int units = head_dim / kVec;                  // units of a head's D-vector
  const int row = 2 * hkv * units;                    // units of a token-major row
  const int i0 = blockIdx.z * blockDim.x + threadIdx.x, step = gridDim.z * blockDim.x;
  // unit u of head c (K heads, then V heads) of the page's row w, from the chunk
  auto src = [&](int w, int c, int u) -> uint4 {
    const S* x = (c < hkv ? k_src + (size_t)c * stride_h : v_src + (size_t)(c - hkv) * stride_h) +
                 (size_t)p * stride_p + (size_t)(pg * bs + w - q_offset) * stride_s + u * kVec;
    alignas(16) C vals[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) vals[e] = as_cache<C>(x[e]);
    return *reinterpret_cast<const uint4*>(vals);
  };
  if (phase == 0 && !complete) {  // the rows token-major
    for (int i = i0; i < (w1 - w0) * row; i += step) {
      const int w = w0 + i / row, c = i % row / units, u = i % units;
      dst[(size_t)w * row + c * units + u] = src(w, c, u);
    }
  } else if (phase == 0) {  // stage the rows before the chunk
    for (int i = i0; i < w0 * row; i += step) st[i] = dst[i];
  } else if (complete) {  // the whole page canonical
    for (int i = i0; i < bs * row; i += step) {
      const int c = i / (bs * units), w = i / units % bs, u = i % units;
      dst[i] = w < w0 ? st[(size_t)w * row + c * units + u] : src(w, c, u);
    }
  }
}

template <typename S, typename C>
cudaError_t launch_rows(const void* k_src, const void* v_src, long long sp,
                        long long ss, long long sh, void* k_cache, void* v_cache,
                        const int* block_tables, const int* q_offsets,
                        const int* ntoks, const int* kv_lens, int p, int s, int layer,
                        int num_blocks, int hkv, int bs, int head_dim, int nbmax,
                        int require_aligned, long long page, int rm,
                        cudaStream_t stream) {
  kv_write_rows_kernel<S, C><<<dim3(p, s), kThreads, 0, stream>>>(
      static_cast<const S*>(k_src), static_cast<const S*>(v_src), sp, ss, sh,
      static_cast<C*>(k_cache), static_cast<C*>(v_cache), block_tables,
      q_offsets, ntoks, kv_lens, layer, num_blocks, hkv, bs, head_dim, nbmax,
      require_aligned, page, rm);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_rmw_rm(const void* k_src, const void* v_src, long long sp,
                          long long ss, long long sh, void* cache, const int* block_tables,
                          const int* q_offsets, const int* ntoks, const int* kv_lens,
                          void* scratch, int p, int layer, int num_blocks, int hkv, int bs,
                          int head_dim, int nbmax, cudaStream_t stream) {
  for (int phase = 0; phase < 2; ++phase) {
    kv_write_rmw_rm_kernel<S, C><<<dim3(p, 2, kRmwSplit), kRmwThreads, 0, stream>>>(
        static_cast<const S*>(k_src), static_cast<const S*>(v_src), sp, ss, sh,
        static_cast<C*>(cache), block_tables, q_offsets, ntoks, kv_lens,
        static_cast<C*>(scratch), layer, num_blocks, hkv, bs, head_dim, nbmax, phase);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
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

// page: elements from one (layer, block) page to the next (PageLayout);
// rm: K9's row-major tails, by kv_lens (else kv_lens is unused)
extern "C" int xllm_kv_write_rows(int device, const void* k_src,
                                  const void* v_src, long long stride_p,
                                  long long stride_s, long long stride_h,
                                  void* k_cache, void* v_cache,
                                  const void* block_tables, const void* q_offsets,
                                  const void* ntoks, const void* kv_lens, int src_dtype,
                                  int dtype, int p, int s, int layer, int num_blocks,
                                  int hkv, int bs, int head_dim, int nbmax,
                                  int require_aligned, long long page, int rm,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (page < (long long)hkv * bs * head_dim || (rm && !kv_lens))
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* nt = static_cast<const int*>(ntoks);
  const int* kl = static_cast<const int*>(kv_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XLLM_ROWS(S, C)                                                            \
  return (int)xllm::launch_rows<S, C>(k_src, v_src, stride_p, stride_s, stride_h, \
                                      k_cache, v_cache, bt, qo, nt, kl, p, s,     \
                                      layer, num_blocks, hkv, bs, head_dim,       \
                                      nbmax, require_aligned, page, rm, st);
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

// K9's RMW writer: cache [L, NB, 2, Hkv, bs, D]; scratch [P, 2 * Hkv * bs * D]
// in the cache dtype
extern "C" int xllm_kv_write_rmw_rm(int device, const void* k_src, const void* v_src,
                                    long long stride_p, long long stride_s,
                                    long long stride_h, void* cache,
                                    const void* block_tables, const void* q_offsets,
                                    const void* ntoks, const void* kv_lens, void* scratch,
                                    int src_dtype, int dtype, int p, int s, int layer,
                                    int num_blocks, int hkv, int bs, int head_dim,
                                    int nbmax, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (s > bs) return (int)cudaErrorInvalidValue;  // at most two pages a chunk
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* nt = static_cast<const int*>(ntoks);
  const int* kl = static_cast<const int*>(kv_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XLLM_RMW(S, C)                                                                 \
  return (int)xllm::launch_rmw_rm<S, C>(k_src, v_src, stride_p, stride_s, stride_h,   \
                                        cache, bt, qo, nt, kl, scratch, p, layer,     \
                                        num_blocks, hkv, bs, head_dim, nbmax, st);
  if (src_dtype == dtype) {  // a copy (of bytes, for a 1-byte cache)
    if (dtype == XLLM_DTYPE_BF16) { XLLM_RMW(__nv_bfloat16, __nv_bfloat16) }
    if (dtype == XLLM_DTYPE_F32) { XLLM_RMW(float, float) }
    if (dtype == XLLM_DTYPE_I8 || dtype == XLLM_DTYPE_E4M3) { XLLM_RMW(uint8_t, uint8_t) }
  }
  if (dtype == XLLM_DTYPE_E4M3) {  // the e4m3 cast of a bf16 / f32 row
    if (src_dtype == XLLM_DTYPE_BF16) { XLLM_RMW(__nv_bfloat16, xllm::e4m3) }
    if (src_dtype == XLLM_DTYPE_F32) { XLLM_RMW(float, xllm::e4m3) }
  }
#undef XLLM_RMW
  return (int)cudaErrorInvalidValue;
}
