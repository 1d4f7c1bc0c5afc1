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
// or f32 rows bound for an e4m3 cache are cast here, 16 values a unit
// through the hardware's paired cast (to_e4m3x2: the JAX package's bytes,
// as K1 writes its new row), so the rows are read once in their own dtype
// and no cast runs before the launch.
//
// What bounds it: bytes (read each new row once, write it once; no math),
// and at the served shapes (a few MB at most) a launch's fixed cost. The
// row scatter (kv_write_rows_kernel) gives each (chunk, token) one warp, or
// up to a few when tokens are few (~4,096 warps a launch, each with 32 or
// more units): the page is looked up once a warp, and the token's 2 Hkv
// rows (K heads, then V heads) move in whole 16-byte destination units (a
// copy, or 16 values cast in pairs: cache_unit), kUnroll units a lane with
// their loads in flight before their stores; on rows that start on 16-byte
// boundaries a unit's load needs no page and overlaps the lookup. A row
// whose bytes do not start or end on a 16-byte boundary writes the values
// before its first unit and after its last one by one (the partition:
// ops/cuda/kv_write.unit_partition), and a unit whose source is not 16-byte
// aligned gathers its values one by one, so every row width and source
// stride that worked element by element still works.
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
// rewritten canonical. One launch: a thread-block cluster per (chunk,
// page) -- at most two pages a chunk, no two chunks on one page -- whose
// blocks each stage, in their own shared memory, the earlier rows of their
// share of the canonical page, meet at a cluster barrier (in place of a
// launch boundary: every old row is read before any is overwritten), then
// write their share. No global scratch. An e4m3 cache takes its rows
// through the paired hardware cast (to_e4m3x2), 16 values a unit.
#include <cassert>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace xllm {

// 16 bytes of cache values from the 16 / sizeof(C) source values at x
// (16-byte aligned): a copy, or the e4m3 cast in pairs
template <typename S, typename C>
__device__ __forceinline__ uint4 cache_unit(const S* x) {
  if constexpr (sizeof(S) == sizeof(C)) {
    return *reinterpret_cast<const uint4*>(x);
  } else {
    float f[16];
    if constexpr (std::is_same_v<S, float>) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(x)[i];
        f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z, f[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(x)[i];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          f[8 * i + 2 * j] = t.x, f[8 * i + 2 * j + 1] = t.y;
        }
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = to_e4m3x2(f[4 * i], f[4 * i + 1]) | to_e4m3x2(f[4 * i + 2], f[4 * i + 3]) << 16;
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// the same from values that need not be 16-byte aligned, one by one
template <typename S, typename C>
__device__ __forceinline__ uint4 cache_unit_gather(const S* x) {
  uint4 v;
  if constexpr (sizeof(S) == sizeof(C)) {
    S* d = reinterpret_cast<S*>(&v);
#pragma unroll
    for (int k = 0; k < 16 / (int)sizeof(S); ++k) d[k] = x[k];
  } else {
    uint32_t* d = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = to_e4m3x2(to_float(x[4 * k]), to_float(x[4 * k + 1])) |
             to_e4m3x2(to_float(x[4 * k + 2]), to_float(x[4 * k + 3])) << 16;
  }
  return v;
}

// one source value as the cache stores it
template <typename S, typename C>
__device__ __forceinline__ C cache_value(S x) {
  if constexpr (sizeof(S) == sizeof(C))
    return x;
  else
    return C{static_cast<uint8_t>(to_e4m3x2(to_float(x), 0.f) & 0xffu)};
}

constexpr int kRowWarps = 4;  // warps a block of the row scatter
constexpr int kUnroll = 4;    // units a lane loads before it stores them
constexpr int kRowTarget = 4096;  // warps a launch aims at: ~31 an SM, loads in flight

// Values of a row of `width` at `row` before its first 16-byte unit
template <typename C>
__device__ __forceinline__ int unit_head(const C* row, int width) {
  const int head = (int)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / (int)sizeof(C);
  return head < width ? head : width;
}

// The row scatter (the head of this file): `parts` warps share each
// (chunk, token) t of the P x S launch (warp w of block b: t = (4 b + w) /
// parts), each a contiguous share of the token's (row, unit) items, the
// page looked up once a warp. v_src null: one array (the latent cache, hkv
// 1). kWhole: every row starts and ends on a 16-byte boundary (head_dim *
// sizeof(C) a multiple of 16); else the token's first warp also writes the
// values outside the units.
template <typename S, typename C, bool kWhole>
__global__ void __launch_bounds__(kRowWarps * 32)
    kv_write_rows_kernel(const S* __restrict__ k_src, const S* __restrict__ v_src,
                         long long stride_p, long long stride_s,
                         long long stride_h,  // element strides; d is unit
                         C* k_cache, C* v_cache,  // PageLayout (common.cuh)
                         const int* __restrict__ block_tables,  // [P, nbmax]
                         const int* __restrict__ q_offsets,     // [P]
                         const int* __restrict__ ntoks,         // [P]
                         const int* __restrict__ kv_lens,       // [P] (rm only)
                         int p_count, int s, int layer, int num_blocks, int hkv, int bs,
                         int head_dim, int nbmax, int require_aligned, long long page, int rm,
                         int parts) {
  constexpr int kVec = 16 / (int)sizeof(C);  // values a unit
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = blockIdx.x * kRowWarps + warp;  // 32-bit: the host bounds the warps
  const int t = wi / parts, part = wi - t * parts;
  if (t >= p_count * s) return;
  const int p = t / s, j = t - p * s;
  // the chunk's bounds read together (one latency, not two)
  const int ntok = ntoks[p], q_offset = q_offsets[p];
  if (j >= ntok) return;  // padding of the chunk (or a padded row)
  if (require_aligned) {
    // full-page writer contract: chunks start on a page boundary
    assert(q_offset % bs == 0);
  }
  const int pos = q_offset + j;
  const int blk = block_tables[(size_t)p * nbmax + pos / bs];
  // row r of the token: head r of K (r < hkv) or head r - hkv of V, in
  // the page canonical ([heads, bs, D]) or, K9's rows of a page the
  // sequence does not complete, token-major ([bs, 2 Hkv, D], V after K)
  const bool tm = rm && (pos / bs + 1) * bs > kv_lens[p];
  const int w = pos % bs;
  C* const pg = k_cache + ((size_t)layer * num_blocks + blk) * page;
  C* const kr0 = tm ? pg + (size_t)w * 2 * hkv * head_dim : pg + (size_t)w * head_dim;
  C* const vr0 = tm || !v_cache
                     ? kr0 + (size_t)hkv * head_dim
                     : v_cache + ((size_t)layer * num_blocks + blk) * page + (size_t)w * head_dim;
  const size_t hstep = tm ? head_dim : (size_t)bs * head_dim;  // from one head's row to the next
  const size_t src0 = (size_t)p * stride_p + (size_t)j * stride_s;
  auto src_of = [&](int r) -> const S* {
    return (r < hkv ? k_src : v_src) + src0 + (size_t)(r < hkv ? r : r - hkv) * stride_h;
  };
  auto row_of = [&](int r) -> C* {
    return (r < hkv ? kr0 : vr0) + (r < hkv ? r : r - hkv) * hstep;
  };
  auto unit = [&](const S* x) -> uint4 {
    return (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? cache_unit<S, C>(x)
                                                     : cache_unit_gather<S, C>(x);
  };
  const int nrows = v_src ? 2 * hkv : hkv;
  const int upr = head_dim / kVec;  // the most whole units a row holds
  const int items = nrows * upr, per = (items + parts - 1) / parts;
  const int ib = part * per, ie = min(items, ib + per);  // this warp's share
  // item i = r upr + u: unit u of row r; a lane's items run 32 apart, so
  // (r, u) moves on by additions after one division
  int r = (ib + lane) / upr, u = (ib + lane) % upr;
  for (int i0 = ib + lane; i0 < ie; i0 += 32 * kUnroll) {
    uint4 val[kUnroll];
    int rk[kUnroll], ek[kUnroll];  // each unit's row and first value (rk -1: none)
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      rk[k] = -1;
      if (i0 + 32 * k < ie) {
        // whole rows: the load needs no page, so it overlaps the lookup
        int e = u * kVec;
        if constexpr (!kWhole) e += unit_head(row_of(r), head_dim);
        if (e + kVec <= head_dim) {
          val[k] = unit(src_of(r) + e);
          rk[k] = r;
          ek[k] = e;
        }
      }
      for (u += 32; u >= upr; u -= upr) ++r;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (rk[k] >= 0) *reinterpret_cast<uint4*>(row_of(rk[k]) + ek[k]) = val[k];
  }
  if (kWhole || part) return;
  // the values before a row's first unit (slots e < kVec) and after its last
  for (int i = lane; i < nrows * 2 * kVec; i += 32) {
    const S* x = src_of(i / (2 * kVec));
    C* row = row_of(i / (2 * kVec));
    const int head = unit_head(row, head_dim), e = i % (2 * kVec);
    const int d = e < kVec ? e : head + (head_dim - head) / kVec * kVec + e - kVec;
    if (e < kVec ? d < head : d < head_dim) row[d] = cache_value<S, C>(x[d]);
  }
}

// K9's RMW writer (the head of this file): one cluster of kRmwCluster
// blocks (blockIdx.x its rank) per (chunk p = blockIdx.z, the chunk's first
// (k = blockIdx.y = 0) or last (k = 1) page). The page moves in 16-byte
// units, each a piece of one head's D-vector. A page the sequence does not
// complete takes the chunk's rows token-major (no barrier). A page it
// completes is rewritten canonical: block r owns the canonical units [r
// per, (r + 1) per) (per = the page's units / kRmwCluster, rounded up); it
// stages the units of its share that lie in the rows before the chunk (the
// page's first w0 rows, token-major) in its shared memory, the cluster
// meets at its barrier, and each block writes its share, earlier rows from
// its own staging and the chunk's rows from the source. Every staged unit
// is read back by the block that staged it (tests/test_torch_rmw_cluster.py
// models the partition); the barrier orders every read
// of an old token-major unit before any canonical write over it. w0 = 0:
// nothing staged, no barrier.
constexpr int kRmwThreads = 256;
constexpr int kRmwCluster = 8;

template <typename S, typename C>
__global__ void __cluster_dims__(kRmwCluster, 1, 1) __launch_bounds__(kRmwThreads)
    kv_write_rmw_rm_kernel(const S* __restrict__ k_src, const S* __restrict__ v_src,
                           long long stride_p, long long stride_s,
                           long long stride_h,  // element strides; d is unit
                           C* cache,            // [L, NB, 2, Hkv, bs, D]
                           const int* __restrict__ block_tables,  // [P, nbmax]
                           const int* __restrict__ q_offsets,     // [P]
                           const int* __restrict__ ntoks,         // [P]
                           const int* __restrict__ kv_lens,       // [P]
                           int layer, int num_blocks, int hkv, int bs, int head_dim,
                           int nbmax) {
  constexpr int kVec = 16 / sizeof(C);  // cache elements per 16-byte unit
  extern __shared__ uint4 staged[];     // this block's share: the units before the chunk
  const int rank = blockIdx.x, k = blockIdx.y, p = blockIdx.z;
  // every branch below is the same for all blocks of the cluster
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
  const int w0 = max(q_offset - pg * bs, 0);          // the chunk's first row here
  const int w1 = min(q_offset + ntok - pg * bs, bs);  // and its end
  const int units = head_dim / kVec;                  // units of a head's D-vector
  const int row = 2 * hkv * units;                    // units of a token-major row
  // unit u of head c (K heads, then V heads) of the page's row w, from the chunk
  auto src = [&](int w, int c, int u) -> uint4 {
    const S* x = (c < hkv ? k_src + (size_t)c * stride_h : v_src + (size_t)(c - hkv) * stride_h) +
                 (size_t)p * stride_p + (size_t)(pg * bs + w - q_offset) * stride_s + u * kVec;
    return cache_unit<S, C>(x);
  };
  if (!complete) {  // the rows token-major
    const int i0 = rank * kRmwThreads + threadIdx.x, step = kRmwCluster * kRmwThreads;
    for (int i = i0; i < (w1 - w0) * row; i += step) {
      const int w = w0 + i / row, c = i % row / units, u = i % units;
      dst[(size_t)w * row + c * units + u] = src(w, c, u);
    }
    return;
  }
  const int total = bs * row;
  const int per = (total + kRmwCluster - 1) / kRmwCluster;
  const int lo = rank * per, hi = min(total, lo + per);
  // canonical unit i: head c = i / (bs units), row w = i / units % bs, u = i % units
  if (w0 > 0) {
    for (int i = lo + threadIdx.x; i < hi; i += kRmwThreads) {
      const int c = i / (bs * units), w = i / units % bs, u = i % units;
      if (w < w0) staged[i - lo] = dst[(size_t)w * row + c * units + u];
    }
    hopper::cluster_sync();
  }
  for (int i = lo + threadIdx.x; i < hi; i += kRmwThreads) {
    const int c = i / (bs * units), w = i / units % bs, u = i % units;
    dst[i] = w < w0 ? staged[i - lo] : src(w, c, u);
  }
}

// the shared memory a block of the RMW writer's cluster stages at most
size_t rmw_share_bytes(int hkv, int bs, int head_dim, int elem) {
  const size_t units = (size_t)2 * hkv * bs * head_dim * elem / 16;
  return (units + kRmwCluster - 1) / kRmwCluster * 16;
}

template <typename S, typename C>
cudaError_t launch_rows(const void* k_src, const void* v_src, long long sp,
                        long long ss, long long sh, void* k_cache, void* v_cache,
                        const int* block_tables, const int* q_offsets,
                        const int* ntoks, const int* kv_lens, int p, int s, int layer,
                        int num_blocks, int hkv, int bs, int head_dim, int nbmax,
                        int require_aligned, long long page, int rm,
                        cudaStream_t stream) {
  const long long tokens = (long long)p * s;
  // warps a token: enough for ~kRowTarget warps, each with 32 or more units
  const int items = (v_src ? 2 : 1) * hkv * (head_dim * (int)sizeof(C) / 16);
  const long long want = tokens > 0 ? (kRowTarget + tokens - 1) / tokens : 1;
  const long long most = items > 32 ? (items + 31) / 32 : 1;
  const int parts = (int)(want < 1 ? 1 : want > most ? most : want);
  const long long blocks = (tokens * parts + kRowWarps - 1) / kRowWarps;
  if (blocks * kRowWarps > INT_MAX) return cudaErrorInvalidValue;
  // every row on 16-byte boundaries: the cache (and V's start) aligned, rows
  // and pages whole multiples of 16 bytes
  const bool whole = (head_dim * sizeof(C)) % 16 == 0 && (page * sizeof(C)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k_cache) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_cache) % 16 == 0;
  auto kernel = whole ? kv_write_rows_kernel<S, C, true> : kv_write_rows_kernel<S, C, false>;
  kernel<<<(unsigned)blocks, kRowWarps * 32, 0, stream>>>(
      static_cast<const S*>(k_src), static_cast<const S*>(v_src), sp, ss, sh,
      static_cast<C*>(k_cache), static_cast<C*>(v_cache), block_tables,
      q_offsets, ntoks, kv_lens, p, s, layer, num_blocks, hkv, bs, head_dim, nbmax,
      require_aligned, page, rm, parts);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_rmw_rm(const void* k_src, const void* v_src, long long sp,
                          long long ss, long long sh, void* cache, const int* block_tables,
                          const int* q_offsets, const int* ntoks, const int* kv_lens, int p,
                          int layer, int num_blocks, int hkv, int bs, int head_dim, int nbmax,
                          cudaStream_t stream) {
  constexpr int kSrcVec = 16 / sizeof(C);  // source elements a unit
  if (sp % kSrcVec || ss % kSrcVec || sh % kSrcVec || head_dim % kSrcVec ||
      reinterpret_cast<uintptr_t>(k_src) % 16 || reinterpret_cast<uintptr_t>(v_src) % 16 ||
      p > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = rmw_share_bytes(hkv, bs, head_dim, sizeof(C));
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  static AllowSmemOnce allow;  // the most, once
  const cudaError_t err = allow(kv_write_rmw_rm_kernel<S, C>, kSmemMax);
  if (err != cudaSuccess) return err;
  kv_write_rmw_rm_kernel<S, C><<<dim3(kRmwCluster, 2, p), kRmwThreads, smem, stream>>>(
      static_cast<const S*>(k_src), static_cast<const S*>(v_src), sp, ss, sh,
      static_cast<C*>(cache), block_tables, q_offsets, ntoks, kv_lens, layer, num_blocks, hkv,
      bs, head_dim, nbmax);
  return cudaGetLastError();
}

// K11c + K11d: the latent (MLA) writers. The same row scatter into the
// single-head cache [L, NB, 1, bs, Dk] (one array, hkv 1, page bs * Dk):
// a warp per (chunk, token) writes one Dk-wide row. They replace
// latent_write_prefill_batched_tpu (K11c, page-aligned chunks; the TPU
// kernel moves whole pages and fills the never-read tail of the last one
// with padding) and latent_write_rmw_batched_tpu (K11d, S <= block_size at
// any alignment, read-patch-write of at most two pages). Here exactly the
// ntok valid rows of each chunk are written. Bound: bytes. An e4m3 latent
// cache takes bf16 or f32 rows cast here, as the K2 / K4 rows.
template <typename S, typename C>
cudaError_t launch_latent_rows(const void* src, long long sp, long long ss,
                               void* cache, const int* block_tables,
                               const int* q_offsets, const int* ntoks, int p, int s,
                               int layer, int num_blocks, int bs, int dk, int nbmax,
                               int require_aligned, cudaStream_t stream) {
  return launch_rows<S, C>(src, nullptr, sp, ss, 0, cache, nullptr, block_tables, q_offsets,
                           ntoks, nullptr, p, s, layer, num_blocks, 1, bs, dk, nbmax,
                           require_aligned, (long long)bs * dk, 0, stream);
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

// K9's RMW writer: cache [L, NB, 2, Hkv, bs, D]; the sources' base and
// strides 16-byte aligned (in elements: multiples of 16 / the cache's
// element size)
extern "C" int xllm_kv_write_rmw_rm(int device, const void* k_src, const void* v_src,
                                    long long stride_p, long long stride_s,
                                    long long stride_h, void* cache,
                                    const void* block_tables, const void* q_offsets,
                                    const void* ntoks, const void* kv_lens, int src_dtype,
                                    int dtype, int p, int s, int layer, int num_blocks,
                                    int hkv, int bs, int head_dim, int nbmax, void* stream) {
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
                                        cache, bt, qo, nt, kl, p, layer, num_blocks,  \
                                        hkv, bs, head_dim, nbmax, st);
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
