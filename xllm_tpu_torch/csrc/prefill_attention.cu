// K3 + K3b: causal flash attention of prompt chunks over paged KV.
//
// Replaces xllm_tpu/ops/pallas/prefill_attention.py
// paged_attention_prefill_batched_tpu (K3; same contract: P chunks, q
// [P, S, Hq, D] at absolute positions q_offsets + i, each attending
// causally to its own paged K/V up to kv_lens through block_tables, GQA,
// optional sliding window; kv_len 0 marks a padded row) and, launched with
// one chunk, paged_attention_prefill_tpu (K3b, the single-chunk contract;
// ops/cuda/prefill_attention.py counts it apart). Query rows past a
// chunk's ntok = kv_len - q_offset tokens (bucket padding) and padded rows
// come out as zeros, by design: the TPU kernels' mask (kv <= row_pos) &
// (kv < kv_len) lets a bucket-padding row attend to all of [0, kv_len),
// work whose result nothing reads (logits, scores and the cache writers
// take real rows only).
//
// What bounds it: operations for long chunks. A 2048-token chunk does ~2 x
// S x kv x Hq x D x 2 flops against one read of its K/V, above the card's
// bytes-to-flops balance, so the limit is the arithmetic (short ragged
// chunks, as in chip_smoke.py's 512-token buckets, are bound by their
// bytes instead). This first
// version does it with f32 FMAs on the CUDA cores (67 TFLOP/s peak, not the
// 989 of the bf16 tensor cores): one block per (chunk, kv head, query tile)
// holds 64 query rows (the G heads of one kv head x 64 / G positions), so
// a K/V tile in shared memory serves every head that shares it; each
// thread keeps 16 rows x 2 keys of scores and 16 rows x D/32 output
// columns in registers, so every shared-memory load feeds 3-4 FMAs; the
// walk stops at the tile's causal frontier min(kv_len, last row + 1) and
// starts at the window's lower edge. Not yet done: mma/wgmma on bf16
// tiles, and overlapping the next tile's load with this tile's math.
//
// Quantized caches (int8 codes or e4m3; q and the output stay bf16 or f32):
// the K/V tiles are upcast to bf16 on their way into shared memory. The
// chunk's own rows are read back from the cache, as stored.
//
// Rounding P, on every cache but f32 (whose V tile is not bf16): as in the
// TPU kernel, P is rounded to bf16 before P.V (l sums the unrounded P),
// against the running maximum after each page of the walk:
// - a page shorter than the 64-position tile (block_size 16 or 32): each
//   page of the tile takes the running maximum up to its end (a prefix
//   maximum over the warp's lanes), and its rounded P carries
//   exp(m_page - m_tile) in f32, as the TPU kernel's later rescales carry
//   it;
// - block_size 64: a tile is a page;
// - a page longer than the tile (a multiple of 64): at the page's first
//   tile the block computes the rows' maxima over the whole page (K only,
//   the same score code, so the same bits), and every tile of the page
//   rounds against that maximum. The page's K is read twice.
//
// K8 (and K9's prefill): the same kernel replaces prefill_attention.py
// paged_attention_prefill_batched_ilv_tpu on the interleaved cache [L, NB,
// 2, Hkv, bs, D] (PageLayout in common.cuh: another page stride, V Hkv *
// bs * D after K). With rm (rowmajor_tail, kv_layout="interleaved_rm") a
// chunk's sequence whose length kv_len is not a multiple of bs keeps its
// last page, from (kv_len / bs) * bs, token-major; the loaders read those
// positions from it (the long-page maxima above too). The TPU kernel
// takes that page out of its page walk and attends it after the walk; it
// is the last page in position order, so the walk and its rounding are
// the same.
#include "common.cuh"

namespace xllm {

constexpr int kRows = 64;                         // query rows per block
constexpr int kRowsPerWarp = kRows / (kThreads / 32);  // 16

template <typename S, int D>
size_t prefill_smem_bytes() {
  return ((size_t)kRows * D + (size_t)kRows * kTile + 4 * kRows) * sizeof(float) +
         2 * (size_t)kTile * (D + kPad) * sizeof(S);
}

// T: q / output; C: the cache (T itself, or int8 / e4m3)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads)
    prefill_attention_kernel(const T* __restrict__ q,  // [P, S, Hq, D]
                             const C* __restrict__ k_cache,
                             const C* __restrict__ v_cache,  // pages: PageLayout
                             const int* __restrict__ block_tables,  // [P, nbmax]
                             const int* __restrict__ q_offsets,     // [P]
                             const int* __restrict__ kv_lens,       // [P]
                             T* __restrict__ out,                   // [P, S, Hq, D]
                             int layer, int num_blocks, int hkv, int bs,
                             int nbmax, int seq, int group, int tq, float scale,
                             int window, int seg,  // seg: page length < kTile, or kTile
                             long long page, int rm) {
  // (bs: a divisor or a multiple of kTile, checked by the C entry)
  using S = typename TileOf<C>::type;
  constexpr bool kRound = kRoundP<C>;
  constexpr int kPairs = D / 64;  // column pairs per lane: 2 * lane + 64 * c
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kRows, D]
  float* ps = qs + kRows * D;                   // [kRows, kTile]
  float* ms = ps + kRows * kTile;               // [kRows]
  float* ls = ms + kRows;
  float* alpha_s = ls + kRows;
  float* pm = alpha_s + kRows;  // [kRows] a long page's maxima
  S* ks = reinterpret_cast<S*>(pm + kRows);  // [kTile, D + kPad]
  S* vs = ks + kTile * (D + kPad);

  const int p = blockIdx.x, h = blockIdx.y, s0 = blockIdx.z * tq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq = hkv * group;
  const int rows = group * tq;  // row r = (head g = r / tq, position r % tq)
  const int q_offset = q_offsets[p];
  const int kv_len = kv_lens[p];
  const int ntok = kv_len - q_offset;
  const PageLayout lay{page, rm && kv_len % bs ? kv_len / bs * bs : INT_MAX};
  // query positions of this tile that hold real tokens
  const int nvalid = kv_len > 0 ? min(tq, min(seq, ntok) - s0) : 0;

  // q and out share the [P, S, Hq, D] layout
  auto row_off = [&](int r) -> size_t {
    return (((size_t)p * seq + s0 + r % tq) * hq + (size_t)h * group + r / tq) * D;
  };
  if (nvalid <= 0) {
    for (int i = tid; i < kRows * D; i += blockDim.x) {
      const int r = i / D;
      if (r < rows && s0 + r % tq < seq) out[row_off(r) + i % D] = from_float<T>(0.f);
    }
    return;
  }
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int r = i / D;
    const bool live = r < rows && r % tq < nvalid;
    qs[i] = live ? to_float(q[row_off(r) + i % D]) : 0.f;
  }
  for (int r = tid; r < kRows; r += blockDim.x) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }

  float2 acc[kRowsPerWarp][kPairs];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc[i][c] = make_float2(0.f, 0.f);

  // kv positions any row of the tile may see: [lo, hi)
  const int hi = q_offset + s0 + nvalid;
  const int lo = window > 0 ? max(q_offset + s0 - window + 1, 0) : 0;
  const int* bt = block_tables + (size_t)p * nbmax;
  __syncthreads();

  // scores of the tile in ks: rows warp + 4 * i, keys lane and lane + 32
  auto tile_scores = [&](float (&sc)[kRowsPerWarp][2]) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i][0] = sc[i][1] = 0.f;
    const S* k0 = ks + lane * (D + kPad);
    const S* k1 = ks + (lane + 32) * (D + kPad);
#pragma unroll 2
    for (int d = 0; d < D; d += 2) {
      const float2 a = load2(k0 + d), b = load2(k1 + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float2 qv = *reinterpret_cast<const float2*>(qs + (warp + 4 * i) * D + d);
        sc[i][0] = fmaf(qv.x, a.x, fmaf(qv.y, a.y, sc[i][0]));
        sc[i][1] = fmaf(qv.x, b.x, fmaf(qv.y, b.y, sc[i][1]));
      }
    }
  };
  // is key j of the tile at t0 visible to row r (live rows only)?
  auto visible = [&](int r, int t0, int j, int jlo, int jhi) {
    const int pos = q_offset + s0 + r % tq, kv = t0 + j;
    return r < rows && r % tq < nvalid && j >= jlo && j < jhi && kv <= pos &&
           (window <= 0 || kv > pos - window);
  };
  const bool long_pages = kRound && bs > kTile;
  const int t_first = (lo / kTile) * kTile;

  for (int t0 = t_first; t0 < hi; t0 += kTile) {
    const int jlo = max(lo - t0, 0);
    const int jhi = min(hi - t0, kTile);
    if (long_pages && (t0 % bs == 0 || t0 == t_first)) {
      // the rows' maxima over this page's tiles from t0 (K only)
      const int page_end = min((t0 / bs + 1) * bs, hi);
      float pmax[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pmax[i] = -INFINITY;
      for (int u0 = t0; u0 < page_end; u0 += kTile) {
        const int ulo = max(lo - u0, 0), uhi = min(hi - u0, kTile);
        load_tile<C, D, false>(ks, nullptr, k_cache, nullptr, lay, bt, layer, num_blocks,
                               hkv, h, bs, u0, ulo, uhi);
        __syncthreads();
        float sc[kRowsPerWarp][2];
        tile_scores(sc);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = warp + 4 * i;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (visible(r, u0, lane + 32 * u, ulo, uhi))
              pmax[i] = fmaxf(pmax[i], sc[i][u] * scale);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float m = warp_max(pmax[i]);
        if (lane == 0) pm[warp + 4 * i] = m;
      }
    }
    load_tile<C, D>(ks, vs, k_cache, v_cache, lay, bt, layer, num_blocks, hkv, h, bs, t0,
                    jlo, jhi);
    __syncthreads();

    float sc[kRowsPerWarp][2];
    tile_scores(sc);
    // mask + online softmax, one warp per row
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + 4 * i;
      float s2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        s2[u] = visible(r, t0, lane + 32 * u, jlo, jhi) ? sc[i][u] * scale : -INFINITY;
      const float m_old = ms[r];
      float m_new = fmaxf(m_old, warp_max(fmaxf(s2[0], s2[1])));
      if (long_pages) m_new = fmaxf(m_new, pm[r]);  // the page's maximum
      const bool none = m_new == -INFINITY;  // nothing visible yet
      float p0 = none ? 0.f : expf(s2[0] - m_new);
      float p1 = none ? 0.f : expf(s2[1] - m_new);
      if (kRound && seg < kTile) {
        // page maxima (keys of a page: seg neighbouring lanes), then the
        // running maximum at the end of each key's page
        float run0 = s2[0], run1 = s2[1];
        for (int o = 16; o > 0; o >>= 1) {
          if (o < seg) {
            run0 = fmaxf(run0, __shfl_xor_sync(0xffffffffu, run0, o));
            run1 = fmaxf(run1, __shfl_xor_sync(0xffffffffu, run1, o));
          }
        }
        for (int o = 1; o < 32; o <<= 1) {
          const float a = __shfl_up_sync(0xffffffffu, run0, o);
          const float b = __shfl_up_sync(0xffffffffu, run1, o);
          if (lane >= o) {
            run0 = fmaxf(run0, a);
            run1 = fmaxf(run1, b);
          }
        }
        run1 = fmaxf(run1, __shfl_sync(0xffffffffu, run0, 31));
        run0 = fmaxf(run0, m_old);
        run1 = fmaxf(run1, m_old);
        const float w0 = run0 == -INFINITY ? 0.f : expf(run0 - m_new);
        const float w1 = run1 == -INFINITY ? 0.f : expf(run1 - m_new);
        const float q0 = run0 == -INFINITY ? 0.f : expf(s2[0] - run0);
        const float q1 = run1 == -INFINITY ? 0.f : expf(s2[1] - run1);
        ps[r * kTile + lane] = round_bf16(q0) * w0;
        ps[r * kTile + lane + 32] = round_bf16(q1) * w1;
        p0 = q0 * w0;
        p1 = q1 * w1;
      } else {
        ps[r * kTile + lane] = kRound ? round_bf16(p0) : p0;
        ps[r * kTile + lane + 32] = kRound ? round_bf16(p1) : p1;
      }
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = none ? 1.f : expf(m_old - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the tile's live keys
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float al = alpha_s[warp + 4 * i];
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        acc[i][c].x *= al;
        acc[i][c].y *= al;
      }
    }
    for (int j = jlo; j < jhi; ++j) {
      float2 v[kPairs];
#pragma unroll
      for (int c = 0; c < kPairs; ++c) v[c] = load2(vs + j * (D + kPad) + 64 * c + 2 * lane);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pr = ps[(warp + 4 * i) * kTile + j];
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          acc[i][c].x = fmaf(pr, v[c].x, acc[i][c].x);
          acc[i][c].y = fmaf(pr, v[c].y, acc[i][c].y);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + 4 * i;
    if (r >= rows || s0 + r % tq >= seq) continue;
    const bool live = r % tq < nvalid;
    const float inv = live ? 1.f / ls[r] : 0.f;
    T* o = out + row_off(r);
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int col = 64 * c + 2 * lane;
      o[col] = from_float<T>(acc[i][c].x * inv);
      o[col + 1] = from_float<T>(acc[i][c].y * inv);
    }
  }
}

template <typename T, typename C, int D>
cudaError_t launch_prefill(const void* q, const void* k_cache,
                           const void* v_cache, const int* block_tables,
                           const int* q_offsets, const int* kv_lens, void* out,
                           int p, int seq, int layer, int num_blocks, int hkv,
                           int bs, int nbmax, int group, float scale, int window,
                           long long page, int rm, cudaStream_t stream) {
  auto kernel = prefill_attention_kernel<T, C, D>;
  const size_t smem = prefill_smem_bytes<typename TileOf<C>::type, D>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tq = kRows / group;
  const dim3 grid(p, hkv, (seq + tq - 1) / tq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k_cache),
      static_cast<const C*>(v_cache), block_tables, q_offsets, kv_lens,
      static_cast<T*>(out), layer, num_blocks, hkv, bs, nbmax, seq, group, tq,
      scale, window, bs < kTile && kTile % bs == 0 ? bs : kTile, page, rm);
  return cudaGetLastError();
}

}  // namespace xllm

extern "C" int xllm_prefill_attention(int device, const void* q,
                                      const void* k_cache, const void* v_cache,
                                      const void* block_tables,
                                      const void* q_offsets, const void* kv_lens,
                                      void* out, int dtype, int qtype, int head_dim,
                                      int p,
                                      int seq, int layer, int num_blocks, int hkv,
                                      int bs, int nbmax, int group, float scale,
                                      int window, long long page, int rm, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (group < 1 || group > xllm::kRows ||
      (bs > xllm::kTile ? bs % xllm::kTile : xllm::kTile % bs) ||
      page < (long long)hkv * bs * head_dim)
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* kl = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XLLM_LAUNCH(T, C, D)                                                        \
  return (int)xllm::launch_prefill<T, C, D>(q, k_cache, v_cache, bt, qo, kl, out, p, \
                                            seq, layer, num_blocks, hkv, bs, nbmax,  \
                                            group, scale, window, page, rm, s)
#define XLLM_HEAD_DIMS(T, C)                  \
  if (head_dim == 128) XLLM_LAUNCH(T, C, 128); \
  if (head_dim == 64) XLLM_LAUNCH(T, C, 64);
#define XLLM_CACHES(T, TCODE)                                       \
  if (qtype == TCODE) {                                             \
    if (dtype == TCODE) { XLLM_HEAD_DIMS(T, T) }                    \
    if (dtype == XLLM_DTYPE_I8) { XLLM_HEAD_DIMS(T, int8_t) }       \
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_HEAD_DIMS(T, xllm::e4m3) } \
  }
  XLLM_CACHES(__nv_bfloat16, XLLM_DTYPE_BF16)
  XLLM_CACHES(float, XLLM_DTYPE_F32)
#undef XLLM_CACHES
#undef XLLM_HEAD_DIMS
#undef XLLM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
