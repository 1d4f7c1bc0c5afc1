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
// What bounds it: operations for long chunks. A 2048-token chunk does
// ~2 x S x kv x Hq x D x 2 flops against one read of its K/V, above the
// card's bytes-to-flops balance (K3b at S 2048 from q_offset 2048: 51.5
// GFLOP over ~34 MB, 0.052 ms at the bf16 tensor cores' 989 TFLOP/s). A
// short chunk deep in a prompt (52 tokens at q_offset 2048) is bound by
// its bytes: it reads 2,100 positions of K and V (8.6 MB a layer at
// qwen3-1.7B's 8 kv heads) for 0.9 GFLOP.
//
// Two kernels, chosen by q's dtype and head_dim in the C entry:
//
// 1. bf16 q at head_dim 128 (every served bf16 model, on a bf16, int8 or
//    fp8 cache) and 256 (qwen3-next's full-attention layers, on a bf16 or
//    fp8 cache: 64 rows a block, see Geo below): tensor cores,
//    prefill_tc_kernel below.
//    - A block holds 128 query rows, 8 warps x 16: the G query heads of one
//      kv head x 128 / G positions, token-major (row r = position r / G,
//      head r % G), so a K/V tile in shared memory serves every head that
//      shares it, and each K/V byte brought from memory serves 128 rows.
//    - S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulators; Q and K
//      rows feed the A and B operands through ldmatrix), held in registers.
//      P goes from the S accumulators straight into the bf16 A fragments of
//      P V (V through ldmatrix.trans): that conversion is the TPU kernel's
//      p_.astype(bf16), so P never touches shared memory. Each k16 step's
//      P V product starts from zero and joins the output accumulators
//      through an f32 add: the tensor cores' own accumulation does not round
//      as IEEE f32 does, and over thousands of keys it drifted past the
//      checks' one bf16 ulp of the result.
//    - K and V arrive through a cp.async ring of 16-byte copies (three
//      stages of 64-key tiles, two of 128-key tiles) addressed through
//      block_tables and PageLayout: the next tiles' pages are in flight
//      while this tile's products run. An int8 or e4m3 cache lands in the
//      ring as stored and becomes bf16 (exactly, as the TPU kernel's _mxu
//      upcasts it) in one conversion pass per tile into a bf16 tile that
//      all eight warps read.
//    - Rounding P (every cache of this kernel is bf16, int8 or e4m3): the
//      unnormalised P of each page, against the running maximum after that
//      page; l sums the unrounded P. The key tile is max(64, block_size)
//      positions up to block_size 128, so a page never spans two tiles, and
//      the walk goes one page at a time (the page length is a template
//      parameter, so the walk unrolls): the page's row maxima (a quad
//      reduction over the fragment's columns), the rescale of acc and l by
//      exp(m_old - m_new) (skipped when no row of the warp moved), P of the
//      page rounded against m_new, its k16 steps of P V. A page shorter than
//      a k16 step (block_size 1-8, no served configuration) issues one
//      product per page with the other keys' P zero. Pages longer than 128
//      positions (192, 256, ...) take their maxima from a first pass.
//    - A context split for launches with few blocks: the wrapper plans it
//      from shapes (ops/cuda/prefill_attention.split_plan), never from
//      kv_lens. Splits are page- and tile-aligned; a split past a chunk's
//      kv_len (or below its window) exits at once. A first pass (PASS1: the
//      same score code on the same data, so the same bits) writes each
//      (row, split) maximum (per page for pages longer than 128), and each
//      split starts its running maximum at the maximum of the earlier
//      splits': the TPU walk's running maximum at the split's first page,
//      so every page rounds as the TPU's does. Each split publishes (m, l,
//      acc) in f32; the last split to finish (a counter per row tile, as
//      K1 and K11 do) merges them with weights exp(m_i - max m).
//    - Causal balance: the row tiles that walk the most keys launch first.
//    What bounds it (measured on an H100, PERF.md): not the tensor cores'
//    rate. At ~190 registers a thread one block of 8 warps fits an SM, the
//    warps run in step between the products and the softmax, and each
//    16-row warp reads every K/V fragment from shared memory for its own
//    rows, so the walk is bound by latency and shared-memory traffic (~110
//    TFLOP/s at S 2048 from q_offset 2048). wgmma with TMA and warp
//    specialisation is the next step. A short chunk deep in a prompt is
//    bound by its bytes and by the split's merge.
//
// 2. f32 q (the f32 parity models with their f32 cache, and f32 q on an
//    int8 or e4m3 cache), and head_dim 64 (no engine path launches it: the
//    JAX package runs its portable path there): f32 FMAs on the CUDA cores,
//    prefill_attention_kernel below, no context split. TF32 would not keep
//    the f32 results' 1e-4, so this is a dispatch on the type, not a
//    fallback. One block per (chunk, kv head, query tile) holds 64 query
//    rows (the G heads of one kv head x 64 / G positions), so a K/V tile
//    in shared memory serves every head that shares it; each thread keeps
//    16 rows x 2 keys of scores and 16 rows x D/32 output columns in
//    registers; the walk stops at the tile's causal frontier min(kv_len,
//    last row + 1) and starts at the window's lower edge. Quantized caches
//    (int8 codes or e4m3) are upcast to bf16 on their way into shared
//    memory. Rounding P, on every cache but f32: as above, against the
//    running maximum after each page of the walk:
//    - a page shorter than the 64-position tile (block_size 16 or 32): each
//      page of the tile takes the running maximum up to its end (a prefix
//      maximum over the warp's lanes), and its rounded P carries
//      exp(m_page - m_tile) in f32, as the TPU kernel's later rescales carry
//      it;
//    - block_size 64: a tile is a page;
//    - a page longer than the tile (a multiple of 64): at the page's first
//      tile the block computes the rows' maxima over the whole page (K only,
//      the same score code, so the same bits), and every tile of the page
//      rounds against that maximum. The page's K is read twice.
//
// K8 (and K9's prefill): both kernels replace prefill_attention.py
// paged_attention_prefill_batched_ilv_tpu on the interleaved cache [L, NB,
// 2, Hkv, bs, D] (PageLayout in common.cuh: another page stride, V Hkv *
// bs * D after K). With rm (rowmajor_tail, kv_layout="interleaved_rm") a
// chunk's sequence whose length kv_len is not a multiple of bs keeps its
// last page, from (kv_len / bs) * bs, token-major; the loaders read those
// positions from it. The TPU kernel takes that page out of its page walk
// and attends it after the walk; it is the last page in position order, so
// the walk and its rounding are the same.
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


// ---------------------------------------------------------------------------
// bf16 q, head_dim 128 or 256: tensor cores (mma.sync), a cp.async K/V ring,
// page-exact P rounding in the fragments, an optional context split
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kMaxSplits = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;         // warps a block
constexpr int NTH = 32 * kWarps;  // threads a block
constexpr int kDW = 128;          // output columns a warp accumulates

// The block's geometry at head_dim D. A warp holds 16 query rows and the
// P V accumulators of kDW = 128 output columns (64 f32 registers a
// thread). At D 128 the eight warps take eight row groups (128 rows); at
// D 256 they pair up: warps w and w + 4 hold the same 16 rows, each
// computes their S = Q K^T over all of D (the same bits, so the same P
// and maxima) and P V into its own half of the columns, so a thread's
// accumulators stay those of D 128 and the block holds 64 rows.
template <int D>
struct Geo {
  static_assert(D % kDW == 0 && kWarps % (D / kDW) == 0, "head_dim");
  static constexpr int kLd = D + 8;      // bf16 elements a shared row: ldmatrix conflict-free
  static constexpr int kRawLd = D + 16;  // bytes a shared row of a 1-byte cache stage
  static constexpr int kCH = D / kDW;    // warps sharing a row group (column halves)
  static constexpr int kRowWarps = kWarps / kCH;
  static constexpr int BR = 16 * kRowWarps;  // query rows a block
  static constexpr int kPR = 4 + D;  // a published row of a split: m, l, two pad floats, acc
};

// Shared memory of a block: the Q tile, a ring of K/V stages (three, two at
// 128-key tiles or head_dim 256), and for a 1-byte cache the bf16 K and V
// tiles a stage converts into.
template <typename C, int KT, int D>
struct Layout {
  using G = Geo<D>;
  static constexpr bool kQuant = sizeof(C) == 1;
  static constexpr int kStages = KT == 128 || D > 128 ? 2 : 3;
  static constexpr size_t kQ = (size_t)G::BR * G::kLd * 2;
  // one ring stage: K then V, as stored
  static constexpr size_t kStage =
      kQuant ? 2 * (size_t)KT * G::kRawLd : 2 * (size_t)KT * G::kLd * 2;
  static constexpr size_t kTiles = kQuant ? 2 * (size_t)KT * G::kLd * 2 : 0;
  static constexpr size_t kBytes = kQ + kStages * kStage + kTiles;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// C: the cache's element type (bf16, int8 or e4m3); PG: a page's keys in a
// key tile (16, 32, 64, 128; 64 also for pages longer than the tile, whose
// maxima come from the first pass; 0 for pages of 1-8 keys, whose length
// the walk reads at run time); PASS1: write the first pass's maxima instead
// of attending; D: the head_dim (128, or 256 on a bf16 or e4m3 cache).
template <typename C, int PG, bool PASS1, int D>
__global__ void __launch_bounds__(NTH)
    prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,  // [P, S, Hq, D]
                      const C* k_cache, const C* v_cache,   // pages: PageLayout
                      const int* __restrict__ block_tables,  // [P, nbmax]
                      const int* __restrict__ q_offsets,     // [P]
                      const int* __restrict__ kv_lens,       // [P]
                      float* gmax,  // [tiles * BR rows, ngran] first-pass maxima
                      __nv_bfloat16* __restrict__ out,  // [P, S, Hq, D]
                      float* part,                      // [tiles, nsplit, BR, kPR]
                      int* counters,                    // [tiles], 0 between launches
                      int layer, int num_blocks, int hkv, int bs, int nbmax, int seq,
                      int group, int tq, float scale, int window, long long page, int rm,
                      int chunk, int nsplit, int seg, int ngran) {
  constexpr int KT = PG == 128 && D == 128 ? 128 : 64;  // the key tile
  using L = Layout<C, KT, D>;
  constexpr int BR = Geo<D>::BR, kLd = Geo<D>::kLd, kPR = Geo<D>::kPR;
  constexpr bool kQuant = L::kQuant;
  constexpr int NT = KT / 8;   // n8 tiles of S a warp
  constexpr int KS = KT / 16;  // k16 steps of P V a tile
  constexpr int DT = kDW / 8;  // n8 tiles of a warp's output columns
  constexpr int QK = D / 16;   // k16 steps of Q K^T
  constexpr int RLD = kQuant ? Geo<D>::kRawLd : kLd;  // elements a stage row
  constexpr int kVec = 16 / sizeof(C);        // elements a 16-byte copy
  constexpr int kChunks = D / kVec;           // 16-byte copies a row

  const int h = blockIdx.x % hkv, split = blockIdx.x / hkv, p = blockIdx.y;
  const int rt = gridDim.z - 1 - blockIdx.z;  // the longest walks first
  const int tid = threadIdx.x, lane = tid % 32;
  // this warp's row group and its output columns [col0, col0 + kDW)
  const int warp = tid / 32 % Geo<D>::kRowWarps, col0 = tid / 32 / Geo<D>::kRowWarps * kDW;
  const bool lead = col0 == 0;  // the warp that publishes its rows' maxima
  const int g = lane / 4, t4 = lane % 4;
  const int hq = hkv * group, rows = group * tq, s0 = rt * tq;
  const int q_offset = q_offsets[p], kv_len = kv_lens[p];
  // query positions of this tile that hold real tokens
  const int nvalid = kv_len > 0 ? min(tq, min(seq, kv_len - q_offset) - s0) : 0;
  const size_t tile_id = ((size_t)p * hkv + h) * gridDim.z + rt;
  auto row_off = [&](int r) -> size_t {  // q and out share [P, S, Hq, D]
    return (((size_t)p * seq + s0 + r / group) * hq + (size_t)h * group + r % group) * D;
  };
  auto row_out = [&](int r) { return r < rows && s0 + r / group < seq; };
  if (nvalid <= 0) {  // a padded row or bucket padding: zeros
    if (!PASS1 && split == 0)
      for (int i = tid; i < BR * (D / 2); i += NTH) {
        const int r = i / (D / 2);
        if (row_out(r))
          reinterpret_cast<uint32_t*>(out + row_off(r))[i % (D / 2)] = 0u;
      }
    return;
  }
  // kv positions any row of the tile may see: [lo, hi); the walk covers
  // [w_lo, hi) in tiles, splits [k * chunk, (k + 1) * chunk) of it
  const int hi = q_offset + s0 + nvalid;
  const int lo = window > 0 ? max(q_offset + s0 - window + 1, 0) : 0;
  const int w_lo = lo / KT * KT;
  const int k_first = w_lo / chunk, k_last = (hi - 1) / chunk;
  const bool long_pages = bs > KT;
  if (split < k_first || split > k_last) return;
  if (PASS1 && !long_pages && split == k_last) return;  // no split reads its maximum
  const int nsp = k_last - k_first + 1;
  const int t_begin = max(split * chunk, w_lo), t_end = min((split + 1) * chunk, hi);

  // this thread's two rows: ra = 16 warp + g and rb = ra + 8; pos -1: no token
  const int ra = warp * 16 + g, rb = ra + 8;
  auto row_pos = [&](int r) {
    return r < rows && r / group < nvalid ? q_offset + s0 + r / group : -1;
  };
  const int pa = row_pos(ra), pb = row_pos(rb);
  const int la = window > 0 ? pa - window + 1 : 0, lb = window > 0 ? pb - window + 1 : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  // the Q tile, rows without a token zero-filled; its A fragments (row g,
  // k 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..) come through
  // ldmatrix at each k16 step
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  for (int idx = tid; idx < BR * (D / 8); idx += NTH) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool ok = row_pos(r) >= 0;
    cp_async16(qs + r * kLd + c, q + (ok ? row_off(r) + c : 0), ok);
  }
  unsigned char* ring = smem + L::kQ;
  const PageLayout lay{page, rm && kv_len % bs ? kv_len / bs * bs : INT_MAX};
  const int* bt = block_tables + (size_t)p * nbmax;
  // K (and V) rows of positions t0 + j into ring stage `stage`; positions
  // outside [t_begin, t_end) are zero-filled (their P is 0, and 0 * V must
  // stay 0)
  auto load_tile = [&](int stage, int t0) {
    C* ks = reinterpret_cast<C*>(ring + stage * L::kStage);
    C* vs = ks + KT * RLD;
    for (int idx = tid; idx < KT * kChunks; idx += NTH) {
      const int j = idx / kChunks, c = (idx % kChunks) * kVec, pos = t0 + j;
      const bool ok = pos >= t_begin && pos < t_end;
      const C *krow = k_cache, *vrow = v_cache;
      if (ok)
        kv_rows(lay, k_cache, v_cache, layer, num_blocks, hkv, bs, D, bt[pos / bs], h, pos,
                krow, vrow);
      cp_async16(ks + j * RLD + c, krow + (ok ? c : 0), ok);
      if (!PASS1) cp_async16(vs + j * RLD + c, vrow + (ok ? c : 0), ok);
    }
  };
  __nv_bfloat16* kt_q = reinterpret_cast<__nv_bfloat16*>(ring + L::kStages * L::kStage);
  // a 1-byte stage -> the bf16 tiles (K, and V but in the first pass)
  auto convert = [&](int stage) {
    if constexpr (kQuant) {
    const unsigned char* raw = ring + stage * L::kStage;
    for (int idx = tid; idx < (PASS1 ? 1 : 2) * KT * (D / 16); idx += NTH) {
      const int which = idx / (KT * (D / 16)), rem = idx % (KT * (D / 16));
      const int j = rem / (D / 16), c = (rem % (D / 16)) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + (which * KT + j) * RLD + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = upcast2<C>(w[i]);
        o[2 * i + 1] = upcast2<C>(w[i] >> 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(kt_q + (which * KT + j) * kLd + c);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    }
  };

  float m_a = -INFINITY, m_b = -INFINITY;  // running maxima of rows ra, rb
  float l_a = 0.f, l_b = 0.f;              // this thread's columns' share of l
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float* gr = gmax + tile_id * BR * ngran;  // this tile's rows
  if (!PASS1 && t_begin > w_lo) {  // the walk's running maximum at t_begin
    for (int k = w_lo / seg; k < t_begin / seg; ++k) {
      m_a = fmaxf(m_a, gr[ra * ngran + k]);
      m_b = fmaxf(m_b, gr[rb * ngran + k]);
    }
  }
  float x_a = -INFINITY, x_b = -INFINITY;  // the first pass's maxima of the segment

  // the new page maxima xa, xb: m moves, acc and l follow
  auto open_page = [&](float xa, float xb) {
    const float na = fmaxf(m_a, xa), nb = fmaxf(m_b, xb);
    const float al_a = na == -INFINITY ? 1.f : expf(m_a - na);
    const float al_b = nb == -INFINITY ? 1.f : expf(m_b - nb);
    m_a = na;
    m_b = nb;
    if (__any_sync(kFull, al_a != 1.f || al_b != 1.f)) {
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= al_a;
        acc[j][1] *= al_a;
        acc[j][2] *= al_b;
        acc[j][3] *= al_b;
      }
    }
  };
  // acc += P V over k16 step ks of the V tile: P of keys 16 ks + (2t, 2t+1)
  // in p0, of 16 ks + 8 + (2t, 2t+1) in p1 ([0, 1] row ra, [2, 3] row rb).
  // Each step's product starts from zero and joins acc through an f32 add:
  // the tensor cores' own accumulation does not round as IEEE f32 does, and
  // over a walk of thousands of keys its error would outgrow the f32 sum's.
  auto pv_step = [&](const __nv_bfloat16* vt, int ks, const float (&p0)[4],
                     const float (&p1)[4]) {
    uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]), pack_bf16(p1[0], p1[1]),
                     pack_bf16(p1[2], p1[3])};
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t b[4];  // (k 0-7, k 8-15) of n8 tile j, then of tile j + 1
      ldmatrix_x4_trans(b, vt + (16 * ks + (lane % 16)) * kLd + col0 + 8 * j + (lane / 16) * 8);
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d0, a, b[0], b[1]);
      mma_bf16(d1, a, b[2], b[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] += d0[e];
        acc[j + 1][e] += d1[e];
      }
    }
  };

  const int ntiles = (t_end - t_begin + KT - 1) / KT;  // t_begin is a multiple of KT
  constexpr int NS = L::kStages;
  for (int i = 0; i + 1 < NS; ++i) {  // the ring's first tiles (the Q tile rides with tile 0)
    if (i < ntiles) load_tile(i, t_begin + i * KT);
    cp_async_commit();
  }
  const __nv_bfloat16* qrow = qs + (warp * 16 + lane % 16) * kLd + (lane / 16) * 8;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_begin + it * KT;
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1's stage
    if (it + NS - 1 < ntiles) load_tile((it + NS - 1) % NS, t0 + (NS - 1) * KT);
    cp_async_commit();
    const __nv_bfloat16 *kt, *vt;
    if constexpr (kQuant) {
      convert(it % NS);
      __syncthreads();
      kt = kt_q;
      vt = kt_q + KT * kLd;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(ring + (it % NS) * L::kStage);
      vt = kt + KT * kLd;
    }

    // S = Q K^T, this warp's 16 rows x KT keys, in registers
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qrow + 16 * kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];  // K rows are the n index, their lanes the k index
        ldmatrix_x4(b, kt + (8 * (j + lane / 16) + lane % 8) * kLd + 16 * kk + ((lane / 8) % 2) * 8);
        mma_bf16(s[j], qa, b[0], b[1]);
        mma_bf16(s[j + 1], qa, b[2], b[3]);
      }
    }
    // scale; mask where some row of the warp does not see the whole tile
    const bool whole = pa >= 0 && pb >= 0 && t0 + KT - 1 <= min(pa, pb) && t0 >= max(la, lb);
    if (__any_sync(kFull, !whole)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * t4 + (e & 1);
          const int pos = e < 2 ? pa : pb, low = e < 2 ? la : lb;
          s[j][e] = key <= pos && key >= low ? s[j][e] * scale : -INFINITY;
        }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    }

    if constexpr (PASS1) {  // each segment's maximum (a split, or a long page)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        x_a = fmaxf(x_a, fmaxf(s[j][0], s[j][1]));
        x_b = fmaxf(x_b, fmaxf(s[j][2], s[j][3]));
      }
      if ((t0 + KT) % seg == 0 || t0 + KT >= t_end) {
        x_a = quad_max(x_a);
        x_b = quad_max(x_b);
        if (t4 == 0 && lead) {
          float* dst = gmax + tile_id * BR * ngran + t0 / seg;
          dst[ra * ngran] = x_a;
          dst[rb * ngran] = x_b;
        }
        x_a = x_b = -INFINITY;
      }
      continue;  // the next iteration's barrier orders the ring
    }

    if constexpr (PG >= 16) {
#pragma unroll
      for (int a = 0; a < KT; a += PG) {  // one page at a time
        float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
        for (int j = a / 8; j < (a + PG) / 8; ++j) {
          xa = fmaxf(xa, fmaxf(s[j][0], s[j][1]));
          xb = fmaxf(xb, fmaxf(s[j][2], s[j][3]));
        }
        xa = quad_max(xa);
        xb = quad_max(xb);
        if (long_pages) {  // the whole page's maxima, from the first pass
          xa = fmaxf(xa, gr[ra * ngran + t0 / bs]);
          xb = fmaxf(xb, gr[rb * ngran + t0 / bs]);
        }
        open_page(xa, xb);
#pragma unroll
        for (int j = a / 8; j < (a + PG) / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - (e < 2 ? m_a : m_b));
            (e < 2 ? l_a : l_b) += pe;
            s[j][e] = pe;
          }
#pragma unroll
        for (int ks = a / 16; ks < (a + PG) / 16; ++ks) pv_step(vt, ks, s[2 * ks], s[2 * ks + 1]);
      }
    } else {  // pages of 1-8 keys: one product a page, the other keys' P zero
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        for (int a = 16 * ks; a < 16 * ks + 16; a += bs) {
          float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int off = 16 * ks + 8 * u + 2 * t4 + e;
              if (off >= a && off < a + bs) {
                xa = fmaxf(xa, s[2 * ks + u][e]);
                xb = fmaxf(xb, s[2 * ks + u][2 + e]);
              }
            }
          open_page(quad_max(xa), quad_max(xb));
          float pp[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int off = 16 * ks + 8 * u + 2 * t4 + (e & 1);
              const float x = s[2 * ks + u][e];
              const float pe = off >= a && off < a + bs && x != -INFINITY
                                   ? expf(x - (e < 2 ? m_a : m_b))
                                   : 0.f;
              (e < 2 ? l_a : l_b) += pe;
              pp[u][e] = pe;
            }
          pv_step(vt, ks, pp[0], pp[1]);
        }
    }
  }
  cp_async_wait<0>();
  if constexpr (PASS1) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  if (nsp == 1) {  // one split with work: the output itself
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (!row_out(r)) continue;
      const bool live = (half ? pb : pa) >= 0;
      const float l = half ? l_b : l_a;
      uint32_t* o = reinterpret_cast<uint32_t*>(out + row_off(r) + col0 + 2 * t4);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        o[4 * j] = live ? pack_bf16(acc[j][2 * half] / l, acc[j][2 * half + 1] / l) : 0u;
    }
    return;
  }

  // several splits: publish (m, l, acc); the last split to finish merges
  // them and re-arms the counter (threadfence-reduction pattern, as K1)
  float* pbase = part + tile_id * nsplit * BR * kPR;
  float* pp = pbase + (size_t)split * BR * kPR;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* row = pp + (size_t)(half ? rb : ra) * kPR;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(row + 4 + col0 + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    if (t4 == 0 && lead) {
      row[0] = half ? m_b : m_a;
      row[1] = half ? l_b : l_a;
    }
  }
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[tile_id], 1) == nsp - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each split's weight exp(m_split - m) per row, once (the ring is free);
  // then every four output columns are one weighted sum over the splits
  float* w_s = reinterpret_cast<float*>(smem);  // [BR, kMaxSplits]
  float* lsum_s = w_s + BR * kMaxSplits;     // [BR]
  for (int r = tid; r < BR; r += NTH) {
    float m = -INFINITY;
    for (int k = k_first; k <= k_last; ++k)
      m = fmaxf(m, __ldcg(pbase + ((size_t)k * BR + r) * kPR));
    float l = 0.f;
    for (int k = k_first; k <= k_last; ++k) {
      const float* src = pbase + ((size_t)k * BR + r) * kPR;
      const float mk = __ldcg(src);
      const float w = mk == -INFINITY ? 0.f : expf(mk - m);
      w_s[r * kMaxSplits + k - k_first] = w;
      l = fmaf(__ldcg(src + 1), w, l);
    }
    lsum_s[r] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < BR * (D / 4); idx += NTH) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    if (!row_out(r)) continue;
    uint2 v = make_uint2(0u, 0u);
    if (row_pos(r) >= 0) {
      const float* src = pbase + ((size_t)k_first * BR + r) * kPR + 4 + c;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int k = 0; k < nsp; ++k) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(src + (size_t)k * BR * kPR));
        const float w = w_s[r * kMaxSplits + k];
        a.x = fmaf(x.x, w, a.x);
        a.y = fmaf(x.y, w, a.y);
        a.z = fmaf(x.z, w, a.z);
        a.w = fmaf(x.w, w, a.w);
      }
      const float l = lsum_s[r];
      v = make_uint2(pack_bf16(a.x / l, a.y / l), pack_bf16(a.z / l, a.w / l));
    }
    *reinterpret_cast<uint2*>(out + row_off(r) + c) = v;
  }
  if (tid == 0) counters[tile_id] = 0;
}

template <typename C, int PG, int D>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache, const int* bt,
                   const int* qo, const int* kl, float* gmax, void* out, float* part,
                   int* counters, int p, int seq, int layer, int num_blocks, int hkv, int bs,
                   int nbmax, int group, float scale, int window, long long page, int rm,
                   int chunk, int nsplit, int seg, int ngran, cudaStream_t stream) {
  constexpr int KT = PG == 128 && D == 128 ? 128 : 64;
  const size_t smem = Layout<C, KT, D>::kBytes;
  const int tq = Geo<D>::BR / group;
  const dim3 grid(hkv * nsplit, p, (seq + tq - 1) / tq);
  auto run = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, NTH, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const C*>(k_cache),
        static_cast<const C*>(v_cache), bt, qo, kl, gmax, static_cast<__nv_bfloat16*>(out),
        part, counters, layer, num_blocks, hkv, bs, nbmax, seq, group, tq, scale, window,
        page, rm, chunk, nsplit, seg, ngran);
    return cudaGetLastError();
  };
  // the first pass (one instance a key tile): split maxima, or the maxima
  // of pages longer than the tile
  if (nsplit > 1 || bs > KT) {
    cudaError_t e = run(prefill_tc_kernel<C, KT, true, D>);
    if (e != cudaSuccess) return e;
  }
  return run(prefill_tc_kernel<C, PG, false, D>);
}

}  // namespace tc
}  // namespace xllm

// qtype bf16 at head_dim 128 (a bf16, int8 or e4m3 cache) or 256 (a bf16
// or e4m3 cache): the tensor-core kernel, BR = 128 query rows a block at
// head_dim 128 and 64 at 256, with nsplit <= 32 context splits of `chunk`
// positions (a multiple of the key tile, max(64, bs) up to bs 128 at
// head_dim 128 and 64 at 256, and of bs) and, when it splits or bs
// outgrows the key tile, gmax [tiles * BR, ngran] first-pass maxima per
// `seg` positions (bs if bs > the key tile, else chunk), part [tiles,
// nsplit, BR, 4 + D] and counters [tiles] (tiles = P * Hkv * ceil(S / (BR
// / group)), 0 between launches). Else (f32 q, or head_dim 64) the
// CUDA-core kernel, which takes no split (gmax, part, counters unused).
// bs divides 64 or is a multiple of it.
extern "C" int xllm_prefill_attention(int device, const void* q, const void* k_cache,
                                      const void* v_cache, const void* block_tables,
                                      const void* q_offsets, const void* kv_lens, void* gmax,
                                      void* out, void* part, void* counters, int dtype,
                                      int qtype, int head_dim, int p, int seq, int layer,
                                      int num_blocks, int hkv, int bs, int nbmax, int group,
                                      float scale, int window, long long page, int rm,
                                      int chunk, int nsplit, int seg, int ngran,
                                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (group < 1 || group > xllm::kRows || p > 65535 ||
      (bs > xllm::kTile ? bs % xllm::kTile : xllm::kTile % bs) ||
      page < (long long)hkv * bs * head_dim)
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* kl = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == XLLM_DTYPE_BF16 &&
      (head_dim == 128 ||
       (head_dim == 256 && (dtype == XLLM_DTYPE_BF16 || dtype == XLLM_DTYPE_E4M3)))) {
    const int kt = bs == 128 && head_dim == 128 ? 128 : 64;
    const long long width = (long long)nbmax * bs;
    if (nsplit < 1 || nsplit > xllm::tc::kMaxSplits || chunk <= 0 || chunk % kt ||
        chunk % bs || (long long)chunk * nsplit < width || seg <= 0 ||
        (bs > kt ? seg != bs : seg != chunk) || (long long)ngran * seg < width)
      return (int)cudaErrorInvalidValue;
    float* gm = static_cast<float*>(gmax);
    float* pt = static_cast<float*>(part);
    int* ct = static_cast<int*>(counters);
#define XLLM_TC_D(C, PG, D)                                                             \
  return (int)xllm::tc::launch<C, PG, D>(q, k_cache, v_cache, bt, qo, kl, gm, out, pt, ct, \
                                         p, seq, layer, num_blocks, hkv, bs, nbmax, group,  \
                                         scale, window, page, rm, chunk, nsplit, seg,       \
                                         ngran, s)
#define XLLM_TC(C, PG) XLLM_TC_D(C, PG, 128)
#define XLLM_TC_TILES(C)                   \
  if (bs == 16) XLLM_TC(C, 16);            \
  if (bs == 32) XLLM_TC(C, 32);            \
  if (bs == 128) XLLM_TC(C, 128);          \
  if (bs < 16) XLLM_TC(C, 0);              \
  XLLM_TC(C, 64);
#define XLLM_TC_256(C)                     \
  if (bs == 16) XLLM_TC_D(C, 16, 256);     \
  if (bs == 32) XLLM_TC_D(C, 32, 256);     \
  if (bs < 16) XLLM_TC_D(C, 0, 256);       \
  XLLM_TC_D(C, 64, 256);
    if (head_dim == 256) {  // bf16 or e4m3 cache; pages past 64 keys take the first pass
      if (dtype == XLLM_DTYPE_BF16) { XLLM_TC_256(__nv_bfloat16) }
      XLLM_TC_256(xllm::e4m3)
    }
    if (dtype == XLLM_DTYPE_BF16) { XLLM_TC_TILES(__nv_bfloat16) }
    if (dtype == XLLM_DTYPE_I8) { XLLM_TC_TILES(int8_t) }
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_TC_TILES(xllm::e4m3) }
#undef XLLM_TC_256
#undef XLLM_TC_TILES
#undef XLLM_TC
#undef XLLM_TC_D
    return (int)cudaErrorInvalidValue;
  }
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
  // head_dim 256 on the CUDA cores: f32 q on an f32 or e4m3 cache (bf16
  // takes the tensor cores above)
  if (qtype == XLLM_DTYPE_F32 && head_dim == 256) {
    if (dtype == XLLM_DTYPE_F32) XLLM_LAUNCH(float, float, 256);
    if (dtype == XLLM_DTYPE_E4M3) XLLM_LAUNCH(float, xllm::e4m3, 256);
  }
  XLLM_CACHES(__nv_bfloat16, XLLM_DTYPE_BF16)
  XLLM_CACHES(float, XLLM_DTYPE_F32)
#undef XLLM_CACHES
#undef XLLM_HEAD_DIMS
#undef XLLM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
