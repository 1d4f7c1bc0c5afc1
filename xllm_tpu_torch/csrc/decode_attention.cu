// K1: fused KV write + paged GQA decode attention.
//
// Replaces xllm_tpu/ops/pallas/decode_attention.py
// paged_decode_attention_write_v9_tpu (same contract: write each
// sequence's new K/V row at slot_mapping into the split cache at
// layer_idx, in place, then attend q over seq_lens tokens through
// block_tables with an f32 softmax and an optional sliding window; a row
// with seq_len 0 writes nothing and outputs zeros).
//
// K1b and K12 (decode_attention.py paged_decode_attention_write_v5_tpu;
// legacy/decode_attention.py v1, v3, v4, v6, v7, v8, v10) have the same
// contract and differ from K1 in two parameters of the walk below, which
// the kernels take: the rounding tile of vt = G * block_size positions
// (v9: G = 4, or T of v9tT), and where the new token joins the softmax
// (MODE, a template parameter):
// - kModeOpen (v5-v10): the softmax opens at the new token (below);
// - kModeLast (v3, v4): the walk opens empty over the cached positions
//   (its running maxima exclude the new token's score); the new token
//   joins after them as one unrounded f32 column, exp(s_new - M_f);
// - kModeCache (v1, no window): the new row is written and attended at
//   position seq_len - 1 like a cached one, with the bytes the writer
//   stores, cast to the cache dtype and upcast back. Blocks take them from
//   the inputs (put_new_row): another block or split may not have written
//   the row yet. Pass 1's maxima then include that position.
// A granule (pass 1) divides both the 64-position tile and vt:
// gcd(vt, 64) positions (K9: gcd(bs, 64)). A tile wholly masked before
// the walk's first attended position (kModeLast below a window, or a lone
// tail page at seq_len 1) is empty: its running maximum is -inf and its
// scores too (the TPU's -1e30 mask gives it P = 1, which the next finite
// maximum's rescale exp(-1e30 - m) = 0 washes out: the same result).
//
// What bounds it: bytes. One decode step reads every live K/V row once
// (B x ctx x Hkv x D x 2 tensors) and does ~4 flops per byte, far below the
// ~295 flops/byte at which an H100's tensor cores would take over, so the
// design is about keeping enough loads in flight and reading each row once:
// - one block per (sequence, kv head, context split) holds the head's G
//   query rows, so each K/V row is fetched once for all G heads that share
//   it (GQA costs no extra bytes);
// - the context is cut into splits of `chunk` positions (a multiple of the
//   64-row tile, chosen by the wrapper so that there are at most 16), so a
//   batch of 16 sequences x 8 kv heads keeps several blocks on every SM
//   instead of one long serial walk per (sequence, head): the latency of
//   one block's tile loads hides behind the others' math;
// - the walk starts at the window's lower edge and stops at seq_len, so no
//   dead page is read; l and acc (f32, shared memory) are kept in a frame
//   m per row (below); a split publishes (m, l, acc) to a small f32
//   scratch and the last split of a (sequence, head) to finish adds them
//   up with weights exp(m - max m) (a threadfence reduction on a
//   per-(sequence, head) counter that the merging block re-arms to 0).
// Not yet done: a cp.async/TMA ring inside a block.
//
// An f32 cache rounds nothing: its walk is one pass with an online
// maximum, the frame m being the split's running maximum (acc and l
// rescaled by exp(m_old - m_new) where a tile raises it).
//
// Rounding P (every other cache, whose V tile is bf16): the TPU
// kernel walks a sequence in one program, in tiles of vt = G pages (v9:
// 4) from position 0, opens its softmax at the new token (m = q.k_new * scale,
// l = 1, acc = v_new: the new token is attended as given, never read back
// from the cache) and rounds the unnormalised P of each tile to bf16
// against its running maximum after that tile. A context split does not
// see the maxima of the splits before it, so the op runs in two passes:
// - pass 1 (decode_granule_max_kernel) computes the maximum score of each
//   (query row, granule) of the cached positions, a granule being
//   gcd(vt, 64) positions, so each is written by one block;
// - pass 2 (the walk) takes, for each position, the running maximum M of
//   its rounding tile (the new token's score and every granule up to the
//   tile's end) and the row's final maximum M_f, and adds
//   bf16(exp(s - M)) * exp(M - M_f) to P, exp(s - M) * exp(M - M_f) to l,
//   in the final frame (m = M_f in every split, so the merge weights are
//   all exp(0) = 1).
// Pass 1 reads K a second time: a correct kernel first; folding the
// granule maxima into one pass is later work (PERF.md).
//
// Write, then read: no block reads position seq_len - 1 from the cache
// (the new token is attended as given, or kModeCache's taken from the
// inputs), so the split that holds it stores the new row
// (cast to the cache dtype) at any point. Sequences never share a page
// that is written (shared prefix pages are full and read-only).
//
// K8 and K9: the same kernels serve the interleaved cache [L, NB, 2, Hkv,
// bs, D] (PageLayout in common.cuh: another page stride, V Hkv * bs * D
// after K):
// - K8 replaces decode_attention.py paged_decode_attention_write_v11_tpu,
//   K1's contract and walk on that cache (the TPU kernel's one-DMA pages
//   and block-contiguous bursts are its design, not its contract);
// - K9 replaces paged_decode_attention_write_v12_tpu (rm = 1): a
//   sequence's incomplete tail page, from position nfull * bs (nfull =
//   (seq_len - 1) / bs complete pages), holds token-major content, read
//   through PageLayout::tail_from. The TPU walk takes tiles of G full
//   pages, then the tail page as a tile of its own, so the running maximum
//   of a position is that at the end of its tile clipped to nfull * bs,
//   or, in the tail, the row's final one. Pass 1's granules are then
//   gcd(bs, 64) positions, so that nfull * bs is a granule boundary. The new row goes to row w = slot % bs of its page seen as
//   [bs, 2 * Hkv, D] (each head block writes its own two D-vectors, which
//   no block of the launch reads: they are the position seq_len - 1).
//   When the row completes the page (w == bs - 1) the page must be
//   rewritten canonical, [2, Hkv, bs, D]. That moves every head's rows,
//   which the other head blocks and context splits of the sequence are
//   still reading token-major, so no block of the walk writes the page:
//   the block that would write head h's new row instead stages head h's
//   canonical K and V planes (its bs - 1 cached rows, read, and the new
//   row) in a scratch page of the sequence's own, and a third launch
//   (rm_complete_kernel, several blocks per sequence) copies the scratch
//   page over the page. It starts only once the walk's launch has ended
//   (the same stream), so every read of the token-major page is done:
//   race-free by stream order. Each head block writes only its own planes
//   of the scratch page.
#include "common.cuh"

namespace xllm {

template <typename T, int D>
__device__ __forceinline__ float dot_q_k(const float* q, const T* k) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 2) {
    const float2 kv = load2(k + d);
    const float2 qv = *reinterpret_cast<const float2*>(q + d);
    s = fmaf(qv.x, kv.x, s);
    s = fmaf(qv.y, kv.y, s);
  }
  return s;
}

// Scores of the G query rows against the tile's rows [jlo, jhi) into
// ss [G, kTile] (-inf elsewhere). Both passes call it on the same inputs,
// so pass 1's maxima are bit-equal to pass 2's scores.
template <typename S, int D>
__device__ __forceinline__ void tile_scores(float* ss, const float* qs, const S* ks,
                                            int group, int jlo, int jhi, float scale) {
  for (int i = threadIdx.x; i < group * kTile; i += blockDim.x) {
    const int g = i / kTile, j = i % kTile;
    ss[i] = (j >= jlo && j < jhi)
                ? dot_q_k<S, D>(qs + g * D, ks + j * (D + kPad)) * scale
                : -INFINITY;
  }
}

// A block's share of a sequence: the split-th chunk of the live positions
// [lo, seq_len), from the tile below the window's edge.
struct SplitRange {
  int lo, base, nsp, t_begin, t_end;
};
__device__ __forceinline__ SplitRange split_range(int seq_len, int window, int chunk,
                                                  int split) {
  SplitRange r;
  r.lo = window > 0 ? max(seq_len - window, 0) : 0;
  r.base = (r.lo / kTile) * kTile;
  r.nsp = (seq_len - r.base + chunk - 1) / chunk;  // splits with work
  r.t_begin = r.base + split * chunk;
  r.t_end = min(r.t_begin + chunk, seq_len);
  return r;
}

// K9's first token-major position: the start of the tail page, after the
// nfull = (seq_len - 1) / bs complete pages (INT_MAX for K1 / K8)
__device__ __forceinline__ int tail_start(int seq_len, int bs, int rm) {
  return rm ? (seq_len - 1) / bs * bs : INT_MAX;
}

// The lane of granule_prefix's view that holds pos's running maximum: the
// end of its rounding tile (vt positions), clipped, for K9, to the full
// pages; in K9's tail the row's last granule.
__device__ __forceinline__ int end_lane(int t0, int pos, int vt, int gran, int gend,
                                        int tail_from) {
  const int end = pos >= tail_from
                      ? gend
                      : min((pos / vt + 1) * vt / gran, min(gend, tail_from / gran));
  return end - t0 / gran - 1;
}

constexpr int kModeOpen = 0, kModeLast = 1, kModeCache = 2;

// kModeCache: tile row j holds position seq_len - 1, the new token's K
// (and V) row as the writer stores it (cast to the cache dtype C) and the
// walk reads it (upcast to the tile type S), taken from the inputs.
template <typename T, typename C, typename S, int D>
__device__ __forceinline__ void put_new_row(S* ks, S* vs, const T* kn, const T* vn, int j) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    if constexpr (kQuantCache<C>) {
      ks[j * (D + kPad) + d] = from_float<S>(cache_to_float(to_cache<C>(to_float(kn[d]))));
      if (vs) vs[j * (D + kPad) + d] = from_float<S>(cache_to_float(to_cache<C>(to_float(vn[d]))));
    } else {
      ks[j * (D + kPad) + d] = kn[d];
      if (vs) vs[j * (D + kPad) + d] = vn[d];
    }
  }
}

template <typename S, int D>
size_t decode_smem_bytes(int group) {
  return 2 * (size_t)kTile * (D + kPad) * sizeof(S) +
         ((size_t)group * (2 * D + kTile) + 4 * group) * sizeof(float);
}

// Pass 1: gmax[b, hq, k] = the largest score of query row hq over the
// attended positions of granule k (-inf for none): the cached ones
// (kModeCache: and seq_len - 1). Each block writes the granules of its
// split's tiles, the tile holding seq_len - 1 included.
template <typename T, typename C, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    decode_granule_max_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                              const C* __restrict__ k_cache,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ seq_lens,
                              float* __restrict__ gmax,  // [B, Hq, ngran]
                              int layer, int num_blocks, int hkv, int bs, int nbmax,
                              int group, float scale, int window, int chunk, int gran,
                              int ngran, long long page, int rm) {
  using S = typename TileOf<C>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ks = reinterpret_cast<S*>(smem);
  float* qs = reinterpret_cast<float*>(ks + 2 * kTile * (D + kPad));  // [G, D]
  float* ss = qs + 2 * group * D;                                     // [G, kTile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hq = hkv * group;
  const int seq_len = seq_lens[b];
  if (seq_len <= 0) return;
  const SplitRange r = split_range(seq_len, window, chunk, split);
  if (split >= r.nsp) return;
  const PageLayout lay{page, tail_start(seq_len, bs, rm)};
  const size_t qrow = ((size_t)b * hq + (size_t)h * group) * D;
  for (int i = threadIdx.x; i < group * D; i += blockDim.x) qs[i] = to_float(q[qrow + i]);
  float* gm = gmax + ((size_t)b * hq + (size_t)h * group) * ngran;
  const int* bt = block_tables + (size_t)b * nbmax;
  const T* kn = k_new + ((size_t)b * hkv + h) * D;
  for (int t0 = r.t_begin; t0 < r.t_end; t0 += kTile) {
    const int jlo = max(r.lo - t0, 0);
    const int jc = max(min(seq_len - 1 - t0, kTile), 0);  // cached positions
    const int jhi = MODE == kModeCache ? min(seq_len - t0, kTile) : jc;
    if (jc > jlo)
      load_tile<C, D, false>(ks, nullptr, k_cache, nullptr, lay, bt, layer, num_blocks,
                             hkv, h, bs, t0, jlo, jc);
    if (jhi > jc) put_new_row<T, C, S, D>(ks, nullptr, kn, nullptr, jc);
    __syncthreads();
    tile_scores<S, D>(ss, qs, ks, group, jlo, jhi, scale);
    __syncthreads();
    for (int g = warp; g < group; g += nwarps) {  // a warp a row
      const float v[2] = {ss[g * kTile + lane], ss[g * kTile + lane + 32]};
      write_granules<2>(gm + (size_t)g * ngran, v, t0, gran, lane);
    }
    __syncthreads();
  }
}

// Pass 2: the walk (see the head of this file).
template <typename T, typename C, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    decode_attention_write_kernel(const T* __restrict__ q,      // [B, Hq, D]
                                  const T* __restrict__ k_new,  // [B, Hkv, D]
                                  const T* __restrict__ v_new,
                                  C* k_cache, C* v_cache,  // pages: PageLayout
                                  const int* __restrict__ slot_mapping,  // [B]
                                  const int* __restrict__ block_tables,  // [B, nbmax]
                                  const int* __restrict__ seq_lens,      // [B]
                                  const float* __restrict__ gmax,  // [B, Hq, ngran]
                                  T* __restrict__ out,             // [B, Hq, D]
                                  float* part,    // [B, Hkv, nsplit, G, 2 + D]
                                  int* counters,  // [B * Hkv], 0 between launches
                                  int layer, int num_blocks, int hkv, int bs,
                                  int nbmax, int group, float scale, int window,
                                  int chunk, int nsplit, int gran, int ngran,
                                  long long page, int rm, int vt,
                                  C* scratch) {  // [B, page] (K9 completions)
  using S = typename TileOf<C>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ks = reinterpret_cast<S*>(smem);
  S* vs = ks + kTile * (D + kPad);
  float* qs = reinterpret_cast<float*>(vs + kTile * (D + kPad));  // [G, D]
  float* acc = qs + group * D;                                    // [G, D]
  float* ss = acc + group * D;                                    // [G, kTile]
  float* mpre = ss + group * kTile;  // [G] running maximum before the tile
  float* mfin = mpre + group;  // [G] the frame m: the row's final maximum (rounding P)
                               // or the split's running maximum (f32 cache)
  float* ls = mfin + group;    // [G] l, in that frame
  float* wnew = ls + group;    // [G] the new token's weight, then acc's rescale (f32)
  __shared__ int is_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const int hq = hkv * group;
  const int seq_len = seq_lens[b];
  const size_t qrow = ((size_t)b * hq + (size_t)h * group) * D;
  T* o = out + qrow;
  if (seq_len <= 0) {  // padded row: no write, zero output
    if (split == 0)
      for (int i = tid; i < group * D; i += blockDim.x) o[i] = from_float<T>(0.f);
    return;
  }
  const SplitRange r = split_range(seq_len, window, chunk, split);
  if (split >= r.nsp) return;
  // the cached positions (kModeCache: and the new one)
  const int t_walk = MODE == kModeCache ? r.t_end : min(r.t_end, seq_len - 1);
  const PageLayout lay{page, tail_start(seq_len, bs, rm)};

  const T* kn = k_new + ((size_t)b * hkv + h) * D;
  const T* vn = v_new + ((size_t)b * hkv + h) * D;
  const int slot = slot_mapping[b];
  if (split == r.nsp - 1 && rm && slot % bs == bs - 1) {
    // K9, the row completes its page: head h's canonical K and V planes
    // (rows read token-major, the new row cast in) to scratch[b], which
    // rm_complete_kernel copies over the page after this launch
    constexpr int kVec = 16 / sizeof(C);  // elements per 16 bytes
    constexpr int kRowVecs = D / kVec;
    const C* pg = k_cache + ((size_t)layer * num_blocks + slot / bs) * page;
    C* st = scratch + (size_t)b * page;
    for (int i = tid; i < 2 * bs * kRowVecs; i += blockDim.x) {
      const int half = i / (bs * kRowVecs), w = i / kRowVecs % bs, u = i % kRowVecs;
      const int c = half * hkv + h;  // the plane: K heads, then V heads
      uint4* dst = reinterpret_cast<uint4*>(st + ((size_t)c * bs + w) * D) + u;
      if (w < bs - 1) {
        *dst = reinterpret_cast<const uint4*>(pg + ((size_t)w * 2 * hkv + c) * D)[u];
      } else {
        const T* src = (half ? vn : kn) + u * kVec;
        alignas(16) C vals[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if constexpr (kQuantCache<C>)
            vals[e] = to_cache<C>(to_float(src[e]));
          else
            vals[e] = src[e];
        }
        *dst = *reinterpret_cast<const uint4*>(vals);
      }
    }
  } else if (split == r.nsp - 1) {  // the new row, cast to the cache dtype
    // (K9: token-major at its slot)
    const PageLayout wl{page, rm ? 0 : INT_MAX};
    C *kw, *vw;
    kv_rows(wl, k_cache, v_cache, layer, num_blocks, hkv, bs, D, slot / bs, h, slot, kw,
            vw);
    for (int d = tid; d < D; d += blockDim.x) {
      if constexpr (kQuantCache<C>) {
        kw[d] = to_cache<C>(to_float(kn[d]));
        vw[d] = to_cache<C>(to_float(vn[d]));
      } else {
        kw[d] = kn[d];
        vw[d] = vn[d];
      }
    }
  }
  for (int i = tid; i < group * D; i += blockDim.x) qs[i] = to_float(q[qrow + i]);
  __syncthreads();

  // per row: the new token's score opens the running maximum (kModeLast:
  // joins the final one; kModeCache: neither, the position is walked).
  // Rounding P: the final maximum and the maximum before this split's
  // first tile from pass 1; an f32 cache: split 0's frame opens at the new
  // token, the others' (and kModeCache's) at the first tile
  const float* gm = gmax + ((size_t)b * hq + (size_t)h * group) * ngran;
  const int g0 = r.base / gran;
  const int gend = (seq_len + kTile - 1) / kTile * kTile / gran;  // pass 1 wrote [g0, gend)
  for (int g = warp; g < group; g += nwarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[g * D + d], to_float(kn[d]), s);
    s = warp_sum(s) * scale;
    float mf = split == 0 && MODE != kModeCache ? s : -INFINITY, mp = s;
    if constexpr (kRoundP<C>) {
      mf = mp = -INFINITY;
      for (int k = g0 + lane; k < gend; k += 32) {
        const float x = gm[(size_t)g * ngran + k];
        mf = fmaxf(mf, x);
        if (k < r.t_begin / gran) mp = fmaxf(mp, x);
      }
      mf = warp_max(mf);
      mp = warp_max(mp);
      if (MODE != kModeCache) mf = fmaxf(mf, s);
      if (MODE == kModeOpen) mp = fmaxf(mp, s);
    }
    if (lane == 0) {
      mfin[g] = mf;
      mpre[g] = mp;
      // split 0 adds the new token (not kModeCache: it is walked)
      wnew[g] = split == 0 && MODE != kModeCache ? expf(s - mf) : 0.f;
      ls[g] = wnew[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += blockDim.x)
    acc[i] = wnew[i / D] * to_float(vn[i % D]);

  // walk [t_begin, t_walk), kTile at a time
  const int* bt = block_tables + (size_t)b * nbmax;
  for (int t0 = r.t_begin; t0 < t_walk; t0 += kTile) {
    const int jlo = max(r.lo - t0, 0);
    const int jhi = min(t_walk - t0, kTile);
    const int jc = MODE == kModeCache ? max(min(seq_len - 1 - t0, jhi), 0) : jhi;
    load_tile<C, D>(ks, vs, k_cache, v_cache, lay, bt, layer, num_blocks, hkv, h, bs, t0,
                    jlo, jc);
    if (jhi > jc) put_new_row<T, C, S, D>(ks, vs, kn, vn, jc);
    __syncthreads();
    tile_scores<S, D>(ss, qs, ks, group, jlo, jhi, scale);
    __syncthreads();
    for (int g = warp; g < group; g += nwarps) {
      float* srow = ss + g * kTile;
      if constexpr (!kRoundP<C>) {  // the frame moves to the tile's maximum
        const float x0 = srow[lane], x1 = srow[lane + 32];
        const float mo = mfin[g], mn = fmaxf(mo, warp_max(fmaxf(x0, x1)));
        const float p0 = x0 == -INFINITY ? 0.f : expf(x0 - mn);
        const float p1 = x1 == -INFINITY ? 0.f : expf(x1 - mn);
        srow[lane] = p0;
        srow[lane + 32] = p1;
        const float lsum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = mn == -INFINITY ? 1.f : expf(mo - mn);
          ls[g] = ls[g] * alpha + lsum;
          mfin[g] = mn;
          wnew[g] = alpha;  // acc's rescale, below
        }
        continue;
      }
      // lane k: the running maximum through granule t0 / gran + k
      const float pre = granule_prefix(gm + (size_t)g * ngran + t0 / gran, mpre[g], t0,
                                       kTile, vt, gran, gend, lane);
      const float mf = mfin[g];
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u, pos = t0 + j;
        const float sc = srow[j];
        // the running maximum at the end of pos's rounding tile (K9: or tail)
        const float m = __shfl_sync(0xffffffffu, pre,
                                    end_lane(t0, pos, vt, gran, gend, lay.tail_from));
        float p = 0.f;
        if (sc != -INFINITY) {
          const float pe = expf(sc - m), w = expf(m - mf);
          lsum += pe * w;
          p = round_bf16(pe) * w;
        }
        srow[j] = p;
      }
      lsum = warp_sum(lsum);
      // this tile's granules join the prefix
      const float mt = __shfl_sync(0xffffffffu, pre, tile_lane(t0, kTile, gran, gend));
      if (lane == 0) {
        ls[g] += lsum;
        mpre[g] = mt;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* p = ss + g * kTile;
      float a = acc[i];
      if constexpr (!kRoundP<C>) a *= wnew[g];
      for (int j = jlo; j < jhi; ++j) a = fmaf(p[j], to_float(vs[j * (D + kPad) + d]), a);
      acc[i] = a;
    }
    __syncthreads();
  }
  __syncthreads();
  if (r.nsp == 1) {
    for (int i = tid; i < group * D; i += blockDim.x)
      o[i] = from_float<T>(acc[i] / ls[i / D]);
    return;
  }

  // several splits: publish (m, l, acc); the last split to finish adds
  // them up (threadfence-reduction pattern) and re-arms the counter
  float* pb = part + (((size_t)b * hkv + h) * nsplit) * group * (2 + D);
  float* pp = pb + (size_t)split * group * (2 + D);
  for (int i = tid; i < group * D; i += blockDim.x)
    pp[(i / D) * (2 + D) + 2 + i % D] = acc[i];
  for (int g = tid; g < group; g += blockDim.x) {
    pp[g * (2 + D)] = mfin[g];
    pp[g * (2 + D) + 1] = ls[g];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[b * hkv + h], 1) == r.nsp - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < group * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float m = -INFINITY, l = 0.f, a = 0.f;
    for (int s = 0; s < r.nsp; ++s) m = fmaxf(m, __ldcg(pb + ((size_t)s * group + g) * (2 + D)));
    for (int s = 0; s < r.nsp; ++s) {
      const float* ps = pb + ((size_t)s * group + g) * (2 + D);
      const float w = expf(__ldcg(ps) - m);  // split 0's frame is finite
      l += __ldcg(ps + 1) * w;
      a += __ldcg(ps + 2 + d) * w;
    }
    o[i] = from_float<T>(a / l);
  }
  if (tid == 0) counters[b * hkv + h] = 0;
}

constexpr int kCompleteThreads = 256;
constexpr int kCompleteBlocks = 16;  // blocks per sequence

// K9's completion rewrite (the head of this file): for each sequence whose
// new row completes its page, the staged canonical page scratch[b] over the
// page, 16 bytes a thread and step, kCompleteBlocks blocks a sequence.
__global__ void __launch_bounds__(kCompleteThreads)
    rm_complete_kernel(uint4* kv_cache,  // [L, NB, 2, Hkv, bs, D] as 16-byte units
                       const int* __restrict__ slot_mapping,
                       const int* __restrict__ seq_lens, const uint4* __restrict__ scratch,
                       int layer, int num_blocks, int bs, long long page_units) {
  const int b = blockIdx.x;
  const int slot = slot_mapping[b];
  if (seq_lens[b] <= 0 || slot % bs != bs - 1) return;
  uint4* pg = kv_cache + ((size_t)layer * num_blocks + slot / bs) * page_units;
  const uint4* st = scratch + (size_t)b * page_units;
  for (long long i = blockIdx.y * blockDim.x + threadIdx.x; i < page_units;
       i += (long long)gridDim.y * blockDim.x)
    pg[i] = st[i];
}

template <typename T, typename C, int D, int MODE>
cudaError_t launch_decode(const void* q, const void* k_new, const void* v_new,
                          void* k_cache, void* v_cache, const int* slot_mapping,
                          const int* block_tables, const int* seq_lens, float* gmax,
                          void* out, float* part, int* counters, int batch,
                          int layer, int num_blocks, int hkv, int bs, int nbmax,
                          int group, float scale, int window, int chunk,
                          int nsplit, int gran, int ngran, long long page, int rm,
                          int vt, void* scratch, cudaStream_t stream) {
  using S = typename TileOf<C>::type;
  const size_t smem = decode_smem_bytes<S, D>(group);
  auto pass2 = decode_attention_write_kernel<T, C, D, MODE>;
  cudaError_t e = allow_smem(pass2, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nsplit, hkv, batch);
  if constexpr (kRoundP<C>) {  // an f32 cache rounds nothing: no pass 1
    auto pass1 = decode_granule_max_kernel<T, C, D, MODE>;
    e = allow_smem(pass1, smem);
    if (e != cudaSuccess) return e;
    pass1<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const C*>(k_cache), block_tables, seq_lens,
        gmax, layer, num_blocks, hkv, bs, nbmax, group, scale, window, chunk, gran, ngran,
        page, rm);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  pass2<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<C*>(k_cache),
      static_cast<C*>(v_cache), slot_mapping, block_tables, seq_lens, gmax,
      static_cast<T*>(out), part, counters, layer, num_blocks, hkv, bs, nbmax,
      group, scale, window, chunk, nsplit, gran, ngran, page, rm, vt,
      static_cast<C*>(scratch));
  e = cudaGetLastError();
  if (e != cudaSuccess || !rm) return e;
  rm_complete_kernel<<<dim3(batch, kCompleteBlocks), kCompleteThreads, 0, stream>>>(
      static_cast<uint4*>(k_cache), slot_mapping, seq_lens,
      static_cast<const uint4*>(scratch), layer, num_blocks, bs,
      page * (long long)sizeof(C) / 16);
  return cudaGetLastError();
}

}  // namespace xllm

// vt: the rounding tile, G * bs positions; gran: gcd(vt, 64) positions
// (K9, rm: gcd(bs, 64)); ngran: gmax's columns, at least
// ceil(nbmax * bs / 64) * 64 / gran. page: elements from one (layer,
// block) page to the next (PageLayout); rm: K9's row-major tails, whose
// completed pages are staged in scratch [batch, page] (else unused). mode:
// kModeOpen, kModeLast or kModeCache (no window, not rm).
extern "C" int xllm_decode_attention_write(
    int device, const void* q, const void* k_new, const void* v_new,
    void* k_cache, void* v_cache, const void* slot_mapping,
    const void* block_tables, const void* seq_lens, void* gmax, void* out, void* part,
    void* counters, int dtype, int qtype, int head_dim, int batch, int layer,
    int num_blocks, int hkv, int bs, int nbmax, int group, float scale,
    int window, int chunk, int nsplit, int gran, int ngran, long long page, int rm,
    int vt, int mode, void* scratch, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int span = rm ? bs : vt;  // a granule divides it and the tile
  int g = xllm::kTile;
  for (int a = span; a % g;) {  // gcd(span, kTile)
    const int t = a % g;
    a = g;
    g = t;
  }
  if (chunk <= 0 || chunk % xllm::kTile || batch > 65535 || vt <= 0 || vt % bs ||
      gran != g || (xllm::kTile + vt - gran) / gran > 32 ||
      (long long)ngran * gran < ((long long)nbmax * bs + xllm::kTile - 1) / xllm::kTile * xllm::kTile ||
      page < (long long)hkv * bs * head_dim || mode < xllm::kModeOpen ||
      mode > xllm::kModeCache || (mode == xllm::kModeCache && (window > 0 || rm)))
    return (int)cudaErrorInvalidValue;
  const int* sm = static_cast<const int*>(slot_mapping);
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* pt = static_cast<float*>(part);
  float* gm = static_cast<float*>(gmax);
  int* ct = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XLLM_LAUNCH_MODE(T, C, D, M)                                              \
  return (int)xllm::launch_decode<T, C, D, M>(q, k_new, v_new, k_cache, v_cache, sm, \
                                              bt, sl, gm, out, pt, ct, batch, layer, \
                                              num_blocks, hkv, bs, nbmax, group,     \
                                              scale, window, chunk, nsplit, gran,    \
                                              ngran, page, rm, vt, scratch, s)
#define XLLM_LAUNCH(T, C, D)                                             \
  {                                                                      \
    if (mode == xllm::kModeOpen) XLLM_LAUNCH_MODE(T, C, D, xllm::kModeOpen); \
    if (mode == xllm::kModeLast) XLLM_LAUNCH_MODE(T, C, D, xllm::kModeLast); \
    XLLM_LAUNCH_MODE(T, C, D, xllm::kModeCache);                           \
  }
#define XLLM_HEAD_DIMS(T, C)                      \
  if (head_dim == 128) XLLM_LAUNCH(T, C, 128);     \
  if (head_dim == 64) XLLM_LAUNCH(T, C, 64);
#define XLLM_CACHES(T, TCODE)                                               \
  if (qtype == TCODE) {                                                     \
    if (dtype == TCODE) { XLLM_HEAD_DIMS(T, T) }                            \
    if (dtype == XLLM_DTYPE_I8) { XLLM_HEAD_DIMS(T, int8_t) }               \
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_HEAD_DIMS(T, xllm::e4m3) }         \
  }
  XLLM_CACHES(__nv_bfloat16, XLLM_DTYPE_BF16)
  XLLM_CACHES(float, XLLM_DTYPE_F32)
#undef XLLM_CACHES
#undef XLLM_HEAD_DIMS
#undef XLLM_LAUNCH
#undef XLLM_LAUNCH_MODE
  return (int)cudaErrorInvalidValue;
}
