// K11a, and K11b / K11e with f32 q: latent (MLA) paged attention.
//
// Replaces, with csrc/mla_prefill.cu, Pallas kernels of
// xllm_tpu/ops/pallas/mla_attention.py:
//   K11a mla_decode_attention_write_tpu: write each sequence's new latent
//        row lat_new [B, Dk] at slot_mapping into the single-head cache
//        [L, NB, 1, bs, Dk] (in place), then attend q [B, H, Dk] over
//        seq_lens tokens -> [B, H, dv];
//   K11b mla_prefill_attention_batched_tpu: P chunks q [P, S, H, Dk], causal
//        at q_offsets[p] + t over kv_lens[p] tokens -> [P, S, H, dv] (here
//        with f32 q only; bf16 q runs csrc/mla_prefill.cu).
// Absorbed MLA is an MQA over one latent head: the scores take all Dk lanes
// of a cached row, the values its first dv lanes, so one row read feeds
// both products. A row with kv_len 0 (a padded row) and a query row past
// its chunk's ntok = kv_len - q_offset (bucket padding) come out as zeros,
// by design: the TPU kernels mask (kv <= row_pos) & (kv < kv_len), so a
// bucket-padding row there attends to all of [0, kv_len), a result that
// nothing reads. Launched with one chunk, the prefill contract is also
// mla_prefill_attention_tpu's (K11e, counted apart by
// ops/cuda/mla_attention.py).
//
// bf16 q on a prefill chunk runs csrc/mla_prefill.cu (wgmma + TMA); this
// file keeps the bf16 decode kernel and the f32-q kernel of both contracts.
// Rows are the (token, head) pairs of a chunk, token-major (row r = t * H +
// h, the layout of q), and a decode step is a chunk of one token at
// q_offset = seq_len - 1. All H heads of a token share the latent rows, so
// (tokens x heads) fold into the M dimension of the products, as the TPU
// kernel's hg * tq rows do.
//
// What bounds decode: bytes. A step reads every live latent row once (16
// sequences x ~550 tokens x 640 lanes x 2 B = 11.3 MB a layer at
// DeepSeek-V2-Lite's shapes) for ~2 x 16 x 1088 flops a row.
//
// Design, bf16 q (decode, tensor cores; a bf16 or an fp8 latent cache): a
// block owns 16 rows (one m16 tile: a token's 16 heads at V2-Lite) and
// walks its KV range KT = 64 tokens at a time through a two-stage cp.async ring in
// shared memory. Per tile, eight warps compute S = Q K^T with mma.sync
// m16n8k16 (f32 accumulators; K rows feed the B operand through ldmatrix,
// V the same rows through ldmatrix.trans), an online softmax in f32 per
// row, P rounded to bf16 (below), and P V with the dv columns split across
// the warps (64 each at dv 512). Decode splits each sequence's context
// across blocks (as K1 does), since 16 sequences are far fewer blocks than
// the card has SMs; the last split to finish merges the partial (m, l,
// acc) with per-row weights computed once and 16-byte loads.
//
// The new decode row: the tile loader takes position seq_len - 1 from
// lat_new, never from the cache, and the block that owns that position
// (row tile 0) stores the row into the cache. No block reads that cache row.
//
// f32 q (tests and the parity models; an f32 or an fp8 latent cache; decode
// and prefill): the same walk with FMA on the CUDA cores, no TF32, no
// context split.
//
// fp8 (e4m3) latent cache: its rows are upcast to bf16 (tensor cores) or
// f32 on their way into shared memory, as the TPU kernels upcast pages
// before both products; q and the output keep their own dtype. The
// tensor-core tile loads then go through registers (16 bytes a lane,
// converted, two 16-byte stores) rather than cp.async. The new decode row
// arrives cast to e4m3 with the JAX package's bytes and is attended as
// stored, as the TPU kernel attends the page it patched.
//
// Rounding P, on every cache but f32: the TPU kernels round the
// unnormalised P of each page to bf16 against the row's running maximum
// after that page, in one walk from position 0. A launch of one context
// split over pages no longer than its tile takes those maxima in its walk:
// each tile's page maxima, prefix-maxed over the warp's lanes. Any other
// launch (a decode that splits its context, pages longer than the tile)
// runs two passes of one kernel template: pass 1 (PASS1) computes S as pass
// 2 does (the same code on the same data, so the same bits) and writes the
// maximum of each (row, granule) of min(block_size, tile) positions; pass 2
// prefetches each tile's granules with its latent rows and takes, for each
// key, the running maximum M at the end of its page. Pages are at least 16
// positions, so a page starts on an m16n8k16 step: the tensor-core P V
// rescales the accumulators by exp(M_prev - M) before each 16-key step
// where M moved, and l takes exp(s - M) exp(M - M_tile). Pass 1 reads the
// latent rows a second time and costs the Q K^T product once more.
#include "common.cuh"

namespace xllm {
namespace mla {

constexpr int kWarps = 8;
constexpr int kThreadsM = kWarps * 32;
constexpr int kRowPad = 8;   // bf16 elements: rows 16 B apart mod 128 B
constexpr int kSPad = 4;     // f32 score rows
constexpr int kPPad = 8;     // bf16 probability rows
constexpr int kMaxSplits = 32;  // context splits of one decode row tile
constexpr int kTileGranules = 8;  // granules a tensor-core tile reads: pages of <= 512

// Row limit of chunk row r: positions < limit are visible to it.
__device__ __forceinline__ int row_limit(int r, int rows_live, int h, int kv_len,
                                         int q_offset) {
  return r < rows_live ? min(kv_len, q_offset + r / h + 1) : 0;
}

__device__ __forceinline__ size_t latent_row(int layer, int num_blocks, int bs,
                                             int blk, int off, int dk) {
  return (((size_t)layer * num_blocks + blk) * bs + off) * dk;
}

// exp(a - b) with b the larger maximum; 1 where neither has a value yet
__device__ __forceinline__ float rescale(float a, float b) {
  return b == -INFINITY ? 1.f : expf(a - b);
}

__device__ __forceinline__ float latent_float(float x) { return x; }
__device__ __forceinline__ float latent_float(e4m3 x) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)x.bits, __NV_E4M3);
  return __half2float(__half(h));
}

template <int KT>
size_t tc_smem_bytes(int dk) {
  constexpr int BM = 16;
  return (size_t)BM * (dk + kRowPad) * 2 + 2 * (size_t)KT * (dk + kRowPad) * 2 +
         (size_t)BM * (KT + kSPad) * 4 + (size_t)BM * (KT + kPPad) * 2 +
         (4 + KT / 16 + 2 * kTileGranules) * (size_t)BM * 4;
}

// Decode (K11a): a chunk of one token at q_offset = kv_len - 1. C: the
// cache's element type (bf16 or e4m3); q and out are bf16.
template <int KT, int DV, bool PASS1, typename C>
__global__ void __launch_bounds__(kThreadsM)
    mla_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,  // [P, S*H, Dk]
                            const C* __restrict__ lat_new,        // [P, Dk]
                            C* cache,                             // [L, NB, 1, bs, Dk]
                            const int* __restrict__ slot_mapping,  // [P]
                            const int* __restrict__ block_tables,  // [P, nbmax]
                            const int* __restrict__ kv_lens,       // [P]
                            float* gmax,                     // [P, S*H, ngran]
                            __nv_bfloat16* __restrict__ out,       // [P, S*H, DV]
                            float* part,    // [P, RT, nsplit, BM, 4 + DV]
                            int* counters,  // [P * RT], 0 between launches
                            int s, int h, int dk, int layer, int num_blocks,
                            int bs, int nbmax, float scale, int chunk,
                            int nsplit, int gran, int ngran, int in_walk) {
  constexpr int MT = 1;  // m16 tiles a block: the 16 heads of one token
  constexpr int BM = 16 * MT;
  constexpr int WPM = kWarps / MT;     // warps per m16 tile in S = Q K^T
  constexpr int NPW = (KT / 8) / WPM;  // n8 tiles of S per warp
  constexpr int CW = DV / kWarps;      // P V columns per warp
  constexpr int NT = CW / 8;           // n8 tiles of P V per warp
  constexpr int CPL = KT / 32;           // softmax columns per lane
  constexpr int KS = KT / 16;            // k16 steps of P V per tile
  constexpr int PR = 4 + DV;  // a partial row of a split: m, l, two pad floats, acc
  constexpr bool kBf16Cache = sizeof(C) == 2;
  static_assert(NPW >= 1 && NT % 2 == 0 && KT == 64, "tile split");

  const int rt = blockIdx.x, split = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = s * h;
  const int kv_len = kv_lens[p];
  const int q_offset = kv_len - 1;
  const int rows_live = kv_len > 0 ? (kv_len - q_offset) * h : 0;
  const int r0 = rt * BM;
  const size_t row_base = (size_t)p * rows;
  __nv_bfloat16* o = out + (row_base + r0) * DV;
  if (r0 >= rows_live) {  // padded row or bucket padding: zeros
    if (!PASS1 && split == 0)
      for (int i = tid; i < min(BM, rows - r0) * DV; i += kThreadsM)
        o[i] = __float2bfloat16(0.f);
    return;
  }
  const int r_last = min(r0 + BM, rows_live) - 1;
  const int kv_end = min(kv_len, q_offset + r_last / h + 1);
  const int nsp = (kv_end + chunk - 1) / chunk;  // splits with work
  if (split >= nsp) return;
  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, kv_end);
  const int gend = (kv_end + KT - 1) / KT * KT / gran;  // granules pass 1 writes
  const int* bt = block_tables + (size_t)p * nbmax;

  if (!PASS1 && rt == 0 && split == nsp - 1) {
    const int slot = slot_mapping[p];
    C* dst = cache + latent_row(layer, num_blocks, bs, slot / bs, slot % bs, dk);
    for (int i = tid; i < dk; i += kThreadsM) dst[i] = lat_new[(size_t)p * dk + i];
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = dk + kRowPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs0 = qs + BM * ldk;
  __nv_bfloat16* kvs1 = kvs0 + KT * ldk;
  float* ss = reinterpret_cast<float*>(kvs1 + KT * ldk);  // [BM, KT + kSPad]
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + BM * (KT + kSPad));
  float* m_s = reinterpret_cast<float*>(ps + BM * (KT + kPPad));  // acc's frame
  float* l_s = m_s + BM;
  float* mrun_s = l_s + BM;  // running maximum before the tile (granules)
  float* alpha_s = mrun_s + BM;  // [BM, KS] rescale before each k16 step
  float* gt_s = alpha_s + BM * KS;  // [2, BM, kTileGranules] granules a tile reads
  int* lim_s = reinterpret_cast<int*>(gt_s + 2 * BM * kTileGranules);
  __shared__ int is_last;

  const int dchunks = dk / 8;  // 16-byte pieces of a bf16 row
  for (int c = tid; c < BM * dchunks; c += kThreadsM) {
    const int r = c / dchunks, kc = (c % dchunks) * 8;
    const bool ok = r0 + r < rows_live;
    cp_async16(qs + r * ldk + kc, ok ? q + (row_base + r0 + r) * dk + kc : q, ok);
  }
  // one warp per row: the page lookup once a row, lanes on 16-byte pieces
  auto load_tile = [&](__nv_bfloat16* dst, int t0) {
    for (int j = warp; j < KT; j += kWarps) {
      const int pos = t0 + j;
      const bool ok = pos < t_end;
      const C* src = cache;
      if (ok)
        src = pos == kv_len - 1
                  ? lat_new + (size_t)p * dk
                  : cache + latent_row(layer, num_blocks, bs, bt[pos / bs], pos % bs, dk);
      if constexpr (kBf16Cache) {
        for (int kc = lane * 8; kc < dk; kc += 32 * 8)
          cp_async16(dst + j * ldk + kc, ok ? src + kc : cache, ok);  // rows past t_end: zeros
      } else {  // 16 e4m3 values a lane, upcast through registers
        for (int kc = lane * 16; kc < dk; kc += 32 * 16) {
          const uint4 raw = ok ? *reinterpret_cast<const uint4*>(src + kc)
                               : make_uint4(0u, 0u, 0u, 0u);
          upcast16<C>(dst + j * ldk + kc, raw);
        }
      }
    }
  };
  float* gm = gmax + (row_base + r0) * ngran;  // this tile's rows
  // pass 2: each tile's granule maxima, prefetched with its latent rows
  auto load_granules = [&](int buf, int t0) {
    if (PASS1 || in_walk) return;
    const int ng = tile_granules(t0, KT, bs, gran, gend);
    for (int i = tid; i < BM * kTileGranules; i += kThreadsM) {
      const int r = i / kTileGranules, k = i % kTileGranules;
      const bool ok = r0 + r < rows && k < ng;
      cp_async4(gt_s + buf * BM * kTileGranules + i,
                ok ? gm + (size_t)r * ngran + t0 / gran + k : gmax, ok);
    }
  };
  load_tile(kvs0, t_begin);
  load_granules(0, t_begin);
  cp_async_commit();
  for (int r = tid; r < BM; r += kThreadsM) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    lim_s[r] = min(row_limit(r0 + r, rows_live, h, kv_len, q_offset), t_end);
  }
  if (!PASS1) {  // the running maximum before this split, per row (0 rows in the walk)
    for (int r = warp; r < BM; r += kWarps) {
      float m = -INFINITY;
      if (r0 + r < rows)
        for (int k = lane; k < t_begin / gran; k += 32) m = fmaxf(m, gm[(size_t)r * ngran + k]);
      m = warp_max(m);
      if (lane == 0) mrun_s[r] = m;
    }
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int ntiles = (t_end - t_begin + KT - 1) / KT;
  const int c0 = warp * CW;
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) landed; the other buffer is free
    if (it + 1 < ntiles) {
      load_tile((it & 1) ? kvs0 : kvs1, t_begin + (it + 1) * KT);
      load_granules((it + 1) & 1, t_begin + (it + 1) * KT);
    }
    cp_async_commit();
    const __nv_bfloat16* kv = (it & 1) ? kvs1 : kvs0;
    const int t0 = t_begin + it * KT;

    // S = Q K^T: warp (wm, wn) owns m16 tile wm and NPW n8 tiles; even
    // and odd k steps go to two accumulator sets, so consecutive mma.sync
    // do not wait on each other
    {
      const int wm = warp / WPM, wn = warp % WPM;
      float sacc[2][NPW][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) sacc[u][j][k] = 0.f;
      const __nv_bfloat16* qrow = qs + (wm * 16 + (lane % 16)) * ldk + (lane / 16) * 8;
      const __nv_bfloat16* krow = kv + (wn * NPW * 8 + (lane % 8)) * ldk + ((lane / 8) % 2) * 8;
      auto k_step = [&](int kk, float (&acc_s)[NPW][4]) {
        uint32_t a[4];
        ldmatrix_x4(a, qrow + kk);
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          uint32_t b[2];  // K rows are the n index, their lanes the k index
          ldmatrix_x2(b, krow + j * 8 * ldk + kk);
          mma_bf16(acc_s[j], a, b[0], b[1]);
        }
      };
      int kk = 0;
#pragma unroll 2
      for (; kk + 32 <= dk; kk += 32) {
        k_step(kk, sacc[0]);
        k_step(kk + 16, sacc[1]);
      }
      if (kk < dk) k_step(kk, sacc[0]);
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int r = wm * 16 + lane / 4, c = (wn * NPW + j) * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(ss + r * (KT + kSPad) + c) =
            make_float2(sacc[0][j][0] + sacc[1][j][0], sacc[0][j][1] + sacc[1][j][1]);
        *reinterpret_cast<float2*>(ss + (r + 8) * (KT + kSPad) + c) =
            make_float2(sacc[0][j][2] + sacc[1][j][2], sacc[0][j][3] + sacc[1][j][3]);
      }
    }
    __syncthreads();

    if constexpr (PASS1) {  // each granule's maximum, a warp a row
      for (int r = warp; r < BM; r += kWarps) {
        if (r0 + r >= rows) continue;
        const int lim = lim_s[r];
        float v[CPL];
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int j = lane + 32 * u;
          v[u] = t0 + j < lim ? ss[r * (KT + kSPad) + j] * scale : -INFINITY;
        }
        write_granules<CPL>(gm + (size_t)r * ngran, v, t0, gran, lane);
      }
      continue;  // the next iteration's barrier orders ss
    }

    // softmax, one warp per row, KT / 32 columns per lane: P against the
    // running maximum at the end of each key's page (the walk's own page
    // maxima, or the first pass's granules)
    for (int r = warp; r < BM; r += kWarps) {
      const int lim = lim_s[r];
      const float* srow = ss + r * (KT + kSPad);
      const bool has_rows = r0 + r < rows;
      const float mrun = mrun_s[r];
      float v[CPL], mk[CPL];
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int j = lane + 32 * u;
        v[u] = t0 + j < lim ? srow[j] * scale : -INFINITY;
      }
      float mt;  // the running maximum after this tile's granules
      if (in_walk) {  // whole pages of <= KT keys, walked from position 0
        walk_page_maxima<CPL>(v, mk, bs, lane);
#pragma unroll
        for (int u = 0; u < CPL; ++u) mk[u] = fmaxf(mk[u], mrun);
        mt = __shfl_sync(0xffffffffu, mk[CPL - 1], 31);
      } else {
        const float* gt = gt_s + ((it & 1) * BM + r) * kTileGranules;
        const float pre = has_rows ? granule_prefix(gt, mrun, t0, KT, bs, gran, gend, lane)
                                   : -INFINITY;
#pragma unroll
        for (int u = 0; u < CPL; ++u)
          mk[u] = __shfl_sync(0xffffffffu, pre, page_lane(t0, t0 + lane + 32 * u, bs, gran, gend));
        mt = __shfl_sync(0xffffffffu, pre, tile_lane(t0, KT, gran, gend));
        if (!has_rows) mt = -INFINITY;
      }
      // lane q < KS: the maximum at k16 step q (a page holds whole steps;
      // step q starts at key 16 q, lane 16 (q % 2) of mk[q / 2]) and its
      // rescale from step q - 1
      const float ma = __shfl_sync(0xffffffffu, mk[0], (lane & 1) * 16);
      const float mb = __shfl_sync(0xffffffffu, mk[CPL - 1], (lane & 1) * 16);
      const float mstep = lane < 2 ? ma : mb;
      const float m_old = m_s[r];
      const float up = __shfl_up_sync(0xffffffffu, mstep, 1);
      const float mprev = lane == 0 ? m_old : up;
      if (lane < KS) alpha_s[r * KS + lane] = rescale(mprev, fmaxf(mprev, mstep));
      const float m_new = fmaxf(m_old, __shfl_sync(0xffffffffu, mstep, KS - 1));
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const float pe = v[u] == -INFINITY ? 0.f : expf(v[u] - mk[u]);
        ps[r * (KT + kPPad) + lane + 32 * u] = __float2bfloat16(pe);
        psum += pe * rescale(mk[u], m_new);
      }
      const float sum = warp_sum(psum);
      if (lane == 0) {
        l_s[r] = l_s[r] * rescale(m_old, m_new) + sum;
        m_s[r] = m_new;
        mrun_s[r] = mt;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this warp's CW value columns, the
    // accumulators rescaled before each k16 step
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      float lo[MT], hi[MT];
      bool one = true;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        lo[i] = alpha_s[(i * 16 + lane / 4) * KS + kk / 16];
        hi[i] = alpha_s[(i * 16 + lane / 4 + 8) * KS + kk / 16];
        one = one && lo[i] == 1.f && hi[i] == 1.f;
      }
      if (!__all_sync(0xffffffffu, one)) {  // within a page every step's is 1
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[i][j][0] *= lo[i];
            acc[i][j][1] *= lo[i];
            acc[i][j][2] *= hi[i];
            acc[i][j][3] *= hi[i];
          }
      }
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], ps + (i * 16 + (lane % 16)) * (KT + kPPad) + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];  // (k 0-7, k 8-15) of n8 tile j, then of tile j + 1
        ldmatrix_x4_trans(b, kv + (kk + (lane % 16)) * ldk + c0 + j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (PASS1) return;
  __syncthreads();  // final m and l are visible to every warp
  if (nsp == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + lane / 4 + half * 8;
        if (r0 + r >= rows) continue;
        const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = c0 + j * 8 + (lane % 4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * DV + c) =
              __floats2bfloat162_rn(acc[i][j][2 * half] / l, acc[i][j][2 * half + 1] / l);
        }
      }
    }
    return;
  }

  // several splits: publish (m, l, acc); the last split to finish merges
  // them and re-arms the counter (threadfence-reduction pattern, as K1)
  float* pb = part + ((size_t)p * gridDim.x + rt) * nsplit * BM * PR;
  float* pp = pb + (size_t)split * BM * PR;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = i * 16 + lane / 4 + half * 8;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(pp + (size_t)r * PR + 4 + c) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
  for (int r = tid; r < BM; r += kThreadsM) {
    pp[(size_t)r * PR] = m_s[r];
    pp[(size_t)r * PR + 1] = l_s[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[p * gridDim.x + rt], 1) == nsp - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each split's weight exp(m_split - m) per row, once; then every four
  // output columns are one weighted sum over the splits (16-byte loads,
  // eight splits in flight)
  __shared__ float w_s[BM * kMaxSplits];
  __shared__ float lsum_s[BM];
  for (int r = tid; r < BM; r += kThreadsM) {
    float m = -INFINITY;
    for (int sp = 0; sp < nsp; ++sp) m = fmaxf(m, __ldcg(pb + ((size_t)sp * BM + r) * PR));
    float l = 0.f;
    for (int sp = 0; sp < nsp; ++sp) {
      const float* src = pb + ((size_t)sp * BM + r) * PR;
      const float w = m == -INFINITY ? 0.f : expf(__ldcg(src) - m);
      w_s[r * kMaxSplits + sp] = w;
      l = fmaf(__ldcg(src + 1), w, l);
    }
    lsum_s[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int idx = tid; idx < BM * (DV / 4); idx += kThreadsM) {
    const int r = idx / (DV / 4), c = (idx % (DV / 4)) * 4;
    if (r0 + r >= rows) continue;
    const float* src = pb + (size_t)r * PR + 4 + c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < nsp; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)sp * BM * PR));
      const float w = w_s[r * kMaxSplits + sp];
      a.x = fmaf(v.x, w, a.x);
      a.y = fmaf(v.y, w, a.y);
      a.z = fmaf(v.z, w, a.z);
      a.w = fmaf(v.w, w, a.w);
    }
    const float l = lsum_s[r];
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * DV + c);
    dst[0] = __floats2bfloat162_rn(a.x / l, a.y / l);
    dst[1] = __floats2bfloat162_rn(a.z / l, a.w / l);
  }
  if (tid == 0) counters[p * gridDim.x + rt] = 0;
}

// ---------------------------------------------------------------------------
// f32 q: FMA on the CUDA cores, one block per (chunk, 16-row tile)
// ---------------------------------------------------------------------------
constexpr int kFR = 16;  // rows per block
constexpr int kFT = 32;  // KV tokens per tile

size_t f32_smem_bytes(int dk, int dv) {
  return ((size_t)kFR * (dk + 1) + (size_t)kFT * (dk + 1) + kFR * kFT +
          (size_t)kFR * dv + 4 * kFR) * 4;
}

// C: the cache's element type (f32, or e4m3 with P rounded to bf16 against
// the page-wise running maximum; PASS1 then writes the granule maxima).
template <bool DECODE, bool PASS1, typename C>
__global__ void __launch_bounds__(kThreadsM)
    mla_attention_f32_kernel(const float* __restrict__ q, const C* __restrict__ lat_new,
                             C* cache, const int* __restrict__ slot_mapping,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ q_offsets,
                             const int* __restrict__ kv_lens, float* gmax,
                             float* __restrict__ out, int s, int h, int dk, int dv,
                             int layer, int num_blocks, int bs, int nbmax, float scale,
                             int gran, int ngran, int in_walk) {
  constexpr bool kRound = sizeof(C) == 1;
  const int rt = blockIdx.x, p = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = s * h;
  const int kv_len = kv_lens[p];
  const int q_offset = DECODE ? kv_len - 1 : q_offsets[p];
  const int rows_live = kv_len > 0 ? (kv_len - q_offset) * h : 0;
  const int r0 = rt * kFR;
  const size_t row_base = (size_t)p * rows;
  float* o = out + (row_base + r0) * dv;
  const int nr = min(kFR, rows - r0);
  if (r0 >= rows_live) {
    if (!PASS1)
      for (int i = tid; i < nr * dv; i += kThreadsM) o[i] = 0.f;
    return;
  }
  const int kv_end = min(kv_len, q_offset + (min(r0 + kFR, rows_live) - 1) / h + 1);
  const int gend = (kv_end + kFT - 1) / kFT * kFT / gran;
  const int* bt = block_tables + (size_t)p * nbmax;
  if (!PASS1 && DECODE && rt == 0) {
    const int slot = slot_mapping[p];
    C* dst = cache + latent_row(layer, num_blocks, bs, slot / bs, slot % bs, dk);
    for (int i = tid; i < dk; i += kThreadsM) dst[i] = lat_new[(size_t)p * dk + i];
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kFR, dk + 1]
  float* ks = qs + kFR * (dk + 1);             // [kFT, dk + 1]
  float* ss = ks + kFT * (dk + 1);             // [kFR, kFT]
  float* acc = ss + kFR * kFT;                 // [kFR, dv]
  float* m_s = acc + kFR * dv;
  float* l_s = m_s + kFR;
  float* alpha_s = l_s + kFR;
  float* mrun_s = alpha_s + kFR;
  float* gm = gmax + (row_base + r0) * ngran;  // kRound only

  for (int i = tid; i < kFR * dk; i += kThreadsM) {
    const int r = i / dk, d = i % dk;
    qs[r * (dk + 1) + d] = r0 + r < rows_live ? q[(row_base + r0 + r) * dk + d] : 0.f;
  }
  for (int i = tid; i < kFR * dv; i += kThreadsM) acc[i] = 0.f;
  for (int r = tid; r < kFR; r += kThreadsM) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    mrun_s[r] = -INFINITY;
  }
  for (int t0 = 0; t0 < kv_end; t0 += kFT) {
    const int nj = min(kFT, kv_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nj * dk; i += kThreadsM) {
      const int j = i / dk, d = i % dk, pos = t0 + j;
      ks[j * (dk + 1) + d] = latent_float(
          DECODE && pos == kv_len - 1
              ? lat_new[(size_t)p * dk + d]
              : cache[latent_row(layer, num_blocks, bs, bt[pos / bs], pos % bs, dk) + d]);
    }
    __syncthreads();
    for (int i = tid; i < kFR * kFT; i += kThreadsM) {
      const int r = i / kFT, j = i % kFT;
      const int lim = row_limit(r0 + r, rows_live, h, kv_len, q_offset);
      float sc = -INFINITY;
      if (j < nj && t0 + j < lim) {
        const float* qr = qs + r * (dk + 1);
        const float* kr = ks + j * (dk + 1);
        float a = 0.f;
        for (int d = 0; d < dk; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a * scale;
      }
      ss[i] = sc;
    }
    __syncthreads();
    if constexpr (PASS1) {  // each granule's maximum, a warp a row
      for (int r = warp; r < kFR; r += kWarps) {
        if (r0 + r >= rows) continue;
        const float v[1] = {ss[r * kFT + lane]};
        write_granules<1>(gm + (size_t)r * ngran, v, t0, gran, lane);
      }
      continue;
    }
    for (int r = warp; r < kFR; r += kWarps) {
      const float v = ss[r * kFT + lane];  // kFT == 32: one column per lane
      const float m_old = m_s[r];
      float m_new, pr, pl;
      if constexpr (kRound) {
        const bool has_rows = r0 + r < rows;
        float mk, mt;
        if (in_walk) {  // whole pages of <= kFT keys
          const float vv[1] = {v};
          float mm[1];
          walk_page_maxima<1>(vv, mm, bs, lane);
          mk = fmaxf(mm[0], mrun_s[r]);
          mt = __shfl_sync(0xffffffffu, mk, 31);
        } else {
          const float pre = has_rows ? granule_prefix(gm + (size_t)r * ngran + t0 / gran,
                                                      mrun_s[r], t0, kFT, bs, gran, gend,
                                                      lane)
                                     : -INFINITY;
          mk = __shfl_sync(0xffffffffu, pre, page_lane(t0, t0 + lane, bs, gran, gend));
          mt = has_rows ? __shfl_sync(0xffffffffu, pre, tile_lane(t0, kFT, gran, gend))
                        : -INFINITY;
        }
        m_new = fmaxf(m_old, __shfl_sync(0xffffffffu, mk, 31));
        const float pe = v == -INFINITY ? 0.f : expf(v - mk);
        pr = round_bf16(pe) * rescale(mk, m_new);
        pl = pe * rescale(mk, m_new);
        if (lane == 0) mrun_s[r] = mt;
      } else {
        m_new = fmaxf(m_old, warp_max(v));
        pr = pl = expf(v - (m_new == -INFINITY ? 0.f : m_new));
      }
      ss[r * kFT + lane] = pr;
      const float sum = warp_sum(pl);
      if (lane == 0) {
        const float alpha = rescale(m_old, m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < kFR * dv; i += kThreadsM) {
      const int r = i / dv, c = i % dv;
      const float* pr = ss + r * kFT;
      float a = acc[i] * alpha_s[r];
      for (int j = 0; j < nj; ++j) a = fmaf(pr[j], ks[j * (dk + 1) + c], a);
      acc[i] = a;
    }
  }
  if constexpr (PASS1) return;
  __syncthreads();
  for (int i = tid; i < nr * dv; i += kThreadsM)
    o[i] = acc[i] / fmaxf(l_s[i / dv], 1e-30f);
}

template <int KT, int DV, typename C>
cudaError_t launch_tc(const void* q, const void* lat_new, void* cache, const int* sm,
                      const int* bt, const int* kl, float* gmax, void* out, float* part,
                      int* counters, int p, int s, int h, int dk, int layer, int num_blocks,
                      int bs, int nbmax, float scale, int chunk, int nsplit, int gran,
                      int ngran, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<KT>(dk);
  const dim3 grid((s * h + 15) / 16, nsplit, p);
  auto run = [&](auto kernel, int in_walk) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreadsM, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const C*>(lat_new),
        static_cast<C*>(cache), sm, bt, kl, gmax, static_cast<__nv_bfloat16*>(out), part,
        counters, s, h, dk, layer, num_blocks, bs, nbmax, scale, chunk, nsplit, gran, ngran,
        in_walk);
    return cudaGetLastError();
  };
  // a launch of one split over pages of <= KT keys takes the page maxima
  // in its walk; any other reads the first pass's granules
  const int in_walk = nsplit == 1 && bs <= KT;
  if (!in_walk) {
    cudaError_t e = run(mla_attention_tc_kernel<KT, DV, true, C>, 0);
    if (e != cudaSuccess) return e;
  }
  return run(mla_attention_tc_kernel<KT, DV, false, C>, in_walk);
}

template <bool DECODE, typename C>
cudaError_t launch_f32(const void* q, const void* lat_new, void* cache, const int* sm,
                       const int* bt, const int* qo, const int* kl, float* gmax,
                       void* out, int p, int s, int h, int dk, int dv, int layer,
                       int num_blocks, int bs, int nbmax, float scale, int gran,
                       int ngran, cudaStream_t stream) {
  constexpr bool kRound = sizeof(C) == 1;
  const size_t smem = f32_smem_bytes(dk, dv);
  const dim3 grid((s * h + kFR - 1) / kFR, 1, p);
  auto run = [&](auto kernel, int in_walk) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreadsM, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const C*>(lat_new),
        static_cast<C*>(cache), sm, bt, qo, kl, gmax, static_cast<float*>(out), s, h,
        dk, dv, layer, num_blocks, bs, nbmax, scale, gran, ngran, in_walk);
    return cudaGetLastError();
  };
  const int in_walk = bs <= kFT;  // one walk from position 0: pages of <= kFT keys
  if (kRound && !in_walk) {
    cudaError_t e = run(mla_attention_f32_kernel<DECODE, true, C>, 0);
    if (e != cudaSuccess) return e;
  }
  return run(mla_attention_f32_kernel<DECODE, false, C>, in_walk);
}

}  // namespace mla
}  // namespace xllm

// decode != 0: K11a (s == 1, q_offsets unused, lat_new and slot_mapping
// read); else K11b with f32 q (lat_new and slot_mapping unused). qtype
// bf16 (tensor cores, decode only) takes a bf16 or e4m3 cache, dk % 16 == 0
// and dv in {128, 256, 512}, and splits the context into nsplit <= 32
// chunks of `chunk` positions; qtype f32 takes an f32 or e4m3 cache, any dk
// and dv <= dk, and does not split. Every cache but f32 needs gmax [P, S*H, ngran] with
// gran = min(bs, tile) (tile 64 for bf16 q, 32 for f32), bs a divisor or
// a multiple of the tile, and ngran >= ceil(nbmax * bs / tile) * tile / gran.
extern "C" int xllm_mla_attention(int device, int decode, const void* q,
                                  const void* lat_new, void* cache,
                                  const void* slot_mapping, const void* block_tables,
                                  const void* q_offsets, const void* kv_lens,
                                  void* gmax, void* out, void* part, void* counters,
                                  int dtype, int qtype, int p, int s, int h, int dk,
                                  int dv, int layer, int num_blocks, int bs, int nbmax,
                                  float scale, int chunk, int nsplit, int gran,
                                  int ngran, void* stream) {
  using namespace xllm::mla;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (p > 65535 || nsplit > kMaxSplits || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int tile = qtype == XLLM_DTYPE_BF16 ? 64 : kFT;
  if (dtype != XLLM_DTYPE_F32 && dtype != XLLM_DTYPE_BF16 &&
      (gran != (bs < tile ? bs : tile) || (bs < tile ? tile % bs : bs % tile) ||
       (long long)ngran * gran < ((long long)nbmax * bs + tile - 1) / tile * tile))
    return (int)cudaErrorInvalidValue;
  if (dtype == XLLM_DTYPE_BF16 &&
      (gran != (bs < tile ? bs : tile) || (bs < tile ? tile % bs : bs % tile) || bs < 16 ||
       (qtype == XLLM_DTYPE_BF16 && bs > kTileGranules * tile) ||
       (long long)ngran * gran < ((long long)nbmax * bs + tile - 1) / tile * tile))
    return (int)cudaErrorInvalidValue;
  const int* sm = static_cast<const int*>(slot_mapping);
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* kl = static_cast<const int*>(kv_lens);
  float* gm = static_cast<float*>(gmax);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qtype == XLLM_DTYPE_BF16) {
    if (!decode || s != 1 || dk % 16 || bs < 16 || bs > kTileGranules * 64)
      return (int)cudaErrorInvalidValue;  // bf16 prefill: csrc/mla_prefill.cu
#define XLLM_LAUNCH(C, DV)                                                             \
  if (dv == DV)                                                                       \
    return (int)launch_tc<64, DV, C>(q, lat_new, cache, sm, bt, kl, gm, out, pt, ct, p, s, \
                                     h, dk, layer, num_blocks, bs, nbmax, scale, chunk,    \
                                     nsplit, gran, ngran, st);
#define XLLM_VALUE_DIMS(C) XLLM_LAUNCH(C, 512) XLLM_LAUNCH(C, 256) XLLM_LAUNCH(C, 128)
    if (dtype == XLLM_DTYPE_BF16) { XLLM_VALUE_DIMS(__nv_bfloat16) }
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_VALUE_DIMS(xllm::e4m3) }
#undef XLLM_VALUE_DIMS
#undef XLLM_LAUNCH
    return (int)cudaErrorInvalidValue;
  }
  if (qtype == XLLM_DTYPE_F32) {
    if (dv > dk) return (int)cudaErrorInvalidValue;
#define XLLM_LAUNCH(C)                                                                \
  return decode ? (int)launch_f32<true, C>(q, lat_new, cache, sm, bt, qo, kl, gm, out, p, \
                                           s, h, dk, dv, layer, num_blocks, bs, nbmax,    \
                                           scale, gran, ngran, st)                        \
                : (int)launch_f32<false, C>(q, lat_new, cache, sm, bt, qo, kl, gm, out, p, \
                                            s, h, dk, dv, layer, num_blocks, bs, nbmax,    \
                                            scale, gran, ngran, st);
    if (dtype == XLLM_DTYPE_F32) { XLLM_LAUNCH(float) }
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_LAUNCH(xllm::e4m3) }
#undef XLLM_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
