// K11b + K11e: latent (MLA) causal prefill attention on wgmma + TMA.
//
// Replaces two Pallas kernels of xllm_tpu/ops/pallas/mla_attention.py:
//   K11b :507 mla_prefill_attention_batched_tpu: P chunks q [P, S, H, Dk],
//        each causal at q_offsets[p] + t over its own kv_lens[p] latent
//        rows through block_tables -> [P, S, H, dv];
//   K11e :331 mla_prefill_attention_tpu: the same contract at one chunk
//        (ops/cuda/mla_attention.py launches it with P = 1 and counts it
//        apart).
// Absorbed MLA is an MQA over one latent head: the scores take all Dk
// lanes of a cached row, the values its first dv lanes. The softmax is f32;
// the unnormalised P of each page is rounded to bf16 against the row's
// running maximum after that page (the TPU walk's pr.astype(b.dtype)), and
// an e4m3 latent cache is upcast to bf16 before both products (the TPU
// kernels' _mxu). Rows past a chunk's ntok = kv_len - q_offset (bucket
// padding) and chunks with kv_len 0 come out as zeros.
//
// What bounds it: operations. A 2048-token chunk of DeepSeek-V2-Lite (16
// heads, Dk 640 of which 576 live, dv 512) does 16 x 2.1 M causal pairs x
// (576 + 512) x 2 = 73 GFLOP against ~78 MB: 0.074 ms at the bf16 tensor
// cores' 989 TFLOP/s. A short chunk deep in a prompt (52 tokens at
// q_offset 2048) is bound by its few rows (13 row tiles) and its bytes.
//
// Design (one block = 64 (token, head) rows of one chunk, token-major,
// row r = t * H + h; one wgmma M tile, so each latent row that TMA lands
// feeds 64 query rows):
// - Warp roles. 384 threads: a producer warpgroup and two consumer
//   warpgroups. The producer issues every TMA load (the Q tile, then each
//   stage into a free slot: bf16, lane 0 of each of its four warps a box in
//   turn; e4m3, thread 0) and gives its registers to the consumers with
//   setmaxnreg (24 / 240 a thread; e4m3: 56 / 224, it also upcasts). The
//   role is uniform across each warpgroup (a shuffle of warp 0's lane), and
//   no data-dependent branch comes before setmaxnreg: with the early exits
//   ahead of it ptxas held every thread to 168 registers and spilled the
//   dv 512 accumulators (520 bytes) and the kernel ran 2.3-3.6x slower.
// - Shared memory at Dk 640: the Q tile (64 x 640 bf16, 80 KB), a ring of
//   three 32-key latent stages (40 KB each) and the bf16 P tile (8 KB):
//   208 KB of the 227 KB. Hence 32-key stages: two 64-key stages with Q
//   would need 240 KB; a ring cut along Dk would re-read the value lanes
//   from L2 (80% more bytes a tile); reading only the live lanes needs a
//   width the JAX signature does not pass. A key tile is 64 keys, two
//   stages, one a consumer warpgroup. Dk need only be a multiple of 16: the
//   boxes past Dk land as zeros.
// - Q K^T, balanced. Consumer warpgroup w computes the scores of its own
//   stage (keys 32 w .. 32 w + 31 of the tile) for all 64 rows:
//   wgmma m64n32k16, Q and the stage K-major from shared memory (Dk / 16
//   steps). The two exchange each row's maxima of the tile's four 16-key
//   units through shared memory.
// - P, rounded per page. Both warpgroups fold the four unit maxima into
//   the running maximum at the end of each unit's page: pages of 16 / 32
//   keys are 1 / 2 units (the prefix maximum over the tile's pages),
//   a page of 64 is the tile; pages longer than a tile (128 and more) take
//   the whole page's maximum from a first pass. Each warpgroup writes its
//   half of the bf16 P tile, exp(s - M(page)), for both to read.
// - P V, dv split. Warpgroup w owns value columns [w dv / 2, (w + 1) dv / 2)
//   (at dv 512: 256 columns, 128 f32 accumulators a thread):
//   m64n256k16, P K-major and the stages' value lanes MN-major. Where the
//   running maximum moves inside a tile (pages of 16 / 32 keys), the
//   accumulators are rescaled between the page's k16 steps, so P stays the
//   TPU's rounded value; l sums the unrounded P. The tile's first stage is
//   released as soon as the products that read it are done, so the
//   producer loads the next tile's second stage during the rest of P V.
// - e4m3 cache. TMA lands the bytes (half the bf16 traffic) in the upper
//   half of the stage; the producer warpgroup upcasts it in place to the
//   swizzled bf16 stage (exact; NaN bytes kept), two column blocks between
//   barriers (upcast_stage), and signals `ready`.
// - Rows past t_end in a walk's last stage are zeroed before P V (a value
//   row outside the walk may hold anything; P there is 0, and 0 * NaN is
//   not 0).
// - Where the time goes (H100, scripts/probe_mla_kernel.py; per-phase
//   clock counters in a scratch build of the 256-thread form this kernel
//   replaced): a 64-key tile took ~8,100 cycles at a bf16 cache, Q K^T
//   ~2,100, the softmax and the P tile ~1,950, P V ~1,850, the next
//   stages' issue ~1,450 (now the producer's), the tensor cores idle while
//   the consumers do softmax in step. The stage whose slot frees last is
//   needed soon by the next tile: three 40 KB slots and an 80 KB Q leave no
//   room for a fourth.
// - Filling the card. Row tiles run longest first (a 2048-token chunk has
//   32x more keys in its last row tile than in its first). A launch with
//   few row tiles (a short chunk deep in a prompt) splits the context into
//   page- and tile-aligned splits, planned from shapes
//   (ops/cuda/mla_attention.prefill_plan). A first pass (PASS1: the same
//   score code on the same data, so the same bits) writes each row's
//   maximum over each split (each page, for pages longer than a tile), and
//   each split starts its running maximum at the earlier splits' maximum:
//   the TPU walk's running maximum at its first page, so every page rounds
//   as the TPU's does. The last split to finish merges the splits' (m, l,
//   acc) in split order.
#include "common.cuh"
#include "hopper.cuh"

namespace xllm {
namespace mla_prefill {

using namespace hopper;

constexpr int kRowsT = 64;       // (token, head) rows a block: one wgmma M tile
constexpr int kStageKeys = 32;   // latent rows a stage
constexpr int kTileKeys = 64;    // keys a tile: one stage a consumer warpgroup
constexpr int kStages = 3;
constexpr int kMaxKb = 10;       // 64-lane column blocks: Dk <= 640
constexpr int kMaxSplits = 32;
constexpr int kQBlock = kRowsT * 128;        // bytes of a Q column block
constexpr int kStageBlock = kStageKeys * 128;  // bytes of a stage's bf16 column block
constexpr int kPTile = kRowsT * 128;         // the bf16 P tile [64 rows x 64 keys]
constexpr int kMisc = 2048;      // barriers, unit maxima, l exchange, flag

// a producer warpgroup and two consumer warpgroups
constexpr int kThreads = 384;

// offsets from the 1024-aligned base
__host__ __device__ inline int off_stage(int nkb) { return nkb * kQBlock; }
__host__ __device__ inline int off_p(int nkb) { return off_stage(nkb) + kStages * nkb * kStageBlock; }
__host__ __device__ inline int off_misc(int nkb) { return off_p(nkb) + kPTile; }
inline size_t smem_bytes(int nkb) { return 1024 + (size_t)off_misc(nkb) + kMisc; }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// exp(a - b) with b the larger maximum: 1 where the maximum did not move
// (or neither has a value yet). A factor on f32 sums, never on P itself, so
// the fast exponential does.
__device__ __forceinline__ float rescale(float a, float b) {
  return a == b ? 1.f : __expf(a - b);
}

// 16 e4m3 bytes -> 16 bf16 (eight words, low bytes first), exact, with no
// branch (a data-dependent one makes ptxas serialize the warpgroup's
// wgmma): the integer upcast, then every NaN byte (low seven bits set)
// turned into the bf16 NaN 0xffff
__device__ __forceinline__ void e4m3x16_to_bf16(uint4 v, uint32_t (&o)[8]) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e4m3x4_to_bf16(in[j], o[2 * j], o[2 * j + 1]);
    const uint32_t nan = ((((in[j] & 0x7F7F7F7Fu) + 0x01010101u) & 0x80808080u) >> 7) * 0xFFu;
    o[2 * j] |= __byte_perm(nan, 0, 0x1100);
    o[2 * j + 1] |= __byte_perm(nan, 0, 0x3322);
  }
}

// A stage's e4m3 bytes ([nkb blocks][32 rows][64 B] in the stage's upper
// half, as TMA lands them) -> its swizzled bf16 blocks ([nkb][32 rows][128
// B]), in place, by the 128 threads of a warpgroup (thread c: row c / 4,
// 16 values c % 4 of each block), two blocks at a time in block order:
// writing bf16 blocks b0, b1 overwrites raw blocks <= 2 b1 + 1 - nkb <= b1,
// which every thread has read before the barrier. Exact; NaN bytes kept.
// Ends with the stage visible to wgmma (fence, barrier `bar`).
__device__ __forceinline__ void upcast_stage(unsigned char* st, int nkb, int c, int bar) {
  const int row = c / 4, ch = 2 * (c % 4);
  const unsigned char* raw = st + nkb * (kStageBlock / 2) + c * 16;
  auto put = [&](int b, uint4 v) {
    uint32_t o[8];
    e4m3x16_to_bf16(v, o);
    unsigned char* dst = st + b * kStageBlock + row * 128;
    *reinterpret_cast<uint4*>(dst + ((ch ^ (row & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + (((ch + 1) ^ (row & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  };
  // no conditional exit inside the pairs' loop: ptxas serializes the
  // warpgroup's wgmma after one
  int b0 = 0;
  for (; b0 + 2 <= nkb; b0 += 2) {
    const uint4 v0 = *reinterpret_cast<const uint4*>(raw + b0 * (kStageBlock / 2));
    const uint4 v1 = *reinterpret_cast<const uint4*>(raw + (b0 + 1) * (kStageBlock / 2));
    named_sync(bar, 128);
    put(b0, v0);
    put(b0 + 1, v1);
  }
  if (b0 < nkb) {
    const uint4 v0 = *reinterpret_cast<const uint4*>(raw + b0 * (kStageBlock / 2));
    named_sync(bar, 128);
    put(b0, v0);
  }
  fence_async_shared();
  named_sync(bar, 128);
}

// DV: value columns (128, 256, 512); kFp8: an e4m3 cache (else bf16);
// PASS1: write the first pass's maxima instead of attending.
template <int DV, bool kFp8, bool PASS1>
__global__ void __launch_bounds__(kThreads, 1)
    mla_prefill_kernel(const __grid_constant__ CUtensorMap qmap,  // bf16 [P*S*H, Dk]
                       const __grid_constant__ CUtensorMap cmap,  // [L*NB*bs, Dk]
                       const int* __restrict__ block_tables,      // [P, nbmax]
                       const int* __restrict__ q_offsets,         // [P]
                       const int* __restrict__ kv_lens,           // [P]
                       float* gmax,  // [P, RT, 64, ngran, 2] first-pass maxima
                       __nv_bfloat16* __restrict__ out,  // [P, S*H, DV]
                       float* part,     // [P, RT, nsplit, 64, 4 + DV]
                       int* counters,   // [P * RT], 0 between launches
                       int s, int h, int nkb, int layer, int num_blocks, int bs, int nbmax,
                       float scale, int chunk, int seg, int ngran) {
  constexpr int NV = DV / 2;
  constexpr int PR = 4 + DV;
  const int RT = gridDim.x;
  const int rt = RT - 1 - blockIdx.x;  // the longest walks first
  const int split = blockIdx.y, p = blockIdx.z, nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int rows = s * h;
  const int kv_len = kv_lens[p], q_offset = q_offsets[p];
  const int rows_live = kv_len > 0 ? (kv_len - q_offset) * h : 0;
  const int r0 = rt * kRowsT;
  const size_t row_base = (size_t)p * rows;
  // the exits are taken after setmaxnreg (below): a data-dependent branch
  // before it keeps ptxas from giving the consumers their registers
  const bool padded = r0 >= rows_live;
  const int r_last = min(r0 + kRowsT, rows_live) - 1;
  const int kv_end = min(kv_len, q_offset + r_last / h + 1);
  const int nsp = (kv_end + chunk - 1) / chunk;  // splits with work
  const bool long_pages = bs > kTileKeys;
  // no work, or (first pass) no split reads this one's maximum
  const bool idle = padded || split >= nsp || (PASS1 && !long_pages && split == nsp - 1);
  const int t_begin = split * chunk, t_end = min(t_begin + chunk, kv_end);
  const int ntiles = (t_end - t_begin + kTileKeys - 1) / kTileKeys;
  const size_t tile_id = (size_t)p * RT + rt;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;
  unsigned char* ring = base + off_stage(nkb);
  unsigned char* ps = base + off_p(nkb);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + off_misc(nkb));  // TMA landed
  uint64_t* empty = full + kStages;   // both consumer warpgroups done with the slot
  uint64_t* ready = empty + kStages;  // e4m3: the slot upcast
  uint64_t* qbar = ready + kStages;
  float* umax = reinterpret_cast<float*>(qbar + 2);  // [4 units][64 rows]
  float* lx = umax + 4 * kRowsT;                     // [2 warpgroups][64 rows]
  volatile int* last_flag = reinterpret_cast<volatile int*>(lx + 2 * kRowsT);
  const int stage_bytes = nkb * kStageBlock;
  auto stage = [&](int j) { return ring + (j % kStages) * stage_bytes; };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
      mbar_init(&ready[i], 1);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // the role, uniform across each warpgroup (warpgroup 0 produces)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nstages = 2 * ntiles;

  if (wgi == 0) {
    // ---- producer: the Q tile, then each stage, a page piece (min(bs, 32)
    // rows) x Dk / 64 column blocks, into its slot once the slot is free
    if constexpr (kFp8)
      setmaxnreg_dec<56>();
    else
      setmaxnreg_dec<24>();
    if (idle) return;
    const int pt = tid, pw = pt / 32, pl = pt % 32;
    const int piece = bs < kStageKeys ? bs : kStageKeys;
    const int* bt = block_tables + (size_t)p * nbmax;
    auto pieces = [&](int j) {  // page pieces of stage j before t_end (none past it)
      return max(0, min(kStageKeys / piece, (t_end - t_begin - kStageKeys * j + piece - 1) / piece));
    };
    auto row_of = [&](int j, int pc) {  // the cache row of piece pc of stage j
      const int pos = t_begin + kStageKeys * j + pc * piece;
      return (layer * num_blocks + bt[pos / bs]) * bs + pos % bs;
    };
    auto announce = [&](int j) {
      mbar_expect_tx(&full[j % kStages], (uint32_t)(pieces(j) * piece * (kFp8 ? 64 : 128) * nkb));
    };
    // column blocks who, who + n, ... of each piece of stage j
    auto issue = [&](int j, int who, int n) {
      unsigned char* dst = kFp8 ? stage(j) + nkb * (kStageBlock / 2) : stage(j);
      const int np = pieces(j);
      for (int pc = 0; pc < np; ++pc) {
        const int crow = row_of(j, pc);
        for (int cb = who; cb < nkb; cb += n)
          tma_load_2d(dst + cb * (kFp8 ? kStageBlock / 2 : kStageBlock) +
                       pc * piece * (kFp8 ? 64 : 128),
                      &cmap, &full[j % kStages], cb * 64, crow);
      }
    };
    if (pt == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&cmap);
      mbar_expect_tx(qbar, (uint32_t)nkb * kQBlock);
      for (int cb = 0; cb < nkb; ++cb)
        tma_load_2d(qs + cb * kQBlock, &qmap, qbar, cb * 64, (int)(row_base + r0));
    }
    if constexpr (!kFp8) {
      for (int j = 0; j < nstages; ++j) {
        if (pt == 0) {
          if (j >= kStages) mbar_wait(&empty[j % kStages], ((j / kStages) - 1) & 1);
          announce(j);
        }
        named_sync(4, 128);  // the slot is free, the bytes announced
        if (pl == 0) issue(j, pw, 4);
      }
    } else {
      if (pt == 0)
        for (int j = 0; j < min(nstages, kStages); ++j) {
          announce(j);
          issue(j, 0, 1);
        }
      for (int j = 0; j < nstages; ++j) {
        mbar_wait(&full[j % kStages], (j / kStages) & 1);
        upcast_stage(stage(j), nkb, pt, 4);
        if (pt == 0) {
          mbar_arrive(&ready[j % kStages]);
          // stage j + 2 into the slot of stage j - 1 (the tile before, or
          // this tile's first stage, released early)
          const int jn = j + kStages - 1;
          if (jn >= kStages && jn < nstages) {
            mbar_wait(&empty[jn % kStages], ((jn / kStages) - 1) & 1);
            announce(jn);
            issue(jn, 0, 1);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns the keys of stage 2 it + wg of each
    // tile in Q K^T and value columns [wg NV, (wg + 1) NV) in P V
    setmaxnreg_inc<kFp8 ? 224 : 240>();
    const int wg = wgi - 1, ct = tid - 128;
    if (padded) {  // a padded chunk or bucket padding: zeros
      if (!PASS1 && split == 0) {
        uint32_t* o = reinterpret_cast<uint32_t*>(out + (row_base + r0) * DV);
        for (int i = ct; i < min(kRowsT, rows - r0) * (DV / 2); i += 256) o[i] = 0u;
      }
      return;
    }
    if (idle) return;
    const int t = ct % 128, warp = t / 32, lane = t % 32;
    const int ra = 16 * warp + lane / 4, rb = ra + 8;  // this thread's two rows
    auto lim_of = [&](int r) {
      const int g = r0 + r;
      return g < rows_live ? min(min(kv_len, q_offset + g / h + 1), t_end) : 0;
    };
    const int la = lim_of(ra), lb = lim_of(rb);
    float* gm = gmax + tile_id * kRowsT * ngran * 2;
    auto seg_max = [&](int r, int k) { return fmaxf(gm[(r * ngran + k) * 2], gm[(r * ngran + k) * 2 + 1]); };
    // the walk's running maximum at t_begin: the earlier splits' (pages')
    float m_a = -INFINITY, m_b = -INFINITY;
    if (!PASS1)
      for (int k = 0; k < t_begin / seg; ++k) {
        m_a = fmaxf(m_a, seg_max(ra, k));
        m_b = fmaxf(m_b, seg_max(rb, k));
      }
    float l_a = 0.f, l_b = 0.f;  // this thread's columns' share of l
    float x_a = -INFINITY, x_b = -INFINITY;  // PASS1: the segment's maxima
    float acc[PASS1 ? 1 : NV / 2];
#pragma unroll
    for (int i = 0; i < (PASS1 ? 1 : NV / 2); ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(qs), p_addr = smem_u32(ps);
    const int upg = long_pages ? 4 : bs / 16;  // units a page (long pages: one a tile)
    uint64_t* landed = kFp8 ? ready : full;  // a stage the consumers may read
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };
    mbar_wait(qbar, 0);

    for (int it = 0; it < ntiles; ++it) {
      const int t0 = t_begin + it * kTileKeys, j0 = 2 * it, jm = j0 + wg;
      mbar_wait(&landed[jm % kStages], (jm / kStages) & 1);
      unsigned char* sm = stage(jm);
      const uint32_t s_addr = smem_u32(sm);
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll 1
      for (int cb = 0; cb < nkb; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ss<32, 0>(sc, gmma_desc(q_addr + cb * kQBlock + 32 * kk, 16, 1024),
                            gmma_desc(s_addr + cb * kStageBlock + 32 * kk, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // scale, mask: key 32 wg + 8 j + 2 (lane % 4) + e of the tile, rows
      // ra (e < 2) and rb
      const int k0 = t0 + kStageKeys * wg + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + (e & 1);
          sc[4 * j + e] = key < (e < 2 ? la : lb) ? sc[4 * j + e] * scale : -INFINITY;
        }

      if constexpr (PASS1) {  // each segment's maximum (a split, or a long page)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x_a = fmaxf(x_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          x_b = fmaxf(x_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        if ((t0 + kTileKeys) % seg == 0 || t0 + kTileKeys >= t_end) {
          x_a = quad_max(x_a);
          x_b = quad_max(x_b);
          if (lane % 4 == 0) {
            gm[(ra * ngran + t0 / seg) * 2 + wg] = x_a;
            gm[(rb * ngran + t0 / seg) * 2 + wg] = x_b;
          }
          x_a = x_b = -INFINITY;
        }
        release(j0);
        release(j0 + 1);
      } else {
        // a walk's last stage: value rows at t_end and past it are zeroed
        const int zero_from = max(0, t_end - (t0 + kStageKeys * wg));
        if (zero_from < kStageKeys) {
          const int n = (kStageKeys - zero_from) * (DV / 64) * 8;
          for (int i = t; i < n; i += 128) {
            const int r = zero_from + i / ((DV / 64) * 8), rem = i % ((DV / 64) * 8);
            *reinterpret_cast<uint4*>(sm + (rem / 8) * kStageBlock + r * 128 + (rem % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_async_shared();
        }
        // the maxima of this warpgroup's two 16-key units, to both
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float ua = quad_max(fmaxf(fmaxf(sc[8 * q], sc[8 * q + 1]),
                                       fmaxf(sc[8 * q + 4], sc[8 * q + 5])));
          const float ub = quad_max(fmaxf(fmaxf(sc[8 * q + 2], sc[8 * q + 3]),
                                       fmaxf(sc[8 * q + 6], sc[8 * q + 7])));
          if (lane % 4 == 0) {
            umax[(2 * wg + q) * kRowsT + ra] = ua;
            umax[(2 * wg + q) * kRowsT + rb] = ub;
          }
        }
        named_sync(1, 256);
        // M[u]: the running maximum at the end of unit u's page
        float Ma[4], Mb[4];
        if (long_pages) {  // the whole page's maximum, from the first pass
          const float ga = fmaxf(m_a, seg_max(ra, t0 / bs));
          const float gb = fmaxf(m_b, seg_max(rb, t0 / bs));
#pragma unroll
          for (int u = 0; u < 4; ++u) Ma[u] = ga, Mb[u] = gb;
        } else {
          float Ua[4], Ub[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            Ua[u] = umax[u * kRowsT + ra];
            Ub[u] = umax[u * kRowsT + rb];
          }
          float run_a = m_a, run_b = m_b;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (u % upg == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (i < upg && u + i < 4) {
                  run_a = fmaxf(run_a, Ua[u + i]);
                  run_b = fmaxf(run_b, Ub[u + i]);
                }
            }
            Ma[u] = run_a;
            Mb[u] = run_b;
          }
        }
        // P of this warpgroup's keys, rounded to bf16 against its page's
        // maximum, into the P tile (row r, key k at chunk (k / 8) ^ (r % 8));
        // l takes the unrounded P in the tile's frame
        const float mta = Ma[3], mtb = Mb[3];
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = 2 * wg + j / 2;
          const float pa0 = sc[4 * j] == -INFINITY ? 0.f : expf(sc[4 * j] - Ma[u]);
          const float pa1 = sc[4 * j + 1] == -INFINITY ? 0.f : expf(sc[4 * j + 1] - Ma[u]);
          const float pb0 = sc[4 * j + 2] == -INFINITY ? 0.f : expf(sc[4 * j + 2] - Mb[u]);
          const float pb1 = sc[4 * j + 3] == -INFINITY ? 0.f : expf(sc[4 * j + 3] - Mb[u]);
          sa += (pa0 + pa1) * rescale(Ma[u], mta);
          sb += (pb0 + pb1) * rescale(Mb[u], mtb);
          const int k = kStageKeys * wg + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(ps + ra * 128 + (((k >> 3) ^ (ra & 7)) << 4) + (k & 7) * 2) =
              bf16x2_bits(pa0, pa1);
          *reinterpret_cast<uint32_t*>(ps + rb * 128 + (((k >> 3) ^ (rb & 7)) << 4) + (k & 7) * 2) =
              bf16x2_bits(pb0, pb1);
        }
        l_a = l_a * rescale(m_a, mta) + sa;
        l_b = l_b * rescale(m_b, mtb) + sb;
        fence_async_shared();
        named_sync(1, 256);  // the P tile is whole; the other stage is zeroed
        {
          const int jo = j0 + 1 - wg;  // the other warpgroup's stage
          mbar_wait(&landed[jo % kStages], (jo / kStages) & 1);
        }
        // acc = acc * alpha + P V; the tile's first stage (units 0, 1) is
        // released once the products that read it are done
        const uint32_t v0 = smem_u32(stage(j0)) + wg * (NV / 64) * kStageBlock;
        const uint32_t v1 = smem_u32(stage(j0 + 1)) + wg * (NV / 64) * kStageBlock;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u % upg == 0) {
            if (u > 0) {
              wgmma_wait<0>();
              fence_regs(acc);
              if (u == 2) release(j0);
            }
            const float al_a = rescale(u == 0 ? m_a : Ma[u - 1], Ma[u]);
            const float al_b = rescale(u == 0 ? m_b : Mb[u - 1], Mb[u]);
            if (al_a != 1.f || al_b != 1.f) {
#pragma unroll
              for (int i = 0; i < NV / 8; ++i) {
                acc[4 * i] *= al_a;
                acc[4 * i + 1] *= al_a;
                acc[4 * i + 2] *= al_b;
                acc[4 * i + 3] *= al_b;
              }
            }
            fence_regs(acc);
            wgmma_fence();
          }
          wgmma_bf16_ss<NV, 1>(acc, gmma_desc(p_addr + 32 * u, 16, 1024),
                            gmma_desc((u < 2 ? v0 : v1) + (u % 2) * 2048, kStageBlock, 1024),
                            1);
          if (u % upg == upg - 1 || (upg == 4 && u == 1)) wgmma_commit();
        }
        if (upg == 4) {
          wgmma_wait<1>();
          release(j0);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(j0 + 1);
        m_a = mta;
        m_b = mtb;
      }
    }
    if constexpr (!PASS1) {
      // l: each warpgroup's share of each row, summed in warpgroup order
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      if (lane % 4 == 0) {
        lx[wg * kRowsT + ra] = l_a;
        lx[wg * kRowsT + rb] = l_b;
      }
      named_sync(1, 256);
      const float lsa = lx[ra] + lx[kRowsT + ra], lsb = lx[rb] + lx[kRowsT + rb];
      const int c0 = wg * NV + 2 * (lane % 4);
      if (nsp == 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = hh ? rb : ra;
          if (r0 + r >= rows) continue;
          const float l = fmaxf(hh ? lsb : lsa, 1e-30f);
          uint32_t* o = reinterpret_cast<uint32_t*>(out + (row_base + r0 + r) * DV + c0);
#pragma unroll
          for (int j = 0; j < NV / 8; ++j)
            o[4 * j] = bf16x2_bits(acc[4 * j + 2 * hh] / l, acc[4 * j + 2 * hh + 1] / l);
        }
        return;
      }
      // several splits: publish (m, l, acc); the last split to finish merges
      // them in split order and re-arms the counter
      float* pb = part + tile_id * nsplit * kRowsT * PR;
      float* pp = pb + (size_t)split * kRowsT * PR;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rb : ra;
#pragma unroll
        for (int j = 0; j < NV / 8; ++j)
          *reinterpret_cast<float2*>(pp + (size_t)r * PR + 4 + c0 + 8 * j) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
      if (wg == 0 && lane % 4 == 0) {
        pp[(size_t)ra * PR] = m_a;
        pp[(size_t)ra * PR + 1] = lsa;
        pp[(size_t)rb * PR] = m_b;
        pp[(size_t)rb * PR + 1] = lsb;
      }
      __threadfence();
      named_sync(1, 256);
      if (ct == 0) *last_flag = atomicAdd(&counters[tile_id], 1) == nsp - 1;
      named_sync(1, 256);
      if (!*last_flag) return;
      __threadfence();
      // each split's weight exp(m_split - m) per row, once (in the P tile's
      // bytes: every product has read it), then every four output columns
      // are one weighted sum over the splits
      float* w_s = reinterpret_cast<float*>(ps);  // [64 rows][kMaxSplits]
      float* lsum_s = lx;
      for (int r = ct; r < kRowsT; r += 256) {
        float m = -INFINITY;
        for (int sp = 0; sp < nsp; ++sp) m = fmaxf(m, __ldcg(pb + ((size_t)sp * kRowsT + r) * PR));
        float l = 0.f;
        for (int sp = 0; sp < nsp; ++sp) {
          const float* src = pb + ((size_t)sp * kRowsT + r) * PR;
          const float w = m == -INFINITY ? 0.f : expf(__ldcg(src) - m);
          w_s[r * kMaxSplits + sp] = w;
          l = fmaf(__ldcg(src + 1), w, l);
        }
        lsum_s[r] = fmaxf(l, 1e-30f);
      }
      named_sync(1, 256);
      for (int idx = ct; idx < kRowsT * (DV / 4); idx += 256) {
        const int r = idx / (DV / 4), c = (idx % (DV / 4)) * 4;
        if (r0 + r >= rows) continue;
        const float* src = pb + (size_t)r * PR + 4 + c;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int sp = 0; sp < nsp; ++sp) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)sp * kRowsT * PR));
          const float w = w_s[r * kMaxSplits + sp];
          a.x = fmaf(v.x, w, a.x);
          a.y = fmaf(v.y, w, a.y);
          a.z = fmaf(v.z, w, a.z);
          a.w = fmaf(v.w, w, a.w);
        }
        const float l = lsum_s[r];
        uint32_t* dst = reinterpret_cast<uint32_t*>(out + (row_base + r0 + r) * DV + c);
        dst[0] = bf16x2_bits(a.x / l, a.y / l);
        dst[1] = bf16x2_bits(a.z / l, a.w / l);
      }
      if (ct == 0) counters[tile_id] = 0;
    }
  }
}

template <int DV, bool kFp8>
cudaError_t launch(const CUtensorMap& qmap, const CUtensorMap& cmap, const int* bt,
                   const int* qo, const int* kl, float* gmax, void* out, float* part,
                   int* counters, int p, int s, int h, int nkb, int layer, int num_blocks,
                   int bs, int nbmax, float scale, int chunk, int nsplit, int seg, int ngran,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(nkb);
  const dim3 grid((s * h + kRowsT - 1) / kRowsT, nsplit, p);
  auto run = [&](auto kernel, AllowSmemOnce& allow) {
    cudaError_t e = allow(kernel, smem_bytes(kMaxKb));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(
        qmap, cmap, bt, qo, kl, gmax, static_cast<__nv_bfloat16*>(out), part, counters, s, h,
        nkb, layer, num_blocks, bs, nbmax, scale, chunk, seg, ngran);
    return cudaGetLastError();
  };
  if (nsplit > 1 || bs > kTileKeys) {  // the first pass: split (page) maxima
    static AllowSmemOnce allow1;
    const cudaError_t e = run(mla_prefill_kernel<128, kFp8, true>, allow1);
    if (e != cudaSuccess) return e;
  }
  static AllowSmemOnce allow2;
  return run(mla_prefill_kernel<DV, kFp8, false>, allow2);
}

}  // namespace mla_prefill
}  // namespace xllm

// K11b / K11e with bf16 q on a bf16 (dtype XLLM_DTYPE_BF16) or e4m3 latent
// cache [num_layers, num_blocks, 1, bs, dk]: q [p, s, h, dk] -> out [p, s,
// h, dv] bf16. dk a multiple of 16 up to 640, dv in {128, 256, 512} and
// <= dk; bs 16, 32 or a multiple of 64 up to 512. The
// context is split into nsplit <= 32 splits of `chunk` positions (a
// multiple of 64 and of bs). With nsplit > 1 or bs > 64, gmax holds [p,
// ceil(s * h / 64), 64, ngran, 2] floats: seg = bs (bs > 64) or chunk,
// ngran >= ceil(nbmax * bs / seg); part [p, row tiles, nsplit, 64, 4 + dv]
// floats when nsplit > 1; counters [p * row tiles] ints, zero.
extern "C" int xllm_mla_prefill(int device, const void* q, const void* cache,
                             const void* block_tables, const void* q_offsets,
                             const void* kv_lens, void* gmax, void* out, void* part,
                             void* counters, int dtype, int p, int s, int h, int dk, int dv,
                             int layer, int num_layers, int num_blocks, int bs, int nbmax,
                             float scale, int chunk, int nsplit, int seg, int ngran,
                             void* stream) {
  using namespace xllm::mla_prefill;
  using xllm::hopper::encode_2d_cached;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nkb = (dk + 63) / 64;
  const bool bs_ok = bs >= 16 && bs <= 512 && (bs <= kTileKeys ? kTileKeys % bs == 0
                                                            : bs % kTileKeys == 0);
  if (p < 1 || p > 65535 || s < 1 || h < 1 || dk % 16 || nkb > kMaxKb || dv > dk ||
      !bs_ok || nsplit < 1 || nsplit > kMaxSplits || chunk <= 0 || chunk % kTileKeys ||
      chunk % bs || (long long)chunk * nsplit < (long long)nbmax * bs)
    return (int)cudaErrorInvalidValue;
  if ((nsplit > 1 || bs > kTileKeys) &&
      (seg != (bs > kTileKeys ? bs : chunk) ||
       (long long)ngran * seg < (long long)nbmax * bs))
    return (int)cudaErrorInvalidValue;
  if (dtype != XLLM_DTYPE_BF16 && dtype != XLLM_DTYPE_E4M3) return (int)cudaErrorInvalidValue;
  const bool fp8 = dtype == XLLM_DTYPE_E4M3;
  const int piece = bs < kStageKeys ? bs : kStageKeys;
  CUtensorMap qmap, cmap;
  e = encode_2d_cached(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (uint64_t)p * s * h, dk,
                       kRowsT, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  const uint64_t crows = (uint64_t)num_layers * num_blocks * bs;
  const CUtensorMapDataType ctype =
      fp8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle cswz = fp8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  e = encode_2d_cached(&cmap, cache, ctype, fp8 ? 1 : 2, crows, dk, piece, 64, cswz);
  if (e != cudaSuccess) return (int)e;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* kl = static_cast<const int*>(kv_lens);
  float* gm = static_cast<float*>(gmax);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XLLM_LAUNCH(DV)                                                                        \
  if (dv == DV)                                                                                \
    return fp8 ? (int)launch<DV, true>(qmap, cmap, bt, qo, kl, gm, out, pt, ct, p, s, h, nkb,  \
                                    layer, num_blocks, bs, nbmax, scale, chunk, nsplit,     \
                                    seg, ngran, st)                                         \
               : (int)launch<DV, false>(qmap, cmap, bt, qo, kl, gm, out, pt, ct, p, s, h, nkb, \
                                     layer, num_blocks, bs, nbmax, scale, chunk, nsplit,    \
                                     seg, ngran, st);
  XLLM_LAUNCH(512)
  XLLM_LAUNCH(256)
  XLLM_LAUNCH(128)
#undef XLLM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
