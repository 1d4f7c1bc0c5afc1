// K1: fused KV write + paged GQA decode attention, one launch a call.
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
// contract and differ from K1 in two parameters of the walk, which the
// kernel takes at run time: the rounding tile of vt = G * block_size
// positions (v9: G = 4, or T of v9tT), and where the new token joins the
// softmax (mode):
// - kModeOpen (v5-v10): the softmax opens at the new token (m = s_new,
//   l = 1, acc = v_new: attended as given, never read back);
// - kModeLast (v3, v4): the walk opens empty over the cached positions
//   (its running maxima exclude s_new); the new token joins after them as
//   one unrounded f32 column, exp(s_new - M_f);
// - kModeCache (v1, no window): the new row is attended at position
//   seq_len - 1 like a cached one, with the bytes the writer stores (cast
//   to the cache dtype and upcast back), taken from the inputs (put_row).
// K8 and K9 are the same kernel on the interleaved cache [L, NB, 2, Hkv,
// bs, D] (PageLayout in common.cuh: another page stride, V Hkv * bs * D
// after K). K9 (rm = 1, paged_decode_attention_write_v12_tpu) reads a
// sequence's incomplete tail page, from tail_from = nfull * bs, token-major;
// the TPU walk takes tiles of G full pages, then the tail page as a tile of
// its own.
//
// What P is rounded against (every cache but f32, whose V tile the TPU
// upcasts to bf16): the TPU kernel walks a sequence in one program, in
// tiles of vt positions from 0, and rounds the unnormalised P of each
// tile to bf16 against its running maximum after that tile. So position p
// takes M(p) = R(e(p)), R(e) being the running maximum over the positions
// before e (kModeOpen: and s_new), e(p) the end of p's rounding tile
// (K9: clipped to tail_from; in K9's tail M(p) = M_f, the row's final
// maximum), and adds bf16(exp(s - M)) * exp(M - M_f) to P, exp(s - M) *
// exp(M - M_f) to l: every split works in the final frame M_f, so the
// merge is a plain sum. An f32 cache adds exp(s - M_f) unrounded.
//
// Its byte bound: one call reads every live K and V row once, B x ctx x
// Hkv x D x 2 elements (K1 at its served shape: 40.9 MB of bf16, 0.0123
// ms at 3.35 TB/s), and does ~4 flops per byte. What bounds it as built,
// measured on an H100: blocks an SM and waves, not bytes (a block streams
// ~11-12 GB/s through its ring and pays ~8-10 us of fixed cost: ring
// start, three cluster barriers, merge), so a launch reaches 11-55% of
// the byte rate. The design:
// - one thread-block cluster per (sequence, kv head), its blocks the
//   context splits (up to 16, the cluster size the wrapper's plan picks
//   from the block-table width and the heads). Each block holds the
//   head's G query rows, so a K/V row is fetched once for all G heads that
//   share it. The split of a sequence is cut from its own seq_len in the
//   kernel (tiles of 64 positions, spread evenly over the cluster's
//   blocks), so a short sequence does not wait on a split sized for the
//   widest table;
// - each block reads its K tiles once and keeps its scores ([chunk, G]
//   f32) in shared memory (or, when they do not fit, a global scratch the
//   wrapper sizes from the table width: ops/cuda/decode_attention.plan),
//   and publishes its granule maxima (a granule is gcd(vt, 64) positions,
//   K9 gcd(bs, 64), so every rounding-tile end and tail_from is a granule
//   boundary). After one cluster barrier each block reads the earlier
//   splits' maxima (and, where its last rounding tile runs past its split,
//   the next splits' granules) over DSMEM, builds M(p) for its positions
//   from the same score bits it exponentiates, and rounds P. Then it
//   streams its V tiles, whose loads started while it scored. So K and V
//   each come from HBM once, and a call is one launch on every cache and
//   layout (the first pass that re-read K is gone);
// - loads are asynchronous: one ring per block, K tiles then V tiles, a
//   few 64-row stages deep (kRingBytes). At a power-of-two block_size of
//   16 or more a stage is filled by TMA boxes of a page segment (the
//   caches as [rows, D] tensor maps, 128-byte swizzle; 64-byte for 64-byte
//   rows), its bytes counted on the stage's mbarrier; K9's token-major
//   tail rows, and every row at other block sizes, go by 16-byte cp.async
//   copies (commit groups) into the same swizzled layout. Rows are stored
//   unpadded with their 16-byte chunks XOR-swizzled by row, so that reads
//   of a column across rows hit distinct banks. A 1-byte cache lands raw
//   (half the bytes) and is upcast where it is read;
// - (l, acc) of the splits merge over DSMEM after a second cluster
//   barrier, each block summing a share of the G x D outputs; a third
//   barrier keeps every block alive until the others are done reading it.
//   Every block of a cluster, idle splits included, reaches every barrier.
//
// Write, then read: no block reads position seq_len - 1 from the cache
// (the new token is attended as given, or kModeCache's taken from the
// inputs), so block 0 of each (sequence, head) stores the new row, cast to
// the cache dtype (e4m3 through to_e4m3x2), at the start. Sequences never
// share a page that is written. K9: the row goes token-major to row
// w = slot % bs of its page. When it completes the page (w == bs - 1) the
// page must be rewritten canonical, [2, Hkv, bs, D], which moves rows that
// the other heads' clusters are still reading token-major: block 0 of
// each head stages its canonical K and V planes (bs - 1 rows read, the new
// row cast) in a scratch page of the sequence's own, and the last cluster
// of the sequence to finish (a per-sequence counter, threadfence pattern,
// re-armed to 0 by that cluster) copies the scratch page over the page
// with all its blocks. A step where no row completes a page costs nothing
// more.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace xllm {

constexpr int kModeOpen = 0, kModeCache = 2;  // kModeLast is 1: tested as neither
constexpr int kMaxCluster = 16;       // non-portable cluster size on Hopper
// A block's ring of K / V tiles, and the blocks an SM its registers allow
// (128 registers a thread). A launch is bound by how many blocks an SM
// holds, not by a block's depth: on an H100 rings of 48 and 64 KB (fewer
// blocks an SM) and 5-6 blocks (spilled registers) were all slower.
constexpr int kRingBytes = 32 * 1024;
constexpr int kMinBlocks = 4;
constexpr int kAlign = 1024;          // the swizzled boxes' alignment in shared memory

// A 64-row tile of C in the ring, in the layout TMA writes with its
// swizzle: rows of 128 bytes or more in boxes of [64 rows, 128 bytes] (a
// bf16 row of 128 values spans two boxes), the 16-byte chunk c of row j at
// chunk c ^ (j % 8) of its box row (128-byte swizzle); 64-byte rows (a
// 1-byte cache at head_dim 64) at chunk c ^ (j / 2 % 4) (64-byte swizzle).
// The same column of 8 consecutive rows falls in 8 distinct bank groups.
template <typename C, int D>
struct Ring {
  static constexpr int kRowBytes = D * (int)sizeof(C);
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kVec = 16 / (int)sizeof(C);  // values a chunk
  static constexpr int kBoxBytes = kRowBytes < 128 ? kRowBytes : 128;  // a box row
  static constexpr int kBoxes = kRowBytes / kBoxBytes;
  static constexpr int kTileBytes = kTile * kRowBytes;  // a multiple of 1024
  static constexpr int kFit = kRingBytes / kTileBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  __device__ static __forceinline__ int offset(int j, int c) {
    if constexpr (kRowBytes >= 128)
      return (c >> 3) * (kTile * 128) + j * 128 + (((c & 7) ^ (j & 7)) << 4);
    else
      return j * 64 + ((c ^ ((j >> 1) & 3)) << 4);
  }
};

// 16 bytes of a cache row -> its 16 / sizeof(C) values as f32
__device__ __forceinline__ void unpack16(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
// int8 byte k of w as f32 without a conversion instruction: the byte
// biased to unsigned (x + 128) becomes the low mantissa byte of 2^23
__device__ __forceinline__ float int8_at(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 + k)) - 8388736.f;
}
__device__ __forceinline__ float2 int8x2(uint32_t two) {
  return make_float2(int8_at(two, 0), int8_at(two, 1));
}
__device__ __forceinline__ float2 e4m3x2(uint32_t two) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}
__device__ __forceinline__ void unpack16(const uint4& r, float* f, int8_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = int8_at(w[i], k);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* f, e4m3) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = e4m3x2(w[i]), b = e4m3x2(w[i] >> 16);
    f[4 * i] = a.x; f[4 * i + 1] = a.y; f[4 * i + 2] = b.x; f[4 * i + 3] = b.y;
  }
}

// two consecutive values of a cache row in shared memory (p 2-element aligned)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  return int8x2(*reinterpret_cast<const uint16_t*>(p));
}
__device__ __forceinline__ float2 load_pair(const e4m3* p) {
  return e4m3x2(*reinterpret_cast<const uint16_t*>(p));
}

// Two values of a new row, cast to the cache dtype as the writer stores
// them (int8 rows arrive as integral codes; e4m3 through the paired
// hardware cast with JAX's NaN bytes), to dst (2-element aligned).
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(int8_t* dst, float a, float b) {
  const uint32_t lo = (uint8_t)(int8_t)__float2int_rn(a), hi = (uint8_t)(int8_t)__float2int_rn(b);
  *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(lo | hi << 8);
}
__device__ __forceinline__ void store_pair(e4m3* dst, float a, float b) {
  *reinterpret_cast<uint16_t*>(dst) = (uint16_t)to_e4m3x2(a, b);
}

// A new row (D values of T: the cache dtype, or q's on a 1-byte cache)
// cast into a cache row, a pair a thread
template <typename T, typename C, int D>
__device__ __forceinline__ void store_row(C* dst, const T* src) {
  for (int d = 2 * threadIdx.x; d < D; d += 2 * kThreads)
    store_pair(dst + d, to_float(src[d]), to_float(src[d + 1]));
}

struct DecodeArgs {
  const void* q;      // [B, Hq, D] T
  const void* k_new;  // [B, Hkv, D] T
  const void* v_new;
  void* k_cache;  // pages: PageLayout
  void* v_cache;
  const int* slot_mapping;  // [B]
  const int* block_tables;  // [B, nbmax]
  const int* seq_lens;      // [B]
  void* out;                // [B, Hq, D] T
  float* scores;            // [B, Hkv, cluster, chunk, GMAX] f32, or null: shared memory
  int* counters;            // [B] K9 page completions, 0 between launches
  void* scratch;            // [B, page] C: K9's staged canonical pages
  long long page;           // elements from one (layer, block) page to the next
  int layer, num_blocks, hkv, bs, nbmax, group;
  float scale;
  int window, cluster, chunk;  // chunk: the most positions of a split (plan)
  int gran_log2, vt, mode, rm;
};

// Shared memory of a block: the ring, the split's page offsets (chunk / 16
// + 2), the stages' mbarriers (8 words), q [GMAX, D] f32, the scores [chunk,
// GMAX] (unless global), granule maxima and their prefix [chunk / gran,
// GMAX] each, eight per-row arrays, four warps' row partials and the
// maxima of 16 positions [chunk / 16, GMAX].
template <typename C, int D, int GMAX>
__host__ __device__ __forceinline__ size_t decode_smem_bytes(int chunk, int gran_log2,
                                                           bool smem_scores) {
  return (size_t)Ring<C, D>::kStages * Ring<C, D>::kTileBytes +
         kAlign + sizeof(long long) * ((size_t)chunk / 16 + 2 + 8) +
         sizeof(float) * ((size_t)GMAX * D + (smem_scores ? (size_t)chunk * GMAX : 0) +
                          2 * (size_t)(chunk >> gran_log2) * GMAX + 12 * GMAX +
                          (size_t)(chunk / 16) * GMAX) +
         16;
}

// blocks an SM the registers must allow: kMinBlocks (128 registers a
// thread) up to head_dim 128; at 256 a bf16 ring and q take ~100 KB of
// shared memory (two blocks an SM at most; an e4m3 ring is half as large,
// and its 139-206 registers with bf16 q up to 16 rows let two or three
// blocks share an SM), and q's A fragments alone hold 64 registers, so
// the cap lifts
template <int D>
constexpr int min_blocks = D > 128 ? 1 : kMinBlocks;

template <typename T, typename C, int D, int GMAX>
__global__ void __launch_bounds__(kThreads, min_blocks<D>)
    decode_attention_kernel(const DecodeArgs a,
                            const __grid_constant__ CUtensorMap kmap,   // [rows, D] of K
                            const __grid_constant__ CUtensorMap vmap) {  // and of V
  using R = Ring<C, D>;
  constexpr int kRowsA = GMAX / 2;  // score rows a thread (two threads a position)
  constexpr int kDP = D / 2;        // P.V: column pairs of a row ...
  constexpr int kGroups = kThreads / kDP;  // ... and groups of positions
  constexpr bool kRound = sizeof(C) != 4;  // P rounded on every cache but f32
  // the scores on the tensor cores: bf16 q (exact as A), at most 16 rows
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && GMAX <= 16;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));

  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.group, hkv = a.hkv, bs = a.bs;
  const int seq_len = a.seq_lens[b];
  const size_t qrow = ((size_t)b * hkv + h) * G * D;
  T* o = static_cast<T*>(a.out) + qrow;
  if (seq_len <= 0) {  // padded row: no write, zero output (the whole cluster returns)
    if (rank == 0)
      for (int i = tid; i < G * D; i += kThreads) o[i] = from_float<T>(0.f);
    return;
  }

  // this sequence's walk: positions [base, wend), attended from lo; split
  // into tiles of 64, tpr of them a block, over the nsp blocks with work
  const int mode = a.mode;
  const int lo = a.window > 0 ? max(seq_len - a.window, 0) : 0;
  const int base = lo / kTile * kTile;
  const int wend = mode == kModeCache ? seq_len : seq_len - 1;
  const int tiles = (max(wend - base, 0) + kTile - 1) / kTile;
  const int tpr = max(1, (tiles + a.cluster - 1) / a.cluster);
  const int nsp = max(1, (tiles + tpr - 1) / tpr);
  const int chunk = tpr * kTile;
  const bool active = rank < nsp;
  const int cs = base + rank * chunk;     // this split's first position
  const int ce = max(min(cs + chunk, wend), cs);  // and its end
  const int n = active ? (ce - cs + kTile - 1) / kTile : 0;  // its tiles
  const int tail_from = a.rm ? (seq_len - 1) / bs * bs : INT_MAX;
  const PageLayout lay{a.page, tail_from};
  const int gl = a.gran_log2;

  // shared memory
  unsigned char* ring = smem;
  long long* pgo = reinterpret_cast<long long*>(ring + R::kStages * R::kTileBytes);  // pages
  uint64_t* full = reinterpret_cast<uint64_t*>(pgo + a.chunk / 16 + 2);  // [8] a stage's
  float* qs = reinterpret_cast<float*>(full + 8);  // [GMAX, D]
  float* sc_smem = qs + GMAX * D;
  const int ngr = a.chunk >> gl;  // granules of the largest split
  float* gm = sc_smem + (a.scores ? 0 : a.chunk * GMAX);  // [ngr, GMAX] granule maxima
  float* lp = gm + ngr * GMAX;                             // [ngr, GMAX] their prefix
  float* smax = lp + ngr * GMAX;                           // [GMAX] the split's maximum
  float* snew = smax + GMAX;                               // [GMAX] the new token's score
  float* mpre = snew + GMAX;   // [GMAX] running maximum before the split (kModeOpen: s_new)
  float* mfin = mpre + GMAX;   // [GMAX] the row's final maximum M_f
  float* mover = mfin + GMAX;  // [GMAX] M of the last rounding tile when it runs past
  float* ls = mover + GMAX;    // [GMAX] l
  float* wnew = ls + GMAX;     // [GMAX] the new token's weight (block 0)
  float* part = wnew + GMAX;   // [4 warps, GMAX] row partials
  float* s16 = part + 4 * GMAX;  // [chunk / 16, GMAX] maxima of 16 positions
  int* flag = reinterpret_cast<int*>(s16 + (a.chunk / 16) * GMAX);
  float* sc = a.scores ? a.scores + (((size_t)b * hkv + h) * a.cluster + rank) * a.chunk * GMAX
                       : sc_smem;  // [chunk, GMAX]

  const T* kn = static_cast<const T*>(a.k_new) + ((size_t)b * hkv + h) * D;
  const T* vn = static_cast<const T*>(a.v_new) + ((size_t)b * hkv + h) * D;
  C* kc = static_cast<C*>(a.k_cache);
  C* vc = static_cast<C*>(a.v_cache);
  const int slot = a.slot_mapping[b];
  const bool completes = a.rm && slot % bs == bs - 1;  // K9: the row completes its page

  // Pages of a power-of-two block_size of 16 and up come by TMA, one box a
  // page segment of a tile, from the row (of D values) of head h's slot 0
  // in each page, read once from the block table; K9's token-major tail
  // rows and other block sizes by cp.async, 16 bytes a thread.
  const int* bt = a.block_tables + (size_t)b * a.nbmax;
  const int pg0 = cs / bs;
  const int bsl = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  const bool tma = bs >= 16 && bsl >= 0;
  const long long page_rows = a.page / D;
  if (tma && n > 0)
    for (int k = tid; k <= (ce - 1) / bs - pg0; k += kThreads)
      pgo[k] = ((long long)a.layer * a.num_blocks + bt[pg0 + k]) * page_rows + (long long)h * bs;
  if (tid == 0) {
    for (int st = 0; st < R::kStages; ++st) hopper::mbar_init(&full[st], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the ring: tile i < n is K tile i of the split, tile n + i its V tile i
  auto fetch = [&](int i) {
    if (i < 2 * n) {
      const bool isv = i >= n;
      const int t0 = cs + (isv ? i - n : i) * kTile;
      const int jlo = max(lo - t0, 0), jhi = min(ce - t0, kTile);
      // kModeCache: position seq_len - 1 comes from the inputs
      const int jc = mode == kModeCache ? min(jhi, seq_len - 1 - t0) : jhi;
      unsigned char* dst = ring + (i % R::kStages) * R::kTileBytes;
      if (tid == 0) {  // the canonical page segments of the tile, a box each
        const int rows = min(bs, kTile);
        uint32_t tx = 0;
        int pf = 0, pl = -1;
        if (tma && jc > jlo) {
          pf = (t0 + jlo) >> bsl;
          pl = (min(t0 + jc, tail_from) - 1) >> bsl;  // none in K9's tail
          if (min(t0 + jc, tail_from) <= t0 + jlo) pl = pf - 1;
          tx = (uint32_t)(pl - pf + 1) * R::kBoxes * rows * R::kBoxBytes;
        }
        uint64_t* bar = &full[i % R::kStages];
        hopper::fence_async_shared();  // the slot's earlier reads before the copies' writes
        hopper::mbar_expect_tx(bar, tx);
        for (int pg = pf; pg <= pl; ++pg) {
          const int r0 = max(pg * bs - t0, 0);  // the segment's first tile row
          const long long row = pgo[pg - pg0] + (t0 + r0 - pg * bs);
#pragma unroll
          for (int bx = 0; bx < R::kBoxes; ++bx)
            hopper::tma_load_2d(dst + bx * (kTile * 128) + r0 * R::kBoxBytes, isv ? &vmap : &kmap,
                                bar, bx * (R::kBoxBytes / (int)sizeof(C)), (int)row);
        }
      }
      // the other rows: 16 bytes a thread
      constexpr int kPer = kTile * R::kChunks / kThreads;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = tid + e * kThreads;
        const int j = idx / R::kChunks, c = idx % R::kChunks, pos = t0 + j;
        if (j < jlo || j >= jc || (tma && pos < tail_from)) continue;
        const C *krow, *vrow;
        kv_rows(lay, static_cast<const C*>(kc), static_cast<const C*>(vc), a.layer,
                a.num_blocks, hkv, bs, D, bt[pos / bs], h, pos, krow, vrow);
        cp_async16(dst + R::offset(j, c),
                   reinterpret_cast<const unsigned char*>(isv ? vrow : krow) + c * 16, true);
      }
    }
    cp_async_commit();
  };
  // kModeCache: position seq_len - 1 of the tile consumed next, from the
  // inputs as the writer stores it (after the copies, which may bring the
  // cache's row)
  auto put_new = [&](int ti, bool isv) {
    const int t0 = cs + ti * kTile, jn = seq_len - 1 - t0;
    if (mode != kModeCache || jn < 0 || jn >= min(ce - t0, kTile)) return;
    unsigned char* dst = ring + ((isv ? n + ti : ti) % R::kStages) * R::kTileBytes;
    const T* src = isv ? vn : kn;
    for (int d = 2 * tid; d < D; d += 2 * kThreads) {
      const int byte = d * (int)sizeof(C);
      store_pair(reinterpret_cast<C*>(dst + R::offset(jn, byte >> 4) + (byte & 15)),
                 to_float(src[d]), to_float(src[d + 1]));
    }
  };
  auto tile_rows = [&](int ti, int& jlo, int& jhi) {
    const int t0 = cs + ti * kTile;
    jlo = max(lo - t0, 0);
    jhi = min(ce - t0, kTile);
  };

#pragma unroll 1
  for (int s = 0; s < R::kStages - 1; ++s) fetch(s);

  if (rank == 0) {
    if (completes) {
      // head h's canonical K and V planes (rows read token-major, the new
      // row cast in) to the scratch page; the last cluster copies it over
      constexpr int kU = R::kChunks;  // 16-byte units of a head's row
      const C* pg = kc + ((size_t)a.layer * a.num_blocks + slot / bs) * a.page;
      C* st = static_cast<C*>(a.scratch) + (size_t)b * a.page;
      const int units = 2 * (bs - 1) * kU;
      for (int i0 = tid; i0 < units; i0 += 4 * kThreads) {
        uint4 v[4];  // four loads in flight before their stores
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + e * kThreads;
          const int half = i / ((bs - 1) * kU), w = i / kU % (bs - 1), u = i % kU;
          if (i < units)
            v[e] = reinterpret_cast<const uint4*>(pg + ((size_t)w * 2 * hkv + half * hkv + h) * D)[u];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + e * kThreads;
          const int half = i / ((bs - 1) * kU), w = i / kU % (bs - 1), u = i % kU;
          if (i < units)
            reinterpret_cast<uint4*>(st + ((size_t)(half * hkv + h) * bs + w) * D)[u] = v[e];
        }
      }
      store_row<T, C, D>(st + ((size_t)h * bs + bs - 1) * D, kn);
      store_row<T, C, D>(st + ((size_t)(hkv + h) * bs + bs - 1) * D, vn);
      __threadfence();
    } else {  // the new row at its slot (K9: token-major)
      const PageLayout wl{a.page, a.rm ? 0 : INT_MAX};
      C *kw, *vw;
      kv_rows(wl, kc, vc, a.layer, a.num_blocks, hkv, bs, D, slot / bs, h, slot, kw, vw);
      store_row<T, C, D>(kw, kn);
      store_row<T, C, D>(vw, vn);
    }
  }

  // q (rows past G zero) and, per row, the new token's score
  const T* qg = static_cast<const T*>(a.q) + qrow;
  for (int i = tid; i < GMAX * D; i += kThreads) qs[i] = i < G * D ? to_float(qg[i]) : 0.f;
  __syncthreads();
  for (int g = warp; g < GMAX; g += kThreads / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[g * D + d], to_float(kn[d]), s);
    s = warp_sum(s) * a.scale;
    if (lane == 0) snew[g] = s;
  }

  // phase A: the scores of the split's K tiles (-inf where not attended)
  // and the maximum of each 16 positions (s16), warp w holding positions
  // 16w .. 16w + 15 of a tile. bf16 q (G <= 16): mma.sync m16n8k16 with
  // the G query rows (padded to 16) as A, the K rows as B; otherwise the
  // CUDA cores, a thread a position and its rows g = rg, rg + 2, ...
  uint32_t qa[kMma ? D / 16 : 1][4];  // q's A fragments
  if constexpr (kMma) {
    const int g0 = lane >> 2, t4 = lane & 3;
    auto pair = [&](int g, int d) {  // rows past GMAX (the padding to 16) are zeros
      return g < GMAX ? bf16x2_bits(qs[g * D + d], qs[g * D + d + 1]) : 0u;
    };
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int d = ks * 16 + 2 * t4;
      qa[ks][0] = pair(g0, d);
      qa[ks][1] = pair(g0 + 8, d);
      qa[ks][2] = pair(g0, d + 8);
      qa[ks][3] = pair(g0 + 8, d + 8);
    }
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    fetch(i + R::kStages - 1);
    cp_async_wait<R::kStages - 1>();
    hopper::mbar_wait(&full[i % R::kStages], (i / R::kStages) & 1);
    put_new(i, false);
    __syncthreads();
    const unsigned char* tile = ring + (i % R::kStages) * R::kTileBytes;
    int jlo, jhi;
    tile_rows(i, jlo, jhi);
    if constexpr (kMma) {
      const int g0 = lane >> 2, t4 = lane & 3;
      float m0 = -INFINITY, m1 = -INFINITY;  // rows g0, g0 + 8 over the warp's 16
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int jr = 16 * warp + 8 * nt + g0;  // the B fragment's K row
        float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t b0, b1;
          if constexpr (sizeof(C) == 2) {
            b0 = *reinterpret_cast<const uint32_t*>(tile + R::offset(jr, 2 * ks) + 4 * t4);
            b1 = *reinterpret_cast<const uint32_t*>(tile + R::offset(jr, 2 * ks + 1) + 4 * t4);
          } else {  // 1-byte values, upcast to bf16 pairs (exact)
            const unsigned char* kr = tile + R::offset(jr, ks);
            const float2 f0 = load_pair(reinterpret_cast<const C*>(kr + 2 * t4));
            const float2 f1 = load_pair(reinterpret_cast<const C*>(kr + 8 + 2 * t4));
            b0 = bf16x2_bits(f0.x, f0.y);
            b1 = bf16x2_bits(f1.x, f1.y);
          }
          mma_bf16(d4, qa[ks], b0, b1);
        }
        const int j0 = 16 * warp + 8 * nt + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + (e & 1), g = g0 + 8 * (e >> 1);
          const float x = j >= jlo && j < jhi ? d4[e] * a.scale : -INFINITY;
          if (g < GMAX) sc[(size_t)(i * kTile + j) * GMAX + g] = x;
          if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (t4 == 0 && g0 < GMAX) s16[(4 * i + warp) * GMAX + g0] = m0;
      if (t4 == 0 && g0 + 8 < GMAX) s16[(4 * i + warp) * GMAX + g0 + 8] = m1;
    } else {
      const int j = tid & (kTile - 1), rg = tid >> 6;
      const bool valid = j >= jlo && j < jhi;
      float acc[kRowsA];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) acc[r] = 0.f;
      if (valid) {
#pragma unroll 4
        for (int c = 0; c < R::kChunks; ++c) {
          float kv[R::kVec];
          unpack16(*reinterpret_cast<const uint4*>(tile + R::offset(j, c)), kv, C{});
#pragma unroll
          for (int r = 0; r < kRowsA; ++r) {
            const float4* qv = reinterpret_cast<const float4*>(qs + (rg + 2 * r) * D + c * R::kVec);
#pragma unroll
            for (int v = 0; v < R::kVec / 4; ++v) {
              const float4 x = qv[v];
              acc[r] = fmaf(x.x, kv[4 * v], acc[r]);
              acc[r] = fmaf(x.y, kv[4 * v + 1], acc[r]);
              acc[r] = fmaf(x.z, kv[4 * v + 2], acc[r]);
              acc[r] = fmaf(x.w, kv[4 * v + 3], acc[r]);
            }
          }
        }
      }
      float* srow = sc + (size_t)(i * kTile + j) * GMAX;
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) {
        const float x = valid ? acc[r] * a.scale : -INFINITY;
        srow[rg + 2 * r] = x;
        float m = x;  // over the 16 lanes of one segment
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((lane & 15) == 0) s16[(4 * i + j / 16) * GMAX + rg + 2 * r] = m;
      }
    }
    __syncthreads();
  }

  // granule maxima of the split (from s16, or from the scores for granules
  // shorter than 16), their running prefix, the split's maximum
  const int ng = (n * kTile) >> gl;
  for (int idx = tid; idx < ng * GMAX; idx += kThreads) {
    const int k = idx / GMAX, g = idx % GMAX;
    float m = -INFINITY;
    if (gl >= 4) {
      for (int u = k << (gl - 4); u < (k + 1) << (gl - 4); ++u) m = fmaxf(m, s16[u * GMAX + g]);
    } else {
      for (int q = k << gl; q < (k + 1) << gl; ++q) m = fmaxf(m, sc[(size_t)q * GMAX + g]);
    }
    gm[idx] = m;
  }
  __syncthreads();
  for (int g = warp; g < GMAX; g += kThreads / 32) {
    float carry = -INFINITY;
    for (int k0 = 0; k0 < ng; k0 += 32) {
      float x = k0 + lane < ng ? gm[(k0 + lane) * GMAX + g] : -INFINITY;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x = fmaxf(x, y);
      }
      x = fmaxf(x, carry);
      if (k0 + lane < ng) lp[(k0 + lane) * GMAX + g] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) smax[g] = carry;
  }
  cluster.sync();  // #1: every split's granule maxima published

  if (active) {
    // per row: the maximum before this split, the final one, and M of the
    // last rounding tile where it runs past the split (granules of the
    // next splits, read over DSMEM)
    const int plast = min(ce, tail_from) - 1;  // last position rounded against a tile end
    int e_over = plast >= cs ? min((plast / a.vt + 1) * a.vt, tail_from) : 0;
    e_over = min(e_over, wend);
    for (int g = warp; g < GMAX; g += kThreads / 32) {
      const float open = mode == kModeOpen ? snew[g] : -INFINITY;
      float pre = -INFINITY, all = -INFINITY;
      for (int s2 = lane; s2 < nsp; s2 += 32) {
        const float m = cluster.map_shared_rank(smax, s2)[g];
        all = fmaxf(all, m);
        if (s2 < rank) pre = fmaxf(pre, m);
      }
      pre = fmaxf(warp_max(pre), open);
      all = warp_max(all);
      float over = -INFINITY;
      for (int p = ce + (lane << gl); p < e_over; p += 32 << gl) {
        const int s2 = (p - base) / chunk, k = (p - base - s2 * chunk) >> gl;
        over = fmaxf(over, cluster.map_shared_rank(gm, s2)[k * GMAX + g]);
      }
      over = warp_max(over);
      if (lane == 0) {
        mpre[g] = pre;
        mfin[g] = mode == kModeCache ? all : fmaxf(all, snew[g]);
        mover[g] = fmaxf(fmaxf(pre, smax[g]), over);
      }
    }
    __syncthreads();

    // P in place of the scores, in the final frame; l per row
    const int g = tid & (GMAX - 1);
    const float mf = mfin[g], mp = mpre[g], mo = mover[g];
    float lsum = 0.f;
    for (int idx = tid; idx < n * kTile * GMAX; idx += kThreads) {
      const int pl = idx / GMAX, pos = cs + pl;
      const float s = sc[idx];
      float p = 0.f;
      if (s != -INFINITY) {
        if constexpr (kRound) {
          float m = mf;  // K9's tail: the final maximum
          if (pos < tail_from) {
            const int e = min((pos / a.vt + 1) * a.vt, tail_from);
            m = e <= ce ? fmaxf(mp, lp[(((e - cs) >> gl) - 1) * GMAX + g]) : mo;
          }
          const float pe = expf(s - m), w = expf(m - mf);
          lsum += pe * w;
          p = round_bf16(pe) * w;
        } else {
          p = expf(s - mf);
          lsum += p;
        }
      }
      sc[idx] = p;
    }
#pragma unroll
    for (int off = 16; off >= GMAX; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (lane < GMAX) part[warp * GMAX + lane] = lsum;
    __syncthreads();
    if (tid < GMAX) {
      float l = part[tid] + part[GMAX + tid] + part[2 * GMAX + tid] + part[3 * GMAX + tid];
      // block 0 adds the new token (not kModeCache: it is walked)
      const float w = rank == 0 && mode != kModeCache ? expf(snew[tid] - mfin[tid]) : 0.f;
      wnew[tid] = w;
      ls[tid] = l + w;
    }
  }

  // phase C: acc += P . V over the split's V tiles; a thread holds a column
  // pair of every row over the positions rg, rg + kGroups, ...
  const int dp = tid % kDP, rg = tid / kDP;
  float acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;
#pragma unroll 1
  for (int i = n; i < 2 * n; ++i) {
    fetch(i + R::kStages - 1);
    cp_async_wait<R::kStages - 1>();
    hopper::mbar_wait(&full[i % R::kStages], (i / R::kStages) & 1);
    put_new(i - n, true);
    __syncthreads();
    const unsigned char* tile = ring + (i % R::kStages) * R::kTileBytes;
    int jlo, jhi;
    tile_rows(i - n, jlo, jhi);
    const int byte = 2 * dp * (int)sizeof(C);
#pragma unroll 2
    for (int j = jlo + ((rg - jlo) % kGroups + kGroups) % kGroups; j < jhi; j += kGroups) {
      const float2 v = load_pair(reinterpret_cast<const C*>(tile + R::offset(j, byte >> 4) +
                                                             (byte & 15)));
      const float* pr = sc + (size_t)((i - n) * kTile + j) * GMAX;
      if constexpr (GMAX == 2) {
        const float2 p = *reinterpret_cast<const float2*>(pr);
        acc[0][0] = fmaf(p.x, v.x, acc[0][0]);
        acc[0][1] = fmaf(p.x, v.y, acc[0][1]);
        acc[1][0] = fmaf(p.y, v.x, acc[1][0]);
        acc[1][1] = fmaf(p.y, v.y, acc[1][1]);
      } else {
#pragma unroll
        for (int g4 = 0; g4 < GMAX; g4 += 4) {
          const float4 p = *reinterpret_cast<const float4*>(pr + g4);
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[g4 + u][0] = fmaf(pv[u], v.x, acc[g4 + u][0]);
            acc[g4 + u][1] = fmaf(pv[u], v.y, acc[g4 + u][1]);
          }
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();

  // the split's acc [G, D] in the ring: the groups' partials summed (and,
  // block 0, the new token's w_new * v_new)
  float* red = reinterpret_cast<float*>(ring);  // [kGroups, GMAX, D]
  if (active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      *reinterpret_cast<float2*>(red + ((size_t)rg * GMAX + g) * D + 2 * dp) =
          make_float2(acc[g][0], acc[g][1]);
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kGroups; ++r) s += red[((size_t)r * GMAX + g) * D + d];
      red[i] = rank == 0 ? fmaf(wnew[g], to_float(vn[d]), s) : s;
    }
  }
  cluster.sync();  // #2: every split's (l, acc) published

  // the merge: each block a share of the G x D outputs, summed over splits
  const int total = G * D, per = (total + a.cluster - 1) / a.cluster;
  for (int i = rank * per + tid; i < min(total, (rank + 1) * per); i += kThreads) {
    const int g = i / D;
    float sv[kMaxCluster], lv[kMaxCluster];
#pragma unroll
    for (int s2 = 0; s2 < kMaxCluster; ++s2)
      if (s2 < nsp) {
        sv[s2] = cluster.map_shared_rank(red, s2)[i];
        lv[s2] = cluster.map_shared_rank(ls, s2)[g];
      }
    float s = 0.f, l = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kMaxCluster; ++s2)
      if (s2 < nsp) {
        s += sv[s2];
        l += lv[s2];
      }
    o[i] = from_float<T>(s / l);
  }
  if (completes && rank == 0 && tid == 0) {
    // K9: the last cluster of the sequence copies the staged page
    __threadfence();
    const int last = atomicAdd(&a.counters[b], 1) == hkv - 1;
    if (last) a.counters[b] = 0;  // re-armed: every cluster has counted
    __threadfence();
    for (int s2 = 0; s2 < a.cluster; ++s2) *cluster.map_shared_rank(flag, s2) = last;
  }
  cluster.sync();  // #3: no block leaves while another reads its shared memory
  if (completes && *flag) {
    const long long units = a.page * (long long)sizeof(C) / 16;
    uint4* pg = reinterpret_cast<uint4*>(kc + ((size_t)a.layer * a.num_blocks + slot / bs) * a.page);
    const uint4* st = reinterpret_cast<const uint4*>(static_cast<C*>(a.scratch) + (size_t)b * a.page);
    const long long step = (long long)a.cluster * kThreads;
    for (long long u0 = (long long)rank * kThreads + tid; u0 < units; u0 += 8 * step) {
      uint4 v[8];  // eight loads in flight before their stores
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (u0 + e * step < units) v[e] = __ldcg(st + u0 + e * step);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (u0 + e * step < units) pg[u0 + e * step] = v[e];
    }
  }
}

// cluster launches above 8 blocks need the non-portable attribute, and
// more than 48 KB of dynamic shared memory its own: set once per device
struct LaunchAttrsOnce {
  bool done[64] = {};
  template <typename K>
  cudaError_t operator()(K kernel) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
    return err;
  }
};

template <typename T, typename C, int D, int GMAX>
cudaError_t launch_decode(const DecodeArgs& a, int batch, long long krows, long long vrows,
                          cudaStream_t stream) {
  using R = Ring<C, D>;
  auto kernel = decode_attention_kernel<T, C, D, GMAX>;
  // the caches as [rows, D] tensors read in boxes of a page segment (the
  // kernel reads through them only at a power-of-two block_size >= 16)
  CUtensorMap kmap{}, vmap{};
  if (a.bs >= 16 && (a.bs & (a.bs - 1)) == 0) {
    const CUtensorMapDataType type = sizeof(C) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : sizeof(C) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const CUtensorMapSwizzle sw =
        R::kRowBytes >= 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    const uint32_t box_rows = a.bs < kTile ? a.bs : kTile;
    const uint32_t box_cols = R::kBoxBytes / (int)sizeof(C);
    cudaError_t e = hopper::encode_2d_cached(&kmap, a.k_cache, type, (int)sizeof(C), krows, D,
                                             box_rows, box_cols, sw);
    if (e == cudaSuccess)
      e = hopper::encode_2d_cached(&vmap, a.v_cache, type, (int)sizeof(C), vrows, D, box_rows,
                                   box_cols, sw);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = decode_smem_bytes<C, D, GMAX>(a.chunk, a.gran_log2, a.scores == nullptr);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  static LaunchAttrsOnce attrs;
  cudaError_t err = attrs(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.hkv, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, kmap, vmap);  // a refused cluster launch returns its error
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename C, int D>
cudaError_t launch_group(const DecodeArgs& a, int batch, long long kr, long long vr,
                         cudaStream_t s) {
  if (a.group <= 2) return launch_decode<T, C, D, 2>(a, batch, kr, vr, s);
  if (a.group <= 4) return launch_decode<T, C, D, 4>(a, batch, kr, vr, s);
  if (a.group <= 8) return launch_decode<T, C, D, 8>(a, batch, kr, vr, s);
  if (a.group <= 16) return launch_decode<T, C, D, 16>(a, batch, kr, vr, s);
  return launch_decode<T, C, D, 32>(a, batch, kr, vr, s);
}

}  // namespace xllm

// cluster: blocks a (sequence, kv head), the context splits (1-16); chunk:
// the most positions of a split, a multiple of 64 with cluster * chunk >=
// nbmax * bs; gran_log2: log2 of the granule, gcd(vt, 64) (K9, rm:
// gcd(bs, 64); an f32 cache, which rounds nothing: 64); vt: the rounding
// tile, G * bs positions; page: elements from one (layer, block) page to
// the next (PageLayout); rm: K9's row-major tails, whose completed pages
// are staged in scratch [batch, page] and counted in counters [batch];
// scores: [batch, Hkv, cluster, chunk, GMAX] f32, or null to keep the
// scores in shared memory. krows / vrows: the K and V caches from k_cache /
// v_cache on as [rows, head_dim] tensors. mode: kModeOpen, kModeLast or kModeCache (no
// window, not rm).
extern "C" int xllm_decode_attention_write(
    int device, const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* slot_mapping, const void* block_tables, const void* seq_lens,
    void* out, void* scores, void* counters, void* scratch, int dtype, int qtype,
    int head_dim, int batch, int layer, int num_blocks, int hkv, int bs, int nbmax,
    int group, float scale, int window, int cluster, int chunk, int gran_log2,
    long long page, int rm, int vt, int mode, long long krows, long long vrows, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int gran = 1 << gran_log2;
  const int span = rm ? bs : vt;
  if (cluster < 1 || cluster > xllm::kMaxCluster || chunk <= 0 || chunk % xllm::kTile ||
      (long long)cluster * chunk < (long long)nbmax * bs || batch > 65535 || hkv > 65535 ||
      group < 1 || group > 32 || vt <= 0 || vt % bs || gran_log2 < 0 || gran_log2 > 6 ||
      (dtype != XLLM_DTYPE_F32 && span % gran) || page < (long long)hkv * bs * head_dim ||
      mode < xllm::kModeOpen || mode > xllm::kModeCache ||
      (mode == xllm::kModeCache && (window > 0 || rm)) || (rm && !scratch) ||
      (rm && !counters))
    return (int)cudaErrorInvalidValue;
  xllm::DecodeArgs a;
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.slot_mapping = static_cast<const int*>(slot_mapping);
  a.block_tables = static_cast<const int*>(block_tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = out;
  a.scores = static_cast<float*>(scores);
  a.counters = static_cast<int*>(counters);
  a.scratch = scratch;
  a.page = page;
  a.layer = layer;
  a.num_blocks = num_blocks;
  a.hkv = hkv;
  a.bs = bs;
  a.nbmax = nbmax;
  a.group = group;
  a.scale = scale;
  a.window = window;
  a.cluster = cluster;
  a.chunk = chunk;
  a.gran_log2 = gran_log2;
  a.vt = vt;
  a.mode = mode;
  a.rm = rm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XLLM_HEAD_DIMS(T, C)                                                  \
  if (head_dim == 128) return (int)xllm::launch_group<T, C, 128>(a, batch, krows, vrows, s); \
  if (head_dim == 64) return (int)xllm::launch_group<T, C, 64>(a, batch, krows, vrows, s);
  // head_dim 256 (qwen3-next's full-attention layers): a cache in q's own
  // dtype or e4m3, the pairs a served model reaches (the family takes no
  // int8 KV)
#define XLLM_CACHES(T, TCODE)                                       \
  if (qtype == TCODE) {                                             \
    if (dtype == TCODE && head_dim == 256)                          \
      return (int)xllm::launch_group<T, T, 256>(a, batch, krows, vrows, s); \
    if (dtype == XLLM_DTYPE_E4M3 && head_dim == 256)                \
      return (int)xllm::launch_group<T, xllm::e4m3, 256>(a, batch, krows, vrows, s); \
    if (dtype == TCODE) { XLLM_HEAD_DIMS(T, T) }                    \
    if (dtype == XLLM_DTYPE_I8) { XLLM_HEAD_DIMS(T, int8_t) }       \
    if (dtype == XLLM_DTYPE_E4M3) { XLLM_HEAD_DIMS(T, xllm::e4m3) } \
  }
  XLLM_CACHES(__nv_bfloat16, XLLM_DTYPE_BF16)
  XLLM_CACHES(float, XLLM_DTYPE_F32)
#undef XLLM_CACHES
#undef XLLM_HEAD_DIMS
  return (int)cudaErrorInvalidValue;
}
