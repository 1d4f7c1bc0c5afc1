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
// Rounding P, on every cache but f32: the TPU kernels round the
// unnormalised P of each page to bf16 against the row's running maximum
// after that page, in one walk from position 0 (mla_attention.py:114-119:
// m_new includes the page, p.astype(b.dtype)).
//
// K11a with bf16 q (bf16 or e4m3 latent cache; mla_decode_kernel below):
// one launch a call, every latent row read from HBM once.
//
// What bounds it: bytes. A step reads every live latent row once (16
// sequences x ~1,100 tokens x 640 lanes x 2 B = 18.5 MB a layer at
// DeepSeek-V2-Lite's shapes; half on an e4m3 cache) for ~2 x 16 x 1088
// flops a row (~27 flop/B at 16 heads, ~217 at DeepSeek-V3's 128). What
// bounds it as built, measured on an H100 (per-phase clock counters in
// scratch builds): a block's stream. An SM's TMA took a 16-row stage
// (20 KB at bf16) every ~700 cycles (~25 B/cycle, with two blocks an SM),
// and a block spent ~1,500-2,000 cycles of its own a stage, so one block
// moves ~15-20 GB/s; a launch is as fast as its busiest block.
//
// Design:
// - Balanced splits, one cooperative launch. Every (sequence, head group
//   of 16 rows; 32 above 16 heads) pair is cut into splits of upr whole
//   64-position units, upr the least with which the splits of all pairs
//   fit the grid (two blocks an SM, all resident: a cooperative launch),
//   computed in the kernel from the live seq_lens (split_units, locate;
//   ops/cuda/mla_attention.decode_partition models it). A 4,096-token
//   sequence beside short ones thus gets as many blocks as its units ask
//   for, where a thread-block cluster of splits (K1's design, tried first:
//   at most 16 blocks a sequence) left its 16 blocks streaming 330 KB each.
//   Where even one split a pair is more than the grid (more pairs than
//   blocks), each pair is one split and a block walks several.
// - Loads: stages of 16 latent rows (one page segment: pages are whole
//   multiples of 16), landed by TMA boxes of [16 rows, 128 B] (one a column
//   block, thread 0 issues them) through a tensor map of the cache as
//   [L * NB * bs, Dk] with the 128-byte swizzle, into a ring of stages (3
//   at bf16 Dk 640, 5 at e4m3). An e4m3 cache lands raw (half the bytes);
//   each stage is upcast once into a bf16 copy (integer ops, NaN bytes
//   kept) that both products read. Every allowed block size (16, 32, 64,
//   multiples of 64) is a whole number of stages or a divisor of 64, so
//   TMA serves them all; there is no cp.async path (a scratch build with
//   every stage by cp.async from all threads was 1.3-1.4x slower).
// - Scores: Q K^T on mma.sync m16n8k16, q's A fragments kept in registers
//   (warp w holds the k16 steps w, w + 8, ...: five at Dk 640), K by
//   ldmatrix from the swizzled stage, each warp a partial over its steps.
//   The partials go to one of two buffers and are summed in warp order one
//   stage later, so a stage costs one barrier. A block keeps its split's
//   scores [rows, positions] in f32 in shared memory (a global scratch
//   when they outgrow 20 KB), and each granule's maximum (min(bs, 64)
//   positions).
// - P, rounded per page: each split publishes its maximum and granule
//   maxima to global memory and counts itself on its pair's counter; once
//   every split of the pair has (a spin on the counter), each stage takes
//   the running maximum M at the end of its page: the earlier splits'
//   maximum, its own prefix, and, where its last page runs past the split
//   (bs > 64), the next splits' granules up to the page's end. P =
//   bf16(exp(s - M)) replaces the score, from the same score bits, and l
//   sums exp(s - M) exp(M - M_f) (M_f: the row's final maximum).
// - Values: the first dv lanes of the split's rows, taken a second time
//   by TMA right behind the scores in the same ring (the first V stages
//   are fetched while the last K stages are scored). They come from L2:
//   the split was just read, and a layer's latent at the engine's decode
//   step (~18 MB) sits well inside the 50 MB L2, so each latent byte
//   leaves HBM once. Keeping a split's rows resident instead would cost 20
//   KB of shared memory per 16 rows. P V on mma.sync, warp w owning dv / 8
//   value columns; the accumulators move from one stage's M to the next by
//   exp(M_prev - M) (pages hold whole stages), and end in the final frame.
// - Merge: each split writes its (l, acc) to global memory and counts
//   itself; once all have, each split sums a share of the pair's outputs
//   over the splits in split order. The last split to finish re-arms the
//   pair's counters. A spin that outlives some seconds traps.
// - The new row arrives in q's dtype (or f32). Split 0 of head group 0
//   casts it (to_e4m3x2 on an e4m3 cache: the JAX package's bytes; a
//   rounding copy on bf16) and stores it at its slot; the split that holds
//   position seq_len - 1 writes the same bytes into its stage after the
//   TMA lands, so the row is attended as stored and never read back from
//   the cache. Rows of a V stage past the split's end are zeroed before P
//   V (a cache row outside the walk may hold NaN bytes).
//
// f32 q (tests and the parity models; an f32 or an fp8 latent cache; decode
// and prefill): one block per (chunk, 16-row tile) walks its rows' context
// with FMA on the CUDA cores, no TF32, no context split. On an fp8 cache
// with pages longer than its 32-key tile a first pass (PASS1: the same
// score code on the same data, so the same bits) writes each row's maximum
// per granule of min(bs, 32) positions, and the walk reads them back.
#include "common.cuh"
#include "hopper.cuh"

namespace xllm {
namespace mla {

constexpr int kWarps = 8;
constexpr int kThreadsM = kWarps * 32;

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

// a new f32 row's value as the cache stores it (e4m3: the JAX package's bytes)
template <typename C>
__device__ __forceinline__ C latent_cast(float x);
template <>
__device__ __forceinline__ float latent_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ e4m3 latent_cast<e4m3>(float x) {
  return e4m3{(uint8_t)(to_e4m3x2(x, 0.f) & 0xffu)};
}

__device__ __forceinline__ float latent_float(float x) { return x; }
__device__ __forceinline__ float latent_float(e4m3 x) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)x.bits, __NV_E4M3);
  return __half2float(__half(h));
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
    mla_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ lat_new,
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
    for (int i = tid; i < dk; i += kThreadsM) dst[i] = latent_cast<C>(lat_new[(size_t)p * dk + i]);
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
              ? latent_cast<C>(lat_new[(size_t)p * dk + d])
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
        static_cast<const float*>(q), static_cast<const float*>(lat_new),
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

// ---------------------------------------------------------------------------
// K11a with bf16 q: one cooperative launch, balanced context splits (head comment)
// ---------------------------------------------------------------------------
namespace mla_decode {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = 8;
constexpr int kRows = 16;        // latent rows a stage: a page segment, one k16 step of P V
constexpr int kUnit = 64;        // positions of a split unit: splits are whole units
constexpr int kMaxKs = 5;        // k16 steps of Q K^T a warp holds: Dk <= 640
constexpr int kMaxDk = kMaxKs * kWarps * 16;
constexpr int kMaxStages = 8;
constexpr int kBox = kRows * 128;  // bytes of a [16 rows, 128 B] box
constexpr int kAlign = 1024;       // the swizzled boxes' alignment
constexpr int kSPad = 8;           // floats past a score row: paired loads on distinct banks
constexpr int kSmemCap = kSmemMax - 1024;  // dynamic shared memory: the rest is static

struct Args {
  const __nv_bfloat16* q;  // [B, H, Dk]
  const void* lat_new;     // [B, Dk] bf16, or f32 (new_f32)
  void* cache;             // [L, NB, 1, bs, Dk] C
  const int* slot_mapping;  // [B]
  const int* block_tables;  // [B, nbmax]
  const int* seq_lens;      // [B]
  __nv_bfloat16* out;       // [B, H, dv]
  float* scores;  // [grid, GM, chunk + 8] f32, or null: shared memory
  float* pub;     // [pairs, nsp_max, (1 + chunk / gran) GM]: a split's maximum, its granules'
  float* red;     // [pairs, nsp_max, GM (DV + 1)]: a split's acc (final frame), then its l
  int* counters;  // [pairs, 3]: splits published, acc written, merged; 0 between launches
  int batch, h, dk, layer, num_blocks, bs, nbmax;
  int chunk;    // the most positions of a split (the plan's, from the table width)
  int nsp_max;  // the most splits of a pair
  int gran_log2;  // granule: min(bs, 64) positions
  int stages;     // stages in the ring
  int new_f32;
  float scale;
};

// boxes of a stage row of n values of C (128 bytes a box)
template <typename C>
__host__ __device__ __forceinline__ int boxes(int n) {
  return (n * (int)sizeof(C) + 127) / 128;
}

// Shared memory of a block: the ring; the stages' mbarriers; an e4m3
// cache's stage upcast to bf16 [16, Dk]; the split's page rows (chunk / 16
// + 2 ints); the warps' score partials of two stages [2, 8, GM, 16];
// granule maxima and their prefix [chunk / gran, GM] each; each stage's
// running maximum M and its weight exp(M - M_f) [chunk / 16, GM] each;
// five per-row arrays and the warps' l partials [8, GM]; the scores [GM,
// chunk + 8] (unless global). ops/cuda/mla_attention.decode_smem mirrors it.
template <typename C, int GM>
__host__ __device__ __forceinline__ size_t smem_bytes(int dk, int chunk, int gran_log2,
                                                     int stages, bool smem_scores) {
  return kAlign + (size_t)stages * boxes<C>(dk) * kBox + 8 * kMaxStages +
         (sizeof(C) == 1 ? (size_t)boxes<__nv_bfloat16>(dk) * kBox : 0) +
         4 * ((size_t)chunk / kRows + 2) +
         sizeof(float) * (2 * (size_t)kWarps * GM * kRows + 2 * (size_t)(chunk >> gran_log2) * GM +
                          2 * (size_t)(chunk / kRows) * GM + 5 * GM + kWarps * GM +
                          (smem_scores ? (size_t)GM * (chunk + kSPad) : 0));
}

// byte offset of the 16-byte chunk c of stage row j: TMA's 128-byte
// swizzle within each [16 rows, 128 B] box (chunk c ^ (j % 8) of its row)
__device__ __forceinline__ int soff(int j, int c) {
  return (c >> 3) * kBox + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}

// Stage rows of an e4m3 cache (`width` values each, in soff's layout) ->
// the same rows as bf16 in soff's layout at dst: 16 values a thread-step,
// exact (e4m3x4_to_bf16; NaN bytes through upcast2).
__device__ __forceinline__ void upcast_stage(const unsigned char* raw, unsigned char* dst,
                                             int width, int tid, int nthreads) {
  const int units = width / 16;  // 16 e4m3 values (16 bytes) a unit
  for (int e = tid; e < kRows * units; e += nthreads) {
    const int j = e / units, c = e % units;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + soff(j, c));
    uint32_t o[8];
    if (!hopper::e4m3_nan_bytes(v)) {
      hopper::e4m3x4_to_bf16(v.x, o[0], o[1]);
      hopper::e4m3x4_to_bf16(v.y, o[2], o[3]);
      hopper::e4m3x4_to_bf16(v.z, o[4], o[5]);
      hopper::e4m3x4_to_bf16(v.w, o[6], o[7]);
    } else {
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = upcast2<e4m3>(in[k]);
        o[2 * k + 1] = upcast2<e4m3>(in[k] >> 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + soff(j, 2 * c)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + soff(j, 2 * c + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// two values of the new row as the cache stores them (dst 2-element aligned)
__device__ __forceinline__ void put_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put_pair(e4m3* dst, float a, float b) {
  *reinterpret_cast<uint16_t*>(dst) = (uint16_t)to_e4m3x2(a, b);
}

// Wait until *c reaches `target` (thread 0 polls, with acquire order; the
// block then proceeds together). Every block of the launch is resident
// (a cooperative launch), so the counts arrive; a wait of some 2^26 polls
// (seconds) traps, so that a fault ends the launch with an error.
__device__ __forceinline__ void wait_count(const int* c, int target) {
  if (threadIdx.x == 0) {
    uint32_t polls = 0;
    while (true) {
      int v;
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(c) : "memory");
      if (v >= target) break;
      __nanosleep(100);
      if (++polls == (1u << 26)) __trap();
    }
  }
  __syncthreads();
}
// every thread's writes before it, then one count on *c -> the count
// before it (thread 0; -1 elsewhere)
__device__ __forceinline__ int signal_count(int* c) {
  __threadfence();
  __syncthreads();
  return threadIdx.x == 0 ? atomicAdd(c, 1) : -1;
}

// The launch's splits: pair p = b * groups + hg has u_p = ceil(seq_len_b /
// 64) 64-position units; every pair's splits hold upr units (the last may
// hold fewer), upr the least with sum_p ceil(u_p / upr) <= gridDim.x, so
// that the units spread evenly over the grid and every split of a pair is
// resident at once. Where even one split a pair is more than the grid
// (more pairs than blocks), each pair is one split and blocks take
// several, one after another (no split waits on another then). Warp 0.
__device__ __forceinline__ int split_units(const int* seq_lens, int pairs, int groups,
                                           int max_len, int* total_splits) {
  const int lane = threadIdx.x & 31;
  auto units = [&](int p) {
    const int n = min(seq_lens[p / groups], max_len);
    return n > 0 ? (n + kUnit - 1) / kUnit : 0;
  };
  int total = 0, most = 0;
  for (int p = lane; p < pairs; p += 32) {
    total += units(p);
    most = max(most, units(p));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, o);
    most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
  }
  int upr = max(1, min((total + (int)gridDim.x - 1) / (int)gridDim.x, most));
  while (true) {  // a few steps: sum ceil(u / upr) <= total / upr + pairs
    int nsp = 0;
    for (int p = lane; p < pairs; p += 32) nsp += (units(p) + upr - 1) / upr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) nsp += __shfl_xor_sync(0xffffffffu, nsp, o);
    if (nsp <= (int)gridDim.x || upr >= most) {
      *total_splits = nsp;
      return upr;
    }
    ++upr;
  }
}

// Split `item` of the launch (splits numbered pair after pair) -> its pair
// (-1: none), its index in the pair, the pair's splits. Warp 0.
struct Part {
  int pair, split, nsp;
};
__device__ __forceinline__ Part locate(const int* seq_lens, int pairs, int groups, int max_len,
                                       int upr, int item) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int p0 = 0; p0 < pairs; p0 += 32) {
    const int p = p0 + lane;
    const int n = p < pairs ? min(seq_lens[p / groups], max_len) : 0;
    const int c = n > 0 ? ((n + kUnit - 1) / kUnit + upr - 1) / upr : 0;
    int x = c;  // inclusive running count over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const int k = item - base;
    const unsigned hit = __ballot_sync(0xffffffffu, c > 0 && k >= x - c && k < x);
    if (hit) {
      const int l = __ffs(hit) - 1;
      const int xl = __shfl_sync(0xffffffffu, x, l), cl = __shfl_sync(0xffffffffu, c, l);
      return Part{p0 + l, k - (xl - cl), cl};
    }
    base += __shfl_sync(0xffffffffu, x, 31);
  }
  return Part{-1, 0, 0};
}

// C: the cache's element type (bf16 or e4m3); MT m16 tiles of heads a
// block (GM = 16 MT rows); DV value lanes.
template <typename C, int MT, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    mla_decode_kernel(const Args a,
                      const __grid_constant__ CUtensorMap map) {  // the cache as [rows, Dk]
  constexpr int GM = 16 * MT;
  constexpr int CW = DV / kWarps;  // P V columns a warp
  constexpr int NT = CW / 8;       // its n8 tiles
  constexpr bool kBf16 = sizeof(C) == 2;
  static_assert(NT % 2 == 0 && kThreads % GM == 0, "tile split");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  __shared__ int plan_s[4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = lane >> 2, t4 = lane & 3;
  const int groups = (a.h + GM - 1) / GM;
  const int max_len = a.nbmax * a.bs;
  if (blockIdx.x == 0)  // padded rows: no write, zeros
    for (int b = 0; b < a.batch; ++b)
      if (a.seq_lens[b] <= 0)
        for (int i = tid; i < a.h * DV; i += kThreads)
          a.out[(size_t)b * a.h * DV + i] = __float2bfloat16(0.f);
  const int pairs = a.batch * groups;
  if (warp == 0) {
    int total;
    const int upr = split_units(a.seq_lens, pairs, groups, max_len, &total);
    if (lane == 0) {
      plan_s[0] = upr;
      plan_s[1] = total;
    }
  }
  const int sbytes = boxes<C>(a.dk) * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * sbytes);
  if (tid == 0) {
    for (int st = 0; st < a.stages; ++st) hopper::mbar_init(&full[st], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int upr = plan_s[0], total_splits = plan_s[1];
  int rb = 0;  // ring stages the block's earlier splits used (mbarrier phases run on)
#pragma unroll 1
  for (int item = blockIdx.x; item < total_splits; item += gridDim.x) {
    if (warp == 0) {
      const Part w = locate(a.seq_lens, pairs, groups, max_len, upr, item);
      if (lane == 0) {
        plan_s[2] = w.pair;
        plan_s[3] = w.split * 65536 + w.nsp;
      }
    }
    __syncthreads();
    const Part pt{plan_s[2], plan_s[3] >> 16, plan_s[3] & 65535};
    const int b = pt.pair / groups, hg = pt.pair % groups;
    const int h0 = hg * GM, live = min(GM, a.h - h0);  // the group's heads
    __nv_bfloat16* o = a.out + ((size_t)b * a.h + h0) * DV;
    const int seq_len = min(a.seq_lens[b], max_len);

    // the split: positions [cs, ce), upr units
    const int bs = a.bs, gl = a.gran_log2, gran = 1 << gl;
    const int chunk = upr * kUnit, nsp = pt.nsp, rank = pt.split;
    const int cs = rank * chunk;                  // the split's first position
    const int ce = min(cs + chunk, seq_len);      // and its end
    const int n = (ce - cs + kRows - 1) / kRows;  // its stages
    constexpr int kCols = 128 / (int)sizeof(C);    // values a column block
    const int kb = boxes<C>(a.dk), vb = boxes<C>(DV);  // blocks of a K / a V stage
    const int pg0 = cs / bs;                       // the split's first page
    const int sp = a.chunk + kSPad;                // a score row's floats
    const int ngr_max = a.chunk >> gl;             // granules of the largest split
    const int pub_row = (1 + ngr_max) * GM;        // floats a split publishes
    float* pub = a.pub + (size_t)pt.pair * a.nsp_max * pub_row;  // this pair's
    float* red = a.red + (size_t)pt.pair * a.nsp_max * GM * (DV + 1);
    int* cnt = a.counters + 3 * pt.pair;

    // shared memory
    unsigned char* ring = smem;
    unsigned char* cbuf = reinterpret_cast<unsigned char*>(full + kMaxStages);  // e4m3: as bf16
    int* prow = reinterpret_cast<int*>(cbuf + (kBf16 ? 0 : boxes<__nv_bfloat16>(a.dk) * kBox));
    float* part = reinterpret_cast<float*>(prow + a.chunk / kRows + 2);  // [2, kWarps, GM, kRows]
    float* gmx = part + 2 * kWarps * GM * kRows;  // [chunk / gran, GM] granule maxima
    float* lp = gmx + ngr_max * GM;               // [chunk / gran, GM] their running prefix
    float* mst = lp + ngr_max * GM;               // [chunk / 16, GM] each stage's M
    float* wst = mst + (a.chunk / kRows) * GM;    // [chunk / 16, GM] exp(M - M_f)
    float* smax = wst + (a.chunk / kRows) * GM;   // [GM] the split's maximum
    float* mpre = smax + GM;                      // [GM] the maximum before the split
    float* mfin = mpre + GM;                      // [GM] the row's final maximum
    float* mover = mfin + GM;  // [GM] M of the split's last page where it runs past
    float* ls = mover + GM;    // [GM] l
    float* lpart = ls + GM;    // [kWarps, GM]
    float* sc = a.scores ? a.scores + (size_t)blockIdx.x * GM * sp
                         : lpart + kWarps * GM;  // [GM, chunk + 8] scores, then P

    const int* bt = a.block_tables + (size_t)b * a.nbmax;
    auto new_val = [&](int d) -> float {
      const size_t i = (size_t)b * a.dk + d;
      return a.new_f32 ? static_cast<const float*>(a.lat_new)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(a.lat_new)[i]);
    };

    // the cache row of each page of the split (read once from the block table)
    for (int k = tid; k <= (ce - 1) / bs - pg0; k += kThreads)
      prow[k] = (int)(((long long)a.layer * a.num_blocks + bt[pg0 + k]) * bs);
    // q's A fragments: warp w holds k16 steps w, w + 8, ... (rows past the
    // group's heads, and steps past Dk, are zeros)
    const int nks = a.dk / 16;
    uint32_t qa[MT][kMaxKs][4];
    {
      const __nv_bfloat16* qg = a.q + ((size_t)b * a.h + h0) * a.dk;
      auto qpair = [&](int r, int col) -> uint32_t {
        return r < live ? *reinterpret_cast<const uint32_t*>(qg + (size_t)r * a.dk + col) : 0u;
      };
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ii = 0; ii < kMaxKs; ++ii) {
          const int ks = warp + kWarps * ii, r = mt * 16 + g0, col = ks * 16 + 2 * t4;
          const bool ok = ks < nks;
          qa[mt][ii][0] = ok ? qpair(r, col) : 0u;
          qa[mt][ii][1] = ok ? qpair(r + 8, col) : 0u;
          qa[mt][ii][2] = ok ? qpair(r, col + 8) : 0u;
          qa[mt][ii][3] = ok ? qpair(r + 8, col + 8) : 0u;
        }
    }
    // this lane's ldmatrix rows of a bf16 stage: K for Q K^T (key row lane %
    // 8 + 8 (lane / 16), chunk half (lane / 8) % 2 of each k16 step; steps
    // past Dk read a valid step, times q's zero fragment)
    int koff[kMaxKs];
#pragma unroll
    for (int ii = 0; ii < kMaxKs; ++ii)
      koff[ii] = soff((lane & 7) + 8 * (lane >> 4),
                      2 * min(warp + kWarps * ii, nks - 1) + ((lane >> 3) & 1));
    const int c0 = warp * CW;  // this warp's P V columns
    __syncthreads();

    // ring stage i: the split's K stage i (i < n; all Dk lanes), then its V
    // stage i - n (the first DV lanes of the same rows): one 2-d box of [16
    // rows, 128 B] a column block (lanes past Dk land as zeros), issued by
    // thread 0
    auto fetch = [&](int i) {
      if (tid != 0 || i >= 2 * n) return;
      const bool isv = i >= n;
      const int t0 = cs + (isv ? i - n : i) * kRows;
      const int slot = (rb + i) % a.stages;
      unsigned char* dst = ring + slot * sbytes;
      const int row = prow[t0 / bs - pg0] + t0 % bs;
      const int nbx = isv ? vb : kb;
      uint64_t* bar = &full[slot];
      hopper::fence_async_shared();  // the slot's earlier reads before the copies' writes
      hopper::mbar_expect_tx(bar, (uint32_t)nbx * kBox);
      for (int bx = 0; bx < nbx; ++bx)
        hopper::tma_load_2d(dst + bx * kBox, &map, bar, bx * kCols, row);
    };
    // ring stage i landed: the new row (position seq_len - 1) written in as
    // stored (over the cache's old row the copies may bring); a V stage's
    // rows past the split zeroed (P is 0 there, and a row may hold NaN);
    // an e4m3 stage upcast into cbuf -> the stage as bf16
    auto land = [&](int i) -> const unsigned char* {
      hopper::mbar_wait(&full[(rb + i) % a.stages], ((rb + i) / a.stages) & 1);
      const bool isv = i >= n;
      const int t0 = cs + (isv ? i - n : i) * kRows;
      unsigned char* st = ring + ((rb + i) % a.stages) * sbytes;
      const int width = isv ? DV : a.dk;
      const int j = seq_len - 1 - t0;
      if (j >= 0 && j < kRows)
        for (int d = 2 * tid; d < width; d += 2 * kThreads) {
          const int byte = d * (int)sizeof(C);
          put_pair(reinterpret_cast<C*>(st + soff(j, byte >> 4) + (byte & 15)), new_val(d),
                   new_val(d + 1));
        }
      if (isv && t0 + kRows > ce) {
        const int j0 = ce - t0, chunks = vb * 8;
        for (int e = tid; e < (kRows - j0) * chunks; e += kThreads)
          *reinterpret_cast<uint4*>(st + soff(j0 + e / chunks, e % chunks)) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();  // the stage complete (and, e4m3, the last stage's bf16 copy read)
      if constexpr (kBf16) {
        return st;
      } else {
        upcast_stage(st, cbuf, (width + 15) / 16 * 16, tid, kThreads);
        __syncthreads();
        return cbuf;
      }
    };

#pragma unroll 1
    for (int s = 0; s < a.stages - 1; ++s) fetch(s);

    if (rank == 0 && hg == 0) {  // write, then read: the new row at its slot
      const int slot = a.slot_mapping[b];
      C* dst = static_cast<C*>(a.cache) +
               (((size_t)a.layer * a.num_blocks + slot / bs) * bs + slot % bs) * a.dk;
      for (int d = 2 * tid; d < a.dk; d += 2 * kThreads)
        put_pair(dst + d, new_val(d), new_val(d + 1));
    }

    // phase A: the scores of the split's K stages (-inf past its end), and
    // the running maximum of each granule (a stage lies in one granule). One
    // barrier a stage: the partials go to one of two buffers, and the sum of
    // stage i - 1 runs after stage i's barrier, beside stage i's products
    const int spg = gran / kRows;  // stages a granule
    auto reduce = [&](int i) {  // stage i's partials -> its scores and granule maximum
      const float* pp = part + (i & 1) * kWarps * GM * kRows;
      const int t0 = cs + i * kRows;
      const bool first = i % spg == 0;
      float* gk = gmx + (i / spg) * GM;
#pragma unroll
      for (int e0 = 0; e0 < GM * kRows; e0 += kThreads) {  // 16 lanes a row, the same each stage
        const int row = (e0 + tid) >> 4, key = tid & 15;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += pp[(w * GM + row) * kRows + key];
        const float x = t0 + key < ce ? s * a.scale : -INFINITY;
        sc[row * sp + i * kRows + key] = x;
        float m = x;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (key == 0) gk[row] = first ? m : fmaxf(gk[row], m);
      }
    };
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const unsigned char* st = land(i);
      fetch(i + a.stages - 1);  // into stage i - 1's slot, consumed before land's barrier
      float d[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.f;
      uint32_t kf[kMaxKs][4];  // (k 0-7, k 8-15) of keys 0-7, then of keys 8-15
#pragma unroll
      for (int ii = 0; ii < kMaxKs; ++ii) ldmatrix_x4(kf[ii], st + koff[ii]);
#pragma unroll
      for (int ii = 0; ii < kMaxKs; ++ii)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(d[mt][0], qa[mt][ii], kf[ii][0], kf[ii][1]);
          mma_bf16(d[mt][1], qa[mt][ii], kf[ii][2], kf[ii][3]);
        }
      float* pp = part + (i & 1) * kWarps * GM * kRows;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float* pw = pp + ((warp * GM + mt * 16 + g0) * kRows) + 8 * nt + 2 * t4;
          *reinterpret_cast<float2*>(pw) = make_float2(d[mt][nt][0], d[mt][nt][1]);
          *reinterpret_cast<float2*>(pw + 8 * kRows) = make_float2(d[mt][nt][2], d[mt][nt][3]);
        }
      if (i > 0) reduce(i - 1);  // its partials were complete at land's barrier
    }
    __syncthreads();
    reduce(n - 1);

    // the split's granule maxima: their running prefix, its maximum; both
    // published with the granules for the pair's other splits
    __syncthreads();
    const int ng = (n + spg - 1) / spg;
    for (int g = warp; g < GM; g += kWarps) {
      float carry = -INFINITY;
      for (int k0 = 0; k0 < ng; k0 += 32) {
        float x = k0 + lane < ng ? gmx[(k0 + lane) * GM + g] : -INFINITY;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x = fmaxf(x, y);
        }
        x = fmaxf(x, carry);
        if (k0 + lane < ng) lp[(k0 + lane) * GM + g] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
      if (lane == 0) smax[g] = carry;
    }
    __syncthreads();
    float* mine = pub + (size_t)rank * pub_row;
    for (int i = tid; i < (1 + ng) * GM; i += kThreads) mine[i] = i < GM ? smax[i] : gmx[i - GM];
    signal_count(&cnt[0]);
    wait_count(&cnt[0], nsp);  // every split of the pair published

    // per row: the maximum before the split, the final one, and M of the
    // split's last page where it runs past the split (the next splits'
    // granules up to the page's end)
    const int e_over = min(((ce - 1) / bs + 1) * bs, seq_len);
    for (int g = warp; g < GM; g += kWarps) {
      float pre = -INFINITY, all = -INFINITY;
      for (int s2 = lane; s2 < nsp; s2 += 32) {
        const float m = __ldcg(pub + (size_t)s2 * pub_row + g);
        all = fmaxf(all, m);
        if (s2 < rank) pre = fmaxf(pre, m);
      }
      pre = warp_max(pre);
      all = warp_max(all);
      float over = -INFINITY;
      for (int p = ce + (lane << gl); p < e_over; p += 32 << gl) {
        const int s2 = p / chunk, k = (p - s2 * chunk) >> gl;
        over = fmaxf(over, __ldcg(pub + (size_t)s2 * pub_row + GM + k * GM + g));
      }
      over = warp_max(over);
      if (lane == 0) {
        mpre[g] = pre;
        mfin[g] = all;
        mover[g] = fmaxf(fmaxf(pre, smax[g]), over);
      }
    }
    __syncthreads();
    // M of each stage: the running maximum at the end of its page; its weight
    for (int idx = tid; idx < n * GM; idx += kThreads) {
      const int u = idx / GM, g = idx % GM;
      const int e = min(((cs + u * kRows) / bs + 1) * bs, seq_len);
      const float m = e <= ce ? fmaxf(mpre[g], lp[(((e - cs + gran - 1) >> gl) - 1) * GM + g])
                              : mover[g];
      mst[idx] = m;
      wst[idx] = expf(m - mfin[g]);
    }
    __syncthreads();
    // P = bf16(exp(s - M)) in place of the scores; l in the final frame. A
    // warp walks rows g = warp, warp + 8, ..., each lane a pair of positions
#pragma unroll
    for (int r = 0; r < GM / kWarps; ++r) {
      const int g = warp + kWarps * r;
      float* row = sc + g * sp;
      float l = 0.f;
      for (int p = 2 * lane; p < n * kRows; p += 64) {
        const float m = mst[(p / kRows) * GM + g], w = wst[(p / kRows) * GM + g];
        const float2 s2v = *reinterpret_cast<const float2*>(row + p);
        const float pe0 = s2v.x == -INFINITY ? 0.f : expf(s2v.x - m);
        const float pe1 = s2v.y == -INFINITY ? 0.f : expf(s2v.y - m);
        l += (pe0 + pe1) * w;
        *reinterpret_cast<float2*>(row + p) = make_float2(round_bf16(pe0), round_bf16(pe1));
      }
      l = warp_sum(l);
      if (lane == 0) ls[g] = l;
    }

    // phase C: acc += P V over the split's V stages, warp w owning value
    // columns [w CW, (w + 1) CW), each stage in its own page's frame
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll 1
    for (int i = n; i < 2 * n; ++i) {
      const unsigned char* vs = land(i);
      fetch(i + a.stages - 1);  // into stage i - 1's slot, consumed before land's barrier
      const int u = i - n;
      // the accumulators into this stage's frame (pages hold whole stages)
      if (u > 0) {
        float lo[MT], hi[MT];
        bool one = true;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* m1 = mst + u * GM + mt * 16 + g0;
          const float* m0 = m1 - GM;
          lo[mt] = m0[0] == m1[0] ? 1.f : expf(m0[0] - m1[0]);
          hi[mt] = m0[8] == m1[8] ? 1.f : expf(m0[8] - m1[8]);
          one = one && lo[mt] == 1.f && hi[mt] == 1.f;
        }
        if (!__all_sync(0xffffffffu, one)) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              acc[mt][j][0] *= lo[mt];
              acc[mt][j][1] *= lo[mt];
              acc[mt][j][2] *= hi[mt];
              acc[mt][j][3] *= hi[mt];
            }
        }
      }
      // P's A fragments (bf16 values held in f32: exact)
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* pr = sc + (mt * 16 + g0) * sp + u * kRows + 2 * t4;
        const float2 p00 = *reinterpret_cast<const float2*>(pr);
        const float2 p10 = *reinterpret_cast<const float2*>(pr + 8 * sp);
        const float2 p01 = *reinterpret_cast<const float2*>(pr + 8);
        const float2 p11 = *reinterpret_cast<const float2*>(pr + 8 * sp + 8);
        pa[mt][0] = bf16x2_bits(p00.x, p00.y);
        pa[mt][1] = bf16x2_bits(p10.x, p10.y);
        pa[mt][2] = bf16x2_bits(p01.x, p01.y);
        pa[mt][3] = bf16x2_bits(p11.x, p11.y);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];  // (k 0-7, k 8-15) of n8 tile j, then of tile j + 1
        ldmatrix_x4_trans(bb, vs + soff(lane & 15, (c0 >> 3) + j + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][j], pa[mt], bb[0], bb[1]);
          mma_bf16(acc[mt][j + 1], pa[mt], bb[2], bb[3]);
        }
      }
    }

    // the split's acc [GM, DV] in the final frame, and its l, for the merge
    float* myred = red + (size_t)rank * GM * (DV + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g0 + 8 * half;
        const float f = wst[(n - 1) * GM + r];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          __stcg(reinterpret_cast<float2*>(myred + (size_t)r * DV + c0 + j * 8 + 2 * t4),
                 make_float2(acc[mt][j][2 * half] * f, acc[mt][j][2 * half + 1] * f));
      }
    if (tid < GM) myred[GM * DV + tid] = ls[tid];
    signal_count(&cnt[1]);
    wait_count(&cnt[1], nsp);  // every split's (l, acc) written

    // the merge, in split order: l per row once, then each split a share of
    // the live rows' outputs, four at a time
    if (tid < GM) {
      float l = 0.f;
      for (int s2 = 0; s2 < nsp; ++s2)
        l += __ldcg(red + (size_t)s2 * GM * (DV + 1) + GM * DV + tid);
      lpart[tid] = l;
    }
    __syncthreads();
    const int total = live * (DV / 4), per = (total + nsp - 1) / nsp;
    for (int i = rank * per + tid; i < min(total, (rank + 1) * per); i += kThreads) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s2 = 0; s2 < nsp; ++s2) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(red + (size_t)s2 * GM * (DV + 1)) + i);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const float l = lpart[i / (DV / 4)];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + (size_t)i * 4);
      dst[0] = l > 0.f ? __floats2bfloat162_rn(s.x / l, s.y / l) : __floats2bfloat162_rn(0.f, 0.f);
      dst[1] = l > 0.f ? __floats2bfloat162_rn(s.z / l, s.w / l) : __floats2bfloat162_rn(0.f, 0.f);
    }
    // the last split of the pair to finish re-arms its counters
    if (signal_count(&cnt[2]) == nsp - 1) {
      cnt[0] = 0;
      cnt[1] = 0;
      cnt[2] = 0;
    }
    rb += 2 * n;
    __syncthreads();  // the split's shared memory read before the next one's
  }
}

template <typename C, int MT, int DV>
cudaError_t launch(const Args& a, int grid, long long rows, cudaStream_t stream) {
  auto kernel = mla_decode_kernel<C, MT, DV>;
  constexpr int kElem = (int)sizeof(C), kCols = 128 / kElem;
  const CUtensorMapDataType type =
      kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap map{};
  cudaError_t err = hopper::encode_2d_cached(&map, a.cache, type, kElem, rows, a.dk, kRows,
                                             kCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<C, 16 * MT>(a.dk, a.chunk, a.gran_log2, a.stages,
                                            a.scores == nullptr);
  if (smem > (size_t)kSmemCap) return cudaErrorInvalidValue;
  static AllowSmemOnce allow;  // the most, once
  err = allow(kernel, kSmemCap);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  // every block resident: the splits of a pair wait on each other
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, map);  // a grid too large to be resident is refused
  return err != cudaSuccess ? err : cudaGetLastError();
}

// blocks of this instance an SM holds at once with `smem` bytes of shared
// memory a block
template <typename C, int MT, int DV>
cudaError_t blocks_per_sm(size_t smem, int* out) {
  auto kernel = mla_decode_kernel<C, MT, DV>;
  static AllowSmemOnce allow;
  cudaError_t err = allow(kernel, kSmemCap);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, smem);
}

}  // namespace mla_decode
}  // namespace xllm

// K11a with bf16 q: dtype the cache's (bf16 or e4m3); lat_new bf16, or f32
// (new_f32); gm 16 or 32 rows a block (heads in groups of gm); grid: the
// blocks, at most those the card holds at once; chunk: the most positions
// of a split, a multiple of 64 (the kernel cuts upr 64-position units a
// split from the live lengths; upr * 64 <= chunk for any lengths up to
// nbmax * bs); nsp_max: the most splits of a pair (>= the table's units,
// or the grid); gran_log2: log2 of min(bs, 64); stages: 2-8 ring stages;
// scores: [grid, gm, chunk + 8] f32, or null to keep the scores in shared
// memory; pub [pairs, nsp_max, (1 + chunk / gran) gm] and red [pairs,
// nsp_max, gm (dv + 1)] f32; counters [pairs, 3] int, zeros (the kernel
// leaves them so). dk a multiple of 16 up to 640, dv 128, 256 or 512, bs a
// multiple of 16 that divides 64 or is a multiple of it.
extern "C" int xllm_mla_decode(int device, const void* q, const void* lat_new, void* cache,
                               const void* slot_mapping, const void* block_tables,
                               const void* seq_lens, void* out, void* scores, void* pub,
                               void* red, void* counters, int dtype, int new_f32, int batch,
                               int h, int dk, int dv, int layer, int num_layers,
                               int num_blocks, int bs, int nbmax, float scale, int gm, int grid,
                               int chunk, int nsp_max, int gran_log2, int stages, void* stream) {
  using namespace xllm::mla_decode;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)num_layers * num_blocks * bs;
  if (grid < 1 || chunk <= 0 || chunk % kUnit || batch < 1 || h < 1 || dk % 16 ||
      dk > kMaxDk || bs % kRows || (bs < kUnit ? kUnit % bs : bs % kUnit) || gran_log2 < 4 ||
      (1 << gran_log2) != (bs < kUnit ? bs : kUnit) || stages < 2 || stages > kMaxStages ||
      rows >= (1ll << 31) || (gm != 16 && gm != 32) || !pub || !red || !counters ||
      nsp_max < 1)
    return (int)cudaErrorInvalidValue;
  xllm::mla_decode::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.lat_new = lat_new;
  a.cache = cache;
  a.slot_mapping = static_cast<const int*>(slot_mapping);
  a.block_tables = static_cast<const int*>(block_tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.scores = static_cast<float*>(scores);
  a.pub = static_cast<float*>(pub);
  a.red = static_cast<float*>(red);
  a.counters = static_cast<int*>(counters);
  a.batch = batch;
  a.h = h;
  a.dk = dk;
  a.layer = layer;
  a.num_blocks = num_blocks;
  a.bs = bs;
  a.nbmax = nbmax;
  a.chunk = chunk;
  a.nsp_max = nsp_max;
  a.gran_log2 = gran_log2;
  a.stages = stages;
  a.new_f32 = new_f32;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XLLM_LAUNCH(C, MT, DV) \
  if (dv == DV) return (int)launch<C, MT, DV>(a, grid, rows, st);
#define XLLM_VALUE_DIMS(C, MT) \
  XLLM_LAUNCH(C, MT, 512) XLLM_LAUNCH(C, MT, 256) XLLM_LAUNCH(C, MT, 128)
#define XLLM_GROUPS(C)                           \
  if (gm == 16) { XLLM_VALUE_DIMS(C, 1) }        \
  if (gm == 32) { XLLM_VALUE_DIMS(C, 2) }
  if (dtype == XLLM_DTYPE_BF16) { XLLM_GROUPS(__nv_bfloat16) }
  if (dtype == XLLM_DTYPE_E4M3) { XLLM_GROUPS(xllm::e4m3) }
#undef XLLM_GROUPS
#undef XLLM_VALUE_DIMS
#undef XLLM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// *out: the blocks of the instance (dtype, gm, dv) an SM holds at once,
// each with `smem` bytes of shared memory
extern "C" int xllm_mla_decode_blocks_per_sm(int device, int dtype, int gm, int dv,
                                             long long smem, int* out) {
  using namespace xllm::mla_decode;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
#define XLLM_QUERY(C, MT, DV) \
  if (dv == DV) return (int)blocks_per_sm<C, MT, DV>((size_t)smem, out);
#define XLLM_VALUE_DIMS(C, MT) \
  XLLM_QUERY(C, MT, 512) XLLM_QUERY(C, MT, 256) XLLM_QUERY(C, MT, 128)
#define XLLM_GROUPS(C)                    \
  if (gm == 16) { XLLM_VALUE_DIMS(C, 1) } \
  if (gm == 32) { XLLM_VALUE_DIMS(C, 2) }
  if (dtype == XLLM_DTYPE_BF16) { XLLM_GROUPS(__nv_bfloat16) }
  if (dtype == XLLM_DTYPE_E4M3) { XLLM_GROUPS(xllm::e4m3) }
#undef XLLM_GROUPS
#undef XLLM_VALUE_DIMS
#undef XLLM_QUERY
  return (int)cudaErrorInvalidValue;
}

// K11a / K11b with f32 q: decode != 0 is K11a (s == 1, q_offsets unused,
// lat_new (f32, cast here) and slot_mapping read); else K11b
// (lat_new and slot_mapping unused). The cache is f32 or e4m3; any dk and
// dv <= dk; no context split. An e4m3 cache needs gmax [P, S*H, ngran] with
// gran = min(bs, 32), bs a divisor or a multiple of 32, and ngran >=
// ceil(nbmax * bs / 32) * 32 / gran.
extern "C" int xllm_mla_attention(int device, int decode, const void* q,
                                  const void* lat_new, void* cache,
                                  const void* slot_mapping, const void* block_tables,
                                  const void* q_offsets, const void* kv_lens,
                                  void* gmax, void* out, int dtype, int p, int s, int h,
                                  int dk, int dv, int layer, int num_blocks, int bs,
                                  int nbmax, float scale, int gran, int ngran, void* stream) {
  using namespace xllm::mla;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (p > 65535 || dv > dk) return (int)cudaErrorInvalidValue;
  if (dtype == XLLM_DTYPE_E4M3 &&
      (gran != (bs < kFT ? bs : kFT) || (bs < kFT ? kFT % bs : bs % kFT) ||
       (long long)ngran * gran < ((long long)nbmax * bs + kFT - 1) / kFT * kFT))
    return (int)cudaErrorInvalidValue;
  const int* sm = static_cast<const int*>(slot_mapping);
  const int* bt = static_cast<const int*>(block_tables);
  const int* qo = static_cast<const int*>(q_offsets);
  const int* kl = static_cast<const int*>(kv_lens);
  float* gm = static_cast<float*>(gmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  return (int)cudaErrorInvalidValue;
}
