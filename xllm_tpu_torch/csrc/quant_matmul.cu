// K5, K6, K7: matrix products that stream a weight [K, N] (or one layer
// of a stack [L, K, N]) against activations x [M, K] -> f32 out [M, N].
//
// Replaces the nine Pallas functions of xllm_tpu/ops/pallas/quant_matmul.py
// with three kernels and three contracts:
//   K5 w8a8 (quant_matmul_int8, _int8_v2, _int8_v2_stacked): x quantized per
//      token (xq int8, sx [M] f32) by quantize_rows_kernel, the JAX
//      package's quantizer outside pallas_call; int8 x int8 products summed
//      exactly in int32 by qmm_s8_kernel; out = (float(acc) * sx[m]) * sw[n];
//   K6 fp8 weight-only (quant_matmul_fp8, _fp8_v2, _fp8_v2_stacked,
//      _fp8_stacked): x in bf16, e4m3 weights upcast to bf16 (exact), f32
//      sums, out = acc * sw[n];
//   K7 bf16 weight streaming (matmul_bf16_v2, matmul_bf16_stacked): K6 with
//      bf16 weights and no scale.
// A stacked form is the same launch with the weight and scale pointers
// offset by the layer (the wrapper does the arithmetic).
//
// What bounds it on the card: bytes at decode (M = 16: every weight byte is
// read once for 2 x 16 products, far below the ~295 operations a byte at
// which bf16 tensor cores, or ~590 for int8 ones, take over), operations for
// a full prefill chunk (M = 2048). The TPU kernels split each weight tile's
// DMA four ways and keep K resident in VMEM.
//
// All three GEMMs share one shape, planned in ops/cuda/quant_matmul.py
// (plan for K6 / K7, int8_plan for K5):
// - a producer warpgroup whose first thread keeps TMA loads in flight into
//   a ring of stages (both operands in the 128-byte swizzle), guarded by
//   full / empty mbarriers;
// - consumer warpgroups run wgmma from shared memory (and, for K5, from
//   registers), one stage at a time;
// - a persistent grid (at most one block an SM) walks work units: output
//   tiles, each split over K into `splits` ranges of whole stages when the
//   plan asks (few tiles). A split unit writes its partial to a workspace;
//   the last unit of a tile to finish (a counter it resets) sums the
//   partials in split order and scales once, so the result does not depend
//   on which block finishes last.
// Rows past M and columns past N are zero-filled by TMA and masked at the
// stores; so is a last stage past K. setmaxnreg moves the producer's (and a
// converter's) registers to the consumers.
//
// K6 / K7 (qmm_ws_kernel): x [BM x 64] K-major and the weight [64 x 128] as
// it lies; wgmma m64n128k16 bf16 -> f32, B read MN-major through wgmma's
// transpose bit, one product group kept in flight: BM 64 (one consumer
// warpgroup; every M up to 64), 128 (two of 64 rows) or 256 (two of 128
// rows, two products a k16 step). e4m3 weights land as bytes; a converter
// warpgroup upcasts each stage once into the swizzled bf16 tile the
// consumers read (integer and bf16 operations, exact; NaN bytes through
// upcast2<e4m3>), while the consumers multiply the stage before.
//
// K5 (qmm_s8_kernel): 8-bit wgmma reads A and B only K-major, and the weight
// lies N-major, so the kernel computes out^T = W^T . xq^T: 128 weight
// columns a tile, 64 a consumer warpgroup, are wgmma's A (m64), built in
// registers from the TMA-landed [128 k x 128 n] stage by ldmatrix.trans
// and byte permutes (hopper.cuh s8_frag_mn; no pass through shared memory);
// the tokens are its N (16 a tile for a decode step, 64, 128 or 256 for
// prefill chunks), xq [NT x 128 k] read K-major from shared memory as TMA
// lands it. m64nNk32 .s32.s8.s8, exact int32 sums; a split's partials are
// int32 too. (A converter warpgroup that stores the same fragments as a
// K-major tile for A from shared memory measured about 2x slower: PERF.md.)
#include "common.cuh"
#include "hopper.cuh"

namespace xllm {
namespace qmm {

// ---------------------------------------------------------------------------
// K6 / K7: TMA + wgmma, warp-specialised, persistent, split over K
// ---------------------------------------------------------------------------
constexpr int kWsBK = 64;    // k a stage: one 128-byte swizzled row of bf16 x
constexpr int kWsBN = 128;   // output columns a tile: two 64-column weight blocks
constexpr int kWsBlockB = kWsBK * 128;  // bytes of one 64-column bf16 block
constexpr int kWsBlockA = 64 * 128;     // bytes of 64 rows of x

// NC consumer warpgroups of MI x 64 rows each, for e4m3 weights a
// converter warpgroup, then a producer warpgroup
template <bool kFp8, int NC, int MI>
struct WsTiles {
  static constexpr int BM = 64 * NC * MI;
  static constexpr int kThreads = 128 * (NC + (kFp8 ? 2 : 1));
  static constexpr int kA = BM * kWsBK * 2;             // bf16 x, bytes
  static constexpr int kB = 2 * kWsBlockB;              // bf16 weight (wgmma reads)
  static constexpr int kRaw = kFp8 ? kWsBK * kWsBN : 0;  // e4m3 bytes as TMA lands them
  static constexpr int kStage = kA + kB + kRaw;         // a multiple of 1024
  static constexpr int kRing = 224 * 1024 / kStage;
  static constexpr int kStages = kRing > 8 ? 8 : kRing;
  static constexpr uint32_t kTx = kA + (kFp8 ? kRaw : kB);
  static constexpr size_t smem() {
    return 1024 + (size_t)kStages * kStage + 3 * kStages * sizeof(uint64_t) + 16;
  }
};

// work unit u -> output tile (tm, tn) and its k-block range [kb0, kb1):
// splits outermost, then column tiles, row tiles fastest (concurrent units
// share weight tiles in L2). ops/cuda/quant_matmul.layout computes the
// same ranges.
struct Unit {
  int tile, tm, tn, split, kb0, kb1;
};
__device__ __forceinline__ Unit unit_of(int u, int tiles_m, int tiles, int splits,
                                        int kb_all) {
  Unit w;
  w.split = u / tiles;
  w.tile = u - w.split * tiles;
  w.tn = w.tile / tiles_m;
  w.tm = w.tile - w.tn * tiles_m;
  w.kb0 = (int)((long long)w.split * kb_all / splits);
  w.kb1 = (int)((long long)(w.split + 1) * kb_all / splits);
  return w;
}

template <bool kFp8, int NC, int MI>
__global__ void __launch_bounds__(WsTiles<kFp8, NC, MI>::kThreads, 1)
    qmm_ws_kernel(const __grid_constant__ CUtensorMap xmap,  // bf16 [M, K]
                  const __grid_constant__ CUtensorMap wmap,  // bf16 / e4m3 [K, N]
                  const float* __restrict__ sw,              // [N] or null
                  float* __restrict__ out,                   // [M, N]
                  float* __restrict__ part,                  // [splits, M, N] if splits > 1
                  int* __restrict__ tile_count,              // [tiles], zero between launches
                  int m, int k, int n, int tiles_m, int tiles_n, int splits) {
  using namespace hopper;
  using T = WsTiles<kFp8, NC, MI>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)S * T::kStage);
  uint64_t* empty = full + S;
  uint64_t* conv = empty + S;
  volatile int* last_flag = reinterpret_cast<volatile int*>(conv + S);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
      mbar_init(&conv[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tiles = tiles_m * tiles_n, units = tiles * splits;
  const int kb_all = (k + kWsBK - 1) / kWsBK;
  const int wg = tid / 128;

  if (wg == NC + (kFp8 ? 1 : 0)) {
    // ---- producer warpgroup: one thread issues every TMA load
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (tid % 128 == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, tiles_m, tiles, splits, kb_all);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          unsigned char* st = base + (size_t)s * T::kStage;
          mbar_expect_tx(&full[s], T::kTx);
          tma_load_2d(st, &xmap, &full[s], kb * kWsBK, w.tm * T::BM);
          if constexpr (kFp8) {
            tma_load_2d(st + T::kA + T::kB, &wmap, &full[s], w.tn * kWsBN, kb * kWsBK);
          } else {
            tma_load_2d(st + T::kA, &wmap, &full[s], w.tn * kWsBN, kb * kWsBK);
            tma_load_2d(st + T::kA + kWsBlockB, &wmap, &full[s], w.tn * kWsBN + 64,
                        kb * kWsBK);
          }
        }
      }
    }
  } else if (kFp8 && wg == NC) {
    // ---- converter warpgroup: [64 k x 128 n] e4m3 bytes -> two swizzled
    // [64 x 64] bf16 blocks, four 16-byte chunks (a row's 16 columns) a
    // thread, loads first and the four conversions in one straight line
    if constexpr (NC == 2) setmaxnreg_dec<80>();
    const int c = tid % 128;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, tiles_m, tiles, splits, kb_all);
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        unsigned char* st = base + (size_t)s * T::kStage;
        e4m3_stage_to_bf16(st + T::kA + T::kB, st + T::kA, c);
        fence_async_shared();
        mbar_arrive(&conv[s]);
      }
    }
  } else {
    // ---- consumer warpgroups: rows [64 MI wg, 64 MI (wg + 1)) of each tile
    if constexpr (NC == 2) setmaxnreg_inc<kFp8 ? 192 : 224>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    float acc[MI][64];
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, tiles_m, tiles, splits, kb_all);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;
      int prev = -1;
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        if constexpr (kFp8) mbar_wait(&conv[s], (it / S) & 1);
        const unsigned char* st = base + (size_t)s * T::kStage;
        const uint32_t a0 = smem_u32(st) + wg * MI * kWsBlockA;
        const uint32_t b0 = smem_u32(st + T::kA);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWsBK / 16; ++kk)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            wgmma_m64n128k16_bf16(acc[mi], gmma_desc(a0 + mi * kWsBlockA + 32 * kk, 16, 1024),
                                  gmma_desc(b0 + 2048 * kk, kWsBlockB, 1024));
        wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
        wgmma_wait<1>();  // the stage before this one is read
        if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
      if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);

      // epilogue: fragments (row 16 warp + lane / 4 + 8 h of each 64-row
      // block, column 8 j + 2 (lane % 4) + e) -> out scaled, or this
      // split's partial
      const int col0 = w.tn * kWsBN + 2 * (lane % 4);
      float* dst = splits == 1 ? out : part + (size_t)w.split * m * n;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row0 = w.tm * T::BM + (wg * MI + mi) * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < kWsBN / 8; ++j) {
          const int col = col0 + 8 * j;
          if (col >= n) continue;  // n % 16 == 0: col + 1 < n as well
          const float s0 = (splits == 1 && sw) ? sw[col] : 1.f;
          const float s1 = (splits == 1 && sw) ? sw[col + 1] : 1.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row < m)
              *reinterpret_cast<float2*>(dst + (size_t)row * n + col) =
                  make_float2(acc[mi][4 * j + 2 * h] * s0, acc[mi][4 * j + 2 * h + 1] * s1);
          }
        }
      }
      if (splits == 1) continue;
      // the tile's last split to finish sums the partials in split order,
      // four splits' loads in flight at a time
      __threadfence();
      named_sync(1, 128 * NC);
      if (tid == 0) *last_flag = atomicAdd(&tile_count[w.tile], 1) == splits - 1;
      named_sync(1, 128 * NC);
      if (!*last_flag) continue;
      __threadfence();
      const int r_base = w.tm * T::BM, c_base = w.tn * kWsBN;
      const int rows = min(T::BM, m - r_base), quads = min(kWsBN, n - c_base) / 4;
      const size_t plane = (size_t)m * n;
      constexpr int Q = 4;  // quads a thread sums at once: Q x 4 loads in flight
      const int total = rows * quads;
      for (int q0 = tid; q0 < total; q0 += 128 * NC * Q) {
        const float* p[Q];
        float4 a[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const int q = min(q0 + i * 128 * NC, total - 1);
          p[i] = part + (size_t)(r_base + q / quads) * n + c_base + (q % quads) * 4;
          a[i] = __ldcg(reinterpret_cast<const float4*>(p[i]));
        }
        for (int sp = 1; sp < splits; sp += 4) {
          float4 b[4][Q];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < Q; ++i)
              if (sp + j < splits)
                b[j][i] = __ldcg(reinterpret_cast<const float4*>(p[i] + (sp + j) * plane));
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < Q; ++i)
              if (sp + j < splits) {
                a[i].x += b[j][i].x;
                a[i].y += b[j][i].y;
                a[i].z += b[j][i].z;
                a[i].w += b[j][i].w;
              }
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const int q = q0 + i * 128 * NC;
          if (q >= total) break;
          const int c = c_base + (q % quads) * 4;
          if (sw) {
            a[i].x *= sw[c];
            a[i].y *= sw[c + 1];
            a[i].z *= sw[c + 2];
            a[i].w *= sw[c + 3];
          }
          *reinterpret_cast<float4*>(out + (size_t)(r_base + q / quads) * n + c) = a[i];
        }
      }
      if (tid == 0) tile_count[w.tile] = 0;
    }
  }
}

template <bool kFp8, int NC, int MI>
cudaError_t launch_ws(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* sw,
                      float* out, float* part, int* tile_count, int m, int k, int n,
                      int splits, int grid, cudaStream_t stream) {
  using T = WsTiles<kFp8, NC, MI>;
  auto kernel = qmm_ws_kernel<kFp8, NC, MI>;
  static AllowSmemOnce allow;
  const cudaError_t err = allow(kernel, T::smem());
  if (err != cudaSuccess) return err;
  const int tiles_m = (m + T::BM - 1) / T::BM, tiles_n = (n + kWsBN - 1) / kWsBN;
  kernel<<<grid, T::kThreads, T::smem(), stream>>>(xmap, wmap, sw, out, part, tile_count,
                                                    m, k, n, tiles_m, tiles_n, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the per-token activation quantizer and the s8 TMA + wgmma kernel
// ---------------------------------------------------------------------------
// One block a row: x [M, K] (f32 or bf16) -> codes xq [M, K] int8 and sx [M]
// f32, byte-equal to ops/cuda/quant_matmul.quantize_activations (the JAX
// package's per-token quantizer as XLA compiles it): sx = max(amax |x| *
// f32(1/127), f32(1e-10)), codes clamp(rint(x / sx), -127, 127) with an
// IEEE division (no --use_fast_math) and ties to even. Each thread keeps
// its chunks of 8 values in registers as they were loaded (16 bytes of
// bf16, 32 of f32), so x is read once and a block stays small in
// registers (several blocks an SM at K 12,288).
constexpr int kQuantChunks = 8;  // chunks of 8 values a thread, at most

template <typename T>
__device__ __forceinline__ void unpack8(const uint4 (&raw)[sizeof(T) / 2], float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);  // bf16 -> f32, exact
      v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[4 * h] = __uint_as_float(raw[h].x), v[4 * h + 1] = __uint_as_float(raw[h].y);
      v[4 * h + 2] = __uint_as_float(raw[h].z), v[4 * h + 3] = __uint_as_float(raw[h].w);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(512)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int k) {
  constexpr int W = sizeof(T) / 2;  // 16-byte words a chunk
  __shared__ float warp_amax[32];
  const int row = blockIdx.x, tid = threadIdx.x, chunks = k / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * k);
  uint4 raw[kQuantChunks][W];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantChunks; ++i) {
    const int c = tid + i * blockDim.x;
    if (c >= chunks) continue;
#pragma unroll
    for (int h = 0; h < W; ++h) raw[i][h] = __ldg(xr + W * c + h);
    float v[8];
    unpack8<T>(raw[i], v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  amax = warp_max(amax);
  if (tid % 32 == 0) warp_amax[tid / 32] = amax;
  __syncthreads();
  if (tid < 32) {
    amax = tid < (int)(blockDim.x / 32) ? warp_amax[tid] : 0.f;
    amax = warp_max(amax);
    if (tid == 0) warp_amax[0] = amax;
  }
  __syncthreads();
  const float s = fmaxf(__fmul_rn(warp_amax[0], (float)(1.0 / 127.0)), (float)1e-10);
  if (tid == 0) sx[row] = s;
#pragma unroll
  for (int i = 0; i < kQuantChunks; ++i) {
    const int c = tid + i * blockDim.x;
    if (c >= chunks) continue;
    float v[8];
    unpack8<T>(raw[i], v);
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[j], s)), -127.f), 127.f);
      q[j / 4] |= ((uint32_t)__float2int_rn(r) & 0xFFu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint2*>(xq + (size_t)row * k + 8 * c) = make_uint2(q[0], q[1]);
  }
}

// The GEMM computes the transposed product, out^T [N, M] = W^T . xq^T: the
// weight is wgmma's A (64 weight columns a consumer warpgroup), the tokens
// its N (NT a tile: 16 for a decode step, up to 256). 8-bit wgmma reads
// both operands K-major only, and the weight lies N-major ([K, N] row-major),
// so each consumer thread builds its A fragment from the TMA-landed weight
// stage with ldmatrix.trans and byte permutes (hopper.cuh s8_frag_mn), A
// from registers; xq [M, K] is K-major as it lies and is B straight from
// shared memory.
// A's rows are the weight columns in s8_frag_col's order, so accumulator
// row g + 8 h of warp w is column 16 w + 2 g + h of the warpgroup's 64.
// (Tiles of 256 columns, each weight row read as 256 contiguous bytes,
// measured slower at decode on an H100: PERF.md.)
constexpr int kS8BK = 128;            // k a stage: one 128-byte swizzled row
constexpr int kS8BN = 128;            // weight columns a tile: two warpgroups of 64
constexpr int kS8W = kS8BK * kS8BN;   // weight bytes a stage: one TMA box

// two consumer warpgroups, then a producer warpgroup
template <int NT>
struct S8Tiles {
  static constexpr int kThreads = 128 * 3;
  static constexpr int kX = NT * kS8BK;     // xq tile, bytes
  static constexpr int kStage = kS8W + kX;  // a multiple of 1024
  static constexpr int kRing = 224 * 1024 / kStage;
  static constexpr int kStages = kRing > 8 ? 8 : kRing;
  static constexpr uint32_t kTx = kStage;
  static constexpr size_t smem() {
    return 1024 + (size_t)kStages * kStage + 2 * kStages * sizeof(uint64_t) + 16;
  }
};

// acc[64 x NT] += A (registers) . xq tile, four k32 steps of a stage; NT 256
// is two n128 products on the tile's halves
template <int NT>
__device__ __forceinline__ void s8_stage_rs(int (&acc)[NT / 2], const uint32_t (&a)[4][4],
                                            uint32_t xs) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = gmma_desc(xs + 32 * kk, 16, 1024);
    if constexpr (NT == 16) wgmma_m64n16k32_s8_rs(acc, a[kk], db);
    if constexpr (NT == 64) wgmma_m64n64k32_s8_rs(acc, a[kk], db);
    if constexpr (NT == 128) wgmma_m64n128k32_s8_rs(acc, a[kk], db);
    if constexpr (NT == 256) {
      wgmma_m64n128k32_s8_rs(acc, a[kk], db);
      wgmma_m64n128k32_s8_rs(acc + 64, a[kk], gmma_desc(xs + 128 * kS8BK + 32 * kk, 16, 1024));
    }
  }
}
template <int NT>
__global__ void __launch_bounds__(S8Tiles<NT>::kThreads, 1)
    qmm_s8_kernel(const __grid_constant__ CUtensorMap xmap,  // int8 xq [M, K]
                  const __grid_constant__ CUtensorMap wmap,  // int8 [K, N]
                  const float* __restrict__ sx,              // [M]
                  const float* __restrict__ sw,              // [N]
                  float* __restrict__ out,                   // [M, N]
                  int* __restrict__ part,                    // [splits, M, N] if splits > 1
                  int* __restrict__ tile_count,              // [tiles], zero between launches
                  int m, int k, int n, int tiles_m, int tiles_n, int splits) {
  using namespace hopper;
  using T = S8Tiles<NT>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)S * T::kStage);
  uint64_t* empty = full + S;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + S);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tiles = tiles_m * tiles_n, units = tiles * splits;
  const int kb_all = (k + kS8BK - 1) / kS8BK;
  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;

  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<40>();
    if (tid % 128 == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, tiles_m, tiles, splits, kb_all);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          unsigned char* st = base + (size_t)s * T::kStage;
          mbar_expect_tx(&full[s], T::kTx);
          tma_load_2d(st, &wmap, &full[s], w.tn * kS8BN, kb * kS8BK);
          tma_load_2d(st + kS8W, &xmap, &full[s], kb * kS8BK, w.tm * NT);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: weight columns [64 wg, 64 wg + 64) of each tile
    setmaxnreg_inc<232>();
    const int t = tid % 128, g = lane / 4, q = lane % 4;
    const uint32_t frag = s8_frag_offset(4 * wg + warp, lane);
    int acc[NT / 2];
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, tiles_m, tiles, splits, kb_all);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const unsigned char* st = base + (size_t)s * T::kStage;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) s8_frag_mn(a[kk], st + 4096 * kk + frag, lane);
        fence_regs(acc);
        wgmma_fence();
        s8_stage_rs<NT>(acc, a, smem_u32(st + kS8W));
        wgmma_commit();
        wgmma_wait<0>();  // A's registers and the stage are free again
        fence_regs(acc);
        if (t == 0) mbar_arrive(&empty[s]);
      }

      // epilogue: acc[4 j + 2 h + e] is token 8 j + 2 q + e of the tile,
      // weight column 64 wg + 16 warp + s8_frag_col(g, h); out = (float(acc)
      // * sx[token]) * sw[column], or this split's int32 partial
      const int col = w.tn * kS8BN + 64 * wg + 16 * warp + s8_frag_col(g, 0);
      if (col < n) {  // n % 16 == 0: col + 1 < n as well
        const float s0 = sw[col], s1 = sw[col + 1];
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = w.tm * NT + 8 * j + 2 * q + e;
            if (tok >= m) continue;
            const int v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
            if (splits == 1) {
              const float r = sx[tok];
              *reinterpret_cast<float2*>(out + (size_t)tok * n + col) =
                  make_float2(__fmul_rn(__fmul_rn(__int2float_rn(v0), r), s0),
                              __fmul_rn(__fmul_rn(__int2float_rn(v1), r), s1));
            } else {
              *reinterpret_cast<int2*>(part + ((size_t)w.split * m + tok) * n + col) =
                  make_int2(v0, v1);
            }
          }
      }
      if (splits == 1) continue;
      // the tile's last split to finish sums the int32 partials in split
      // order (exact in any order; this one keeps the launch deterministic
      // in form too), then scales once
      __threadfence();
      named_sync(1, 256);
      if (tid == 0) *last_flag = atomicAdd(&tile_count[w.tile], 1) == splits - 1;
      named_sync(1, 256);
      if (!*last_flag) continue;
      __threadfence();
      const int r_base = w.tm * NT, c_base = w.tn * kS8BN;
      const int rows = min(NT, m - r_base), quads = min(kS8BN, n - c_base) / 4;
      const size_t plane = (size_t)m * n;
      for (int qd = tid; qd < rows * quads; qd += 256) {
        const int tok = r_base + qd / quads, c = c_base + (qd % quads) * 4;
        const int* p = part + (size_t)tok * n + c;
        int4 a = __ldcg(reinterpret_cast<const int4*>(p));
        for (int sp = 1; sp < splits; ++sp) {
          const int4 b = __ldcg(reinterpret_cast<const int4*>(p + sp * plane));
          a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
        }
        const float r = sx[tok];
        *reinterpret_cast<float4*>(out + (size_t)tok * n + c) =
            make_float4(__fmul_rn(__fmul_rn(__int2float_rn(a.x), r), sw[c]),
                        __fmul_rn(__fmul_rn(__int2float_rn(a.y), r), sw[c + 1]),
                        __fmul_rn(__fmul_rn(__int2float_rn(a.z), r), sw[c + 2]),
                        __fmul_rn(__fmul_rn(__int2float_rn(a.w), r), sw[c + 3]));
      }
      if (tid == 0) tile_count[w.tile] = 0;
    }
  }
}

template <int NT>
cudaError_t launch_s8(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* sx,
                      const float* sw, float* out, int* part, int* tile_count, int m, int k,
                      int n, int splits, int grid, cudaStream_t stream) {
  using T = S8Tiles<NT>;
  auto kernel = qmm_s8_kernel<NT>;
  static AllowSmemOnce allow;
  const cudaError_t err = allow(kernel, T::smem());
  if (err != cudaSuccess) return err;
  const int tiles_m = (m + NT - 1) / NT, tiles_n = (n + kS8BN - 1) / kS8BN;
  kernel<<<grid, T::kThreads, T::smem(), stream>>>(xmap, wmap, sx, sw, out, part, tile_count,
                                                    m, k, n, tiles_m, tiles_n, splits);
  return cudaGetLastError();
}

}  // namespace qmm
}  // namespace xllm

// K5's quantizer: x [M, K] (xtype XLLM_DTYPE_F32 or _BF16, 16-byte aligned
// rows: K a multiple of 8) -> xq int8 [M, K], sx f32 [M]; `threads` a row (a
// multiple of 32, at most 512, with K / 8 <= 8 threads).
extern "C" int xllm_quantize_rows(int device, const void* x, void* xq, void* sx, int xtype,
                                  int m, int k, int threads, void* stream) {
  using namespace xllm::qmm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || k <= 0 || k % 8 || threads % 32 || threads < 32 || threads > 512 ||
      k / 8 > kQuantChunks * threads || (reinterpret_cast<uintptr_t>(x) % 16) ||
      (reinterpret_cast<uintptr_t>(xq) % 8) || (xtype != XLLM_DTYPE_F32 && xtype != XLLM_DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (xtype == XLLM_DTYPE_BF16)
    quantize_rows_kernel<<<m, threads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), q, s, k);
  else
    quantize_rows_kernel<<<m, threads, 0, st>>>(static_cast<const float*>(x), q, s, k);
  return (int)cudaGetLastError();
}

// K5: xq int8 [M, K] and its row scales sx [M], w int8 [K, N] with its scales
// sw [N] -> out f32 [M, N]. bt: tokens a tile (16, 64, 128 or 256),
// `splits` ranges of K (part: an int32 [splits, M, N] workspace when
// splits > 1), `grid` persistent blocks; tile_count holds one zero int per
// output tile and is left zero.
extern "C" int xllm_qmm_s8(int device, const void* xq, const void* w, const void* sx,
                           const void* sw, void* out, void* part, void* tile_count, int m,
                           int k, int n, int bt, int splits, int grid, void* stream) {
  using namespace xllm::qmm;
  using xllm::hopper::encode_2d_cached;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kb_all = (k + kS8BK - 1) / kS8BK;
  if (k % 16 || n % 16 || m <= 0 || k <= 0 || splits < 1 || splits > kb_all || grid < 1 ||
      (splits > 1 && (part == nullptr || tile_count == nullptr)) ||
      (reinterpret_cast<uintptr_t>(xq) % 16) || (reinterpret_cast<uintptr_t>(w) % 16))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  err = encode_2d_cached(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, k, bt, kS8BK,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = encode_2d_cached(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n, kS8BK, kS8BN,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const float* r = static_cast<const float*>(sx);
  const float* s = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  int* p = static_cast<int*>(part);
  int* c = static_cast<int*>(tile_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 16: return (int)launch_s8<16>(xmap, wmap, r, s, o, p, c, m, k, n, splits, grid, st);
    case 64: return (int)launch_s8<64>(xmap, wmap, r, s, o, p, c, m, k, n, splits, grid, st);
    case 128: return (int)launch_s8<128>(xmap, wmap, r, s, o, p, c, m, k, n, splits, grid, st);
    case 256: return (int)launch_s8<256>(xmap, wmap, r, s, o, p, c, m, k, n, splits, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K6 (wtype XLLM_DTYPE_E4M3, sw [N]) and K7 (XLLM_DTYPE_BF16, sw null):
// x bf16 [M, K], w [K, N]; bm 64, 128 or 256 rows a tile (one consumer
// warpgroup of 64 rows, two of 64, two of 128), `splits` ranges of K (part: an f32 [splits, M, N]
// workspace when splits > 1), `grid` persistent blocks; tile_count holds
// one zero int per output tile and is left zero. The tensor maps are
// encoded here (a per-thread cache keeps the ones seen before).
extern "C" int xllm_qmm_ws(int device, const void* x, const void* w, const void* sw,
                           void* out, void* part, void* tile_count, int wtype, int m, int k,
                           int n, int bm, int splits, int grid, void* stream) {
  using namespace xllm::qmm;
  using xllm::hopper::encode_2d_cached;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kb_all = (k + kWsBK - 1) / kWsBK;
  const bool fp8 = wtype == XLLM_DTYPE_E4M3;
  if (k % 16 || n % 16 || m <= 0 || (bm != 64 && bm != 128 && bm != 256) || splits < 1 ||
      splits > kb_all || grid < 1 || (splits > 1 && (part == nullptr || tile_count == nullptr)) ||
      (!fp8 && wtype != XLLM_DTYPE_BF16) || (reinterpret_cast<uintptr_t>(x) % 16) ||
      (reinterpret_cast<uintptr_t>(w) % 16))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  err = encode_2d_cached(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, bm, kWsBK,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = fp8 ? encode_2d_cached(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n, kWsBK, kWsBN,
                        CU_TENSOR_MAP_SWIZZLE_NONE)
            : encode_2d_cached(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, n, kWsBK, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const float* s = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(tile_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((fp8 ? 1000 : 0) + bm) {
    case 64: return (int)launch_ws<false, 1, 1>(xmap, wmap, s, o, p, c, m, k, n, splits, grid, st);
    case 128: return (int)launch_ws<false, 2, 1>(xmap, wmap, s, o, p, c, m, k, n, splits, grid, st);
    case 256: return (int)launch_ws<false, 2, 2>(xmap, wmap, s, o, p, c, m, k, n, splits, grid, st);
    case 1064: return (int)launch_ws<true, 1, 1>(xmap, wmap, s, o, p, c, m, k, n, splits, grid, st);
    case 1128: return (int)launch_ws<true, 2, 1>(xmap, wmap, s, o, p, c, m, k, n, splits, grid, st);
    case 1256: return (int)launch_ws<true, 2, 2>(xmap, wmap, s, o, p, c, m, k, n, splits, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}
