// K5, K6, K7: matrix products that stream a weight [K, N] (or one layer
// of a stack [L, K, N]) against activations x [M, K] -> f32 out [M, N].
//
// Replaces the nine Pallas functions of xllm_tpu/ops/pallas/quant_matmul.py
// with two kernels and three contracts:
//   K5 w8a8 (quant_matmul_int8, _int8_v2, _int8_v2_stacked): x quantized per
//      token outside the kernel (xq int8, sx [M] f32); int8 x int8 products
//      summed exactly in int32; out = (float(acc) * sx[m]) * sw[n];
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
// K6 / K7 (qmm_ws_kernel): one warp-specialised kernel for every M, its
// shape planned by ops/cuda/quant_matmul.plan:
// - a producer warpgroup whose first thread keeps TMA loads in flight into
//   a ring of 4-8 stages (x [BM x 64] K-major and the weight [64 x 128] as
//   it lies, both in the 128-byte swizzle), guarded by full / empty
//   mbarriers;
// - consumer warpgroups run wgmma m64n128k16 bf16 -> f32 from shared
//   memory, B read MN-major through wgmma's transpose bit, one product
//   group kept in flight: BM 64 (one warpgroup; every M up to 64), 128
//   (two of 64 rows) or 256 (two of 128 rows, two products a k16 step);
// - e4m3 weights land as bytes; a converter warpgroup upcasts each stage
//   once into the swizzled bf16 tile the consumers read (integer and bf16
//   operations, exact; NaN bytes through upcast2<e4m3>), while the
//   consumers multiply the stage before;
// - a persistent grid (at most one block an SM) walks work units: output
//   tiles, each split over K into `splits` ranges of whole stages when the
//   plan asks (few tiles). A split unit writes its f32 partial to a
//   workspace; the last unit of a tile to finish (a counter it resets)
//   sums the partials in split order and scales once, so the result does
//   not depend on which block finishes last.
// Rows past M and columns past N are zero-filled by TMA and masked at the
// stores. Registers: with two consumer warpgroups, setmaxnreg moves the
// producer's (and the converter's) registers to the consumers.
//
// K5 (qmm_int8_kernel): m16n8k32 s8 MMAs with s32 accumulators from a
// 3-stage cp.async ring. The MMA takes B in column-major fragments (4
// consecutive k of one column n in a register), the weight is [K, N]
// row-major and sm_90 has no ldmatrix.trans for 8-bit elements, so each
// stage's [64 x BN] byte tile is transposed in shared memory, 4 x 4 bytes at
// a time with byte permutes (prmt), into [BN x 64]; both operands'
// fragments are then plain 32-bit loads. Tiles: BM 16 x BN 64 with 256 k a
// stage for decode-sized M, else BM 128 x BN 128 with 64 k a stage.
#include "common.cuh"
#include "hopper.cuh"

namespace xllm {
namespace qmm {

constexpr int kThreadsQ = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// K6 / K7: TMA + wgmma, warp-specialised, persistent, split over K
// ---------------------------------------------------------------------------
constexpr int kWsBK = 64;    // k a stage: one 128-byte swizzled row of bf16 x
constexpr int kWsBN = 128;   // output columns a tile: two 64-column weight blocks
constexpr int kWsBlockB = kWsBK * 128;  // bytes of one 64-column bf16 block
constexpr int kWsBlockA = 64 * 128;     // bytes of 64 rows of x
constexpr int kConvSteps = kWsBK * kWsBN / 16 / 128;  // 16-byte chunks a converter thread

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

// 4 e4m3 bytes -> 4 bf16 (two bf16x2 words, the low bytes first), exact:
// each byte's exponent and mantissa are shifted into bf16's fields and the
// pair is scaled by 2^120 (bf16's bias 127 less e4m3's 7), exact for every
// finite e4m3 value, subnormals included (bf16 products keep subnormal
// inputs). Integer and bf16x2 operations only, no cvt (the conversion
// unit's quarter rate). NaN bytes (0x7f, 0xff) are left to the caller.
__device__ __forceinline__ void e4m3x4_to_bf16(uint32_t in, uint32_t& lo, uint32_t& hi) {
  const uint32_t x0 = __byte_perm(in, 0, 0x1404);  // b1 << 24 | b0 << 8
  const uint32_t x1 = __byte_perm(in, 0, 0x3424);  // b3 << 24 | b2 << 8
  uint32_t a = ((x0 >> 4) & 0x07F007F0u) | (x0 & 0x80008000u);
  uint32_t b = ((x1 >> 4) & 0x07F007F0u) | (x1 & 0x80008000u);
  const uint32_t k2 = 0x7B807B80u;  // (2^120, 2^120)
  const __nv_bfloat162 ka = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                    *reinterpret_cast<const __nv_bfloat162*>(&k2));
  const __nv_bfloat162 kb = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&b),
                                    *reinterpret_cast<const __nv_bfloat162*>(&k2));
  lo = *reinterpret_cast<const uint32_t*>(&ka);
  hi = *reinterpret_cast<const uint32_t*>(&kb);
}
// nonzero when a byte of the 16 is an e4m3 NaN (low seven bits all set)
__device__ __forceinline__ uint32_t e4m3_nan_bytes(uint4 v) {
  const uint32_t m = 0x7F7F7F7Fu, one = 0x01010101u;
  return (((v.x & m) + one) | ((v.y & m) + one) | ((v.z & m) + one) | ((v.w & m) + one)) &
         0x80808080u;
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
        const unsigned char* raw = st + T::kA + T::kB;
        uint4 v[kConvSteps];
#pragma unroll
        for (int i = 0; i < kConvSteps; ++i) {
          const int q = c + i * 128;
          v[i] = *reinterpret_cast<const uint4*>(raw + (q >> 3) * kWsBN + (q & 7) * 16);
        }
        const bool nan = e4m3_nan_bytes(v[0]) | e4m3_nan_bytes(v[1]) |
                         e4m3_nan_bytes(v[2]) | e4m3_nan_bytes(v[3]);
#pragma unroll
        for (int i = 0; i < kConvSteps; ++i) {
          const int q = c + i * 128, r = q >> 3, cb = (q & 7) * 16;
          uint32_t o[8];
          if (!nan) {
            e4m3x4_to_bf16(v[i].x, o[0], o[1]);
            e4m3x4_to_bf16(v[i].y, o[2], o[3]);
            e4m3x4_to_bf16(v[i].z, o[4], o[5]);
            e4m3x4_to_bf16(v[i].w, o[6], o[7]);
          } else {
            const uint32_t in[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              o[2 * j] = upcast2<e4m3>(in[j]);  // exact, NaN kept
              o[2 * j + 1] = upcast2<e4m3>(in[j] >> 16);
            }
          }
          unsigned char* row = st + T::kA + (cb >> 6) * kWsBlockB + r * 128;
          const int ch = (cb & 63) >> 3;  // first 16-byte chunk of the row
          *reinterpret_cast<uint4*>(row + ((ch ^ (r & 7)) << 4)) =
              make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (r & 7)) << 4)) =
              make_uint4(o[4], o[5], o[6], o[7]);
        }
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
  static bool smem_set[64] = {};  // per device: set the attribute once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = allow_smem(kernel, T::smem());
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  const int tiles_m = (m + T::BM - 1) / T::BM, tiles_n = (n + kWsBN - 1) / kWsBN;
  kernel<<<grid, T::kThreads, T::smem(), stream>>>(xmap, wmap, sw, out, part, tile_count,
                                                    m, k, n, tiles_m, tiles_n, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: int8 tensor cores
// ---------------------------------------------------------------------------
// BK: k bytes per stage (a multiple of 32, one m16n8k32 step each)
template <int BM, int BN, int BK, int STAGES>
struct Int8Tiles {
  static constexpr int kAStride = BK + 16;  // bytes; 16-byte aligned rows
  static constexpr int kWStride = BN + 16;  // bytes of a staged [k][n] row
  static constexpr int kTStride = BK + 16;  // bytes of a transposed [n][k] row
  static constexpr int kAStage = BM * kAStride;
  static constexpr int kWStage = BK * kWStride;
  static constexpr size_t smem() {
    return (size_t)STAGES * (kAStage + kWStage) + (size_t)BN * kTStride;
  }
};

// 4 x 4 byte transpose: r[i] holds bytes (k + i, n .. n + 3); c[j] gets
// bytes (k .. k + 3, n + j)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

template <int BM, int BN, int WARPS_M, int BK, int STAGES>
__global__ void __launch_bounds__(kThreadsQ)
    qmm_int8_kernel(const int8_t* __restrict__ xq,   // [M, K]
                    const float* __restrict__ sx,    // [M]
                    const int8_t* __restrict__ w,    // [K, N]
                    const float* __restrict__ sw,    // [N]
                    float* __restrict__ out, int m, int k, int n) {
  using T = Int8Tiles<BM, BN, BK, STAGES>;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT >= 1, "warp tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* as = smem_raw;
  unsigned char* ws = as + (size_t)STAGES * T::kAStage;
  unsigned char* wt = ws + (size_t)STAGES * T::kWStage;  // [BN][BK]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int rows = min(BM, m - m0);
  const int8_t* a_g = xq + (size_t)m0 * k;
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int k0) {
    unsigned char* ad = as + stage * T::kAStage;
    for (int c = tid; c < BM * (BK / 16); c += kThreadsQ) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const bool ok = r < rows && k0 + kc < k;  // k % 16 == 0
      cp_async16(ad + r * T::kAStride + kc, ok ? a_g + (size_t)r * k + k0 + kc : xq, ok);
    }
    unsigned char* wd = ws + stage * T::kWStage;
    for (int c = tid; c < BK * (BN / 16); c += kThreadsQ) {
      const int r = c / (BN / 16), cb = (c % (BN / 16)) * 16;
      const bool ok = k0 + r < k && n0 + cb < n;  // n % 16 == 0
      cp_async16(wd + r * T::kWStride + cb, ok ? w + (size_t)(k0 + r) * n + n0 + cb : w, ok);
    }
  };
  auto transpose_stage = [&](int stage) {
    const unsigned char* src = ws + stage * T::kWStage;
    for (int c = tid; c < (BK / 4) * (BN / 4); c += kThreadsQ) {
      const int nb = c % (BN / 4), kb = c / (BN / 4);
      uint32_t r[4], t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(src + (4 * kb + i) * T::kWStride + 4 * nb);
      transpose4x4(r, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(wt + (4 * nb + j) * T::kTStride + 4 * kb) = t[j];
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, tq = lane % 4;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int kt_n = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; the last MMAs on wt are done
    const int next = kt + STAGES - 1;
    if (next < kt_n) load_stage(next % STAGES, next * BK);
    cp_async_commit();
    transpose_stage(kt % STAGES);
    __syncthreads();

    const unsigned char* at = as + (kt % STAGES) * T::kAStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // fragments of m16n8k32 (g = lane / 4, tq = lane % 4): a0 (row g,
      // k 4tq..4tq+3), a1 (row g + 8), a2 (row g, k + 16), a3 (row g + 8,
      // k + 16); b0 (k 4tq..4tq+3, col g), b1 (k + 16)
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned char* a0 = at + (wm * WM + i * 16 + g) * T::kAStride + kk + 4 * tq;
        af[i][0] = *reinterpret_cast<const uint32_t*>(a0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(a0 + 8 * T::kAStride);
        af[i][2] = *reinterpret_cast<const uint32_t*>(a0 + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(a0 + 8 * T::kAStride + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* b = wt + (wn * WN + j * 8 + g) * T::kTStride + kk + 4 * tq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // out = (float(acc) * sx[row]) * sw[col], in that order: an exact int32
  // sum, one rounding to f32, two f32 products
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wm * WM + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + wn * WN + j * 8 + tq * 2;
      if (c >= n) continue;
      const float s0 = sw[c], s1 = sw[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= rows) continue;
        const float sr = sx[m0 + rr];
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sr), s0);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sr), s1);
        *reinterpret_cast<float2*>(out + (size_t)(m0 + rr) * n + c) = make_float2(v0, v1);
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int BK, int STAGES>
cudaError_t launch_int8(const void* xq, const float* sx, const void* w, const float* sw,
                        float* out, int m, int k, int n, cudaStream_t stream) {
  auto kernel = qmm_int8_kernel<BM, BN, WARPS_M, BK, STAGES>;
  const size_t smem = Int8Tiles<BM, BN, BK, STAGES>::smem();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreadsQ, smem, stream>>>(static_cast<const int8_t*>(xq), sx,
                                            static_cast<const int8_t*>(w), sw, out, m,
                                            k, n);
  return cudaGetLastError();
}


}  // namespace qmm
}  // namespace xllm

// K5: xq int8 [M, K] and its row scales sx, w int8 [K, N]. bm: the row
// tile, 16 (64 columns, deep stages) or 128 (128 columns).
extern "C" int xllm_quant_matmul(int device, const void* x, const void* sx,
                                 const void* w, const void* sw, void* out, int m, int k,
                                 int n, int bm, void* stream) {
  using namespace xllm::qmm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k % 16 || n % 16 || m <= 0 || (m + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(sw);
  const float* r = static_cast<const float*>(sx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16) return (int)launch_int8<16, 64, 1, 256, 3>(x, r, w, s, o, m, k, n, st);
  if (bm == 128) return (int)launch_int8<128, 128, 2, 64, 3>(x, r, w, s, o, m, k, n, st);
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
