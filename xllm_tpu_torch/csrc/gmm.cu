// K10: grouped GEMM over expert-stacked weights (the MoE expert matmul).
//
// Replaces xllm_tpu/ops/pallas/gmm.py gmm. Contract: lhs [M, K] with rows
// sorted by expert, rhs [E, K, N], group_offsets [E + 1] int32 (expert e
// owns rows [offsets[e], offsets[e + 1]), nondecreasing, within [0, M]);
// out [M, N] f32 with out[r] = lhs[r] @ rhs[expert of r], accumulated in
// f32. Rows outside every group come out as zeros. Any M and N (N and K
// multiples of 8): the caller pads nothing.
//
// What bounds it on the card: bytes. At the served shapes (Qwen3-30B-A3B
// experts, gate_up [128, 2048, 1536], down [128, 768, 2048]) a decode step
// of 16 tokens routes 128 rows to ~82 experts and must read their weights,
// ~0.77 GB a layer, with ~0.1 GFLOP of work; a 2048-token prefill chunk
// (16,384 rows) touches every expert: 155 GFLOP over 1.21 GB, 128 FLOP a
// byte, below the ~295 FLOP/byte at which bf16 tensor cores become the
// limit, so bound by bytes as well.
//
// Design (not the TPU's): the TPU kernel walks a scalar-prefetched step map
// in which an m-tile may straddle two experts, masks its rows and keeps the
// output block resident in VMEM between revisits. Here every block owns
// one (row tile, n tile) pair whose rows all belong to ONE segment: the
// rows before offsets[0], each expert's rows, the rows after offsets[E].
// A row tile starts at its segment's first row, so there is no straddle
// mask and no read-modify-write: each output element is written once, by
// one block, and the result does not depend on scheduling. The tile list
// is built on the device: the launch has the static upper bound
// ceil(M / BM) + E + 2 row-tile slots; warp 0 of each block scans the
// segments' tile counts and finds its own (segment, first row), and a block
// past the last tile exits at once. Nothing is read back to the host, and
// an empty expert costs one scan and no load.
//
// fp8 rhs (e4m3 expert stacks, weight-only; the TPU kernel upcasts the
// rhs tiles to the lhs dtype on load): the B tiles stream through the same
// ring at one byte an element, and each stage is upcast to bf16 (exact for
// e4m3) in shared memory before its products, or to f32 as the f32 lhs
// reads it. The per-(expert, channel) scales stay outside, on the f32
// output rows (ops/moe.py), as in the JAX package. Bound: bytes, with the
// weights at one byte.
//
// bf16: mma.sync m16n8k16 on the tensor cores with f32 accumulators; A and
// B tiles stream through a 3-stage cp.async ring, fragments come from
// ldmatrix (B through .trans: rhs is [K, N] row-major). The row tile BM is
// chosen by the wrapper from the rows per expert: 16 for decode (one MMA
// row block, so few wasted products per streamed weight), 128 for prefill
// (each expert's weights streamed once per 128 rows). f32: plain FMA on the CUDA cores, no TF32, so it matches an f32
// matmul to f32 summation order.
#include "common.cuh"

namespace xllm {
namespace gmm {

constexpr int kThreadsG = 128;
constexpr int kStages = 3;

// Segment s of the rows: 0 = before offsets[0], 1..E = expert s - 1,
// E + 1 = after offsets[E]. Its rows are [bound(s), bound(s + 1)).
__device__ __forceinline__ int bound(const int* offsets, int s, int e, int m) {
  if (s == 0) return 0;
  if (s == e + 2) return m;
  return min(max(offsets[s - 1], 0), m);
}

struct Tile {
  int seg;   // -1: past the last tile (the block exits)
  int row0;  // first row
  int rows;  // rows of this tile (<= BM)
};

// Warp 0 finds the tile of row-tile slot `slot` by an inclusive scan of the
// segments' tile counts, 32 segments at a time; the block reads it from
// shared memory after the barrier.
__device__ Tile find_tile(const int* offsets, int e, int m, int bm, int slot) {
  __shared__ Tile tile;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int nseg = e + 2;
    int before = 0;  // tiles of the segments of earlier chunks
    bool found = false;
    for (int c = 0; c < nseg && !found; c += 32) {
      const int s = c + lane;
      int lo = 0, hi = 0;
      if (s < nseg) {
        lo = bound(offsets, s, e, m);
        hi = bound(offsets, s + 1, e, m);
      }
      const int t = hi > lo ? (hi - lo + bm - 1) / bm : 0;
      int incl = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int start = before + incl - t;
      const bool mine = t > 0 && slot >= start && slot < start + t;
      const unsigned who = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        const int row0 = lo + (slot - start) * bm;
        tile = Tile{s, row0, min(bm, hi - row0)};
      }
      found = who != 0;
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (!found && lane == 0) tile = Tile{-1, 0, 0};
  }
  __syncthreads();
  return tile;
}

__device__ __forceinline__ void zero_rows(float* out, int row0, int rows, int n0,
                                          int bn, int n) {
  for (int i = threadIdx.x; i < rows * (bn / 4); i += blockDim.x) {
    const int r = i / (bn / 4), c = n0 + (i % (bn / 4)) * 4;
    if (c < n)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * n + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kAStride = kBK + 8;  // bf16 elements; rows 80 bytes apart
constexpr int kBStride = kBN + 8;  // rows 272 bytes apart: ldmatrix rows
                                   // of one phase hit distinct banks

constexpr int kB8Stride = kBN + 16;  // bytes of an e4m3 B row in a stage

// R: the rhs element type (bf16, or e4m3 staged as bytes and upcast)
template <int BM, typename R>
constexpr size_t bf16_smem_bytes() {
  if constexpr (sizeof(R) == 1)
    return (size_t)kStages * (BM * kAStride * 2 + kBK * kB8Stride) + kBK * kBStride * 2;
  return (size_t)kStages * (BM * kAStride + kBK * kBStride) * 2;
}

// BM x 128 output tile, 4 warps as WARPS_M x (4 / WARPS_M); each warp owns
// a (BM / WARPS_M) x (128 / WARPS_N) block of m16n8 accumulators.
template <int BM, int WARPS_M, typename R>
__global__ void __launch_bounds__(kThreadsG)
    gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs, const R* __restrict__ rhs,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int m, int k, int n, int e) {
  constexpr bool kFp8 = sizeof(R) == 1;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = kBN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile");
  constexpr int A_STAGE = BM * kAStride, B_STAGE = kBK * kBStride;

  const Tile tile = find_tile(offsets, e, m, BM, blockIdx.x);
  if (tile.seg < 0) return;
  const int n0 = blockIdx.y * kBN;
  if (tile.seg == 0 || tile.seg == e + 1) {  // rows outside every group
    zero_rows(out, tile.row0, tile.rows, n0, kBN, n);
    return;
  }
  const int expert = tile.seg - 1;
  const int rows = tile.rows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // bf16 rhs: kStages B stages; e4m3: kStages byte stages, then one bf16
  // tile that each stage is upcast into
  __nv_bfloat16* bs = as + kStages * A_STAGE;
  uint8_t* b8 = reinterpret_cast<uint8_t*>(bs);
  __nv_bfloat16* bup = reinterpret_cast<__nv_bfloat16*>(b8 + kStages * kBK * kB8Stride);
  const __nv_bfloat16* a_g = lhs + (size_t)tile.row0 * k;
  const R* b_g = rhs + (size_t)expert * k * n;
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* ad = as + stage * A_STAGE;
    for (int c = tid; c < BM * (kBK / 8); c += kThreadsG) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < k;
      cp_async16(ad + r * kAStride + kc, ok ? a_g + (size_t)r * k + k0 + kc : lhs, ok);
    }
    if constexpr (kFp8) {
      uint8_t* bd = b8 + stage * kBK * kB8Stride;
      for (int c = tid; c < kBK * (kBN / 16); c += kThreadsG) {
        const int r = c / (kBN / 16), nc = (c % (kBN / 16)) * 16;
        const bool ok = k0 + r < k && n0 + nc < n;
        cp_async16(bd + r * kB8Stride + nc,
                   ok ? b_g + (size_t)(k0 + r) * n + n0 + nc : rhs, ok);
      }
    } else {
      __nv_bfloat16* bd = bs + stage * B_STAGE;
      for (int c = tid; c < kBK * (kBN / 8); c += kThreadsG) {
        const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
        const bool ok = k0 + r < k && n0 + nc < n;
        cp_async16(bd + r * kBStride + nc,
                   ok ? b_g + (size_t)(k0 + r) * n + n0 + nc : rhs, ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int kt_n = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();               // ... every thread's; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < kt_n) load_stage(next % kStages, next * kBK);
    cp_async_commit();

    const __nv_bfloat16* at = as + (kt % kStages) * A_STAGE;
    const __nv_bfloat16* bt = bs + (kt % kStages) * B_STAGE;
    if constexpr (kFp8) {  // upcast this stage's bytes into the bf16 tile
      const uint8_t* bsrc = b8 + (kt % kStages) * kBK * kB8Stride;
      for (int c = tid; c < kBK * (kBN / 16); c += kThreadsG) {
        const int r = c / (kBN / 16), nc = (c % (kBN / 16)) * 16;
        upcast16<e4m3>(bup + r * kBStride + nc,
                       *reinterpret_cast<const uint4*>(bsrc + r * kB8Stride + nc));
      }
      __syncthreads();
      bt = bup;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        // matrices: rows 0-7 / 8-15 of the m16 block at k 0-7, then at k 8-15
        ldmatrix_x4(af[i], at + (wm * WM + i * 16 + (lane % 16)) * kAStride +
                               kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];  // (k 0-7, k 8-15) of n8 block j, then of block j+1
        ldmatrix_x4_trans(bf, bt + (kk + (lane % 16)) * kBStride + wn * WN +
                                  j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator layout of m16n8: (row lane/4, cols 2*(lane%4) + {0, 1}) and
  // the same cols at row lane/4 + 8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wm * WM + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + wn * WN + j * 8 + (lane % 4) * 2;
      if (c >= n) continue;  // n % 8 == 0: c + 1 < n as well
      if (r < rows)
        *reinterpret_cast<float2*>(out + (size_t)(tile.row0 + r) * n + c) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < rows)
        *reinterpret_cast<float2*>(out + (size_t)(tile.row0 + r + 8) * n + c) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;
constexpr int kFAStride = kFBK + 4;  // floats; 16-byte aligned rows

// four consecutive rhs values as f32: a float4, or four e4m3 bytes upcast
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const e4m3* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  const float2 lo = __half22float2(__half2(
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3)));
  const float2 hi = __half22float2(__half2(
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3)));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 64 x 64 output tile; thread (ty, tx) = (tid / 16, tid % 16) owns rows
// 8 ty .. 8 ty + 7 and cols 4 tx .. 4 tx + 3. R: f32 or e4m3 rhs.
template <typename R>
__global__ void __launch_bounds__(kThreadsG)
    gmm_f32_kernel(const float* __restrict__ lhs, const R* __restrict__ rhs,
                   const int* __restrict__ offsets, float* __restrict__ out,
                   int m, int k, int n, int e) {
  const Tile tile = find_tile(offsets, e, m, kFBM, blockIdx.x);
  if (tile.seg < 0) return;
  const int n0 = blockIdx.y * kFBN;
  if (tile.seg == 0 || tile.seg == e + 1) {
    zero_rows(out, tile.row0, tile.rows, n0, kFBN, n);
    return;
  }
  const int rows = tile.rows;
  __shared__ __align__(16) float as[kStages][kFBM * kFAStride];
  // rhs rows of kFBN elements (bytes or floats), padded by 16 bytes
  constexpr int kRStride = kFBN + 16 / (int)sizeof(R);
  __shared__ __align__(16) R bs[kStages][kFBK * kRStride];
  const float* a_g = lhs + (size_t)tile.row0 * k;
  const R* b_g = rhs + (size_t)(tile.seg - 1) * k * n;
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int k0) {
    for (int c = tid; c < kFBM * (kFBK / 4); c += kThreadsG) {
      const int r = c / (kFBK / 4), kc = (c % (kFBK / 4)) * 4;
      const bool ok = r < rows && k0 + kc < k;
      cp_async16(&as[stage][r * kFAStride + kc],
                 ok ? a_g + (size_t)r * k + k0 + kc : lhs, ok);
    }
    constexpr int kPer16 = 16 / (int)sizeof(R);  // elements per 16 bytes
    for (int c = tid; c < kFBK * (kFBN / kPer16); c += kThreadsG) {
      const int r = c / (kFBN / kPer16), nc = (c % (kFBN / kPer16)) * kPer16;
      const bool ok = k0 + r < k && n0 + nc < n;
      cp_async16(&bs[stage][r * kRStride + nc],
                 ok ? b_g + (size_t)(k0 + r) * n + n0 + nc : rhs, ok);
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int kt_n = (k + kFBK - 1) / kFBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load_stage(s, s * kFBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_n) load_stage(next % kStages, next * kFBK);
    cp_async_commit();
    const float* at = as[kt % kStages];
    const R* bt = bs[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 b = load4(bt + kk * kRStride + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = at[(ty * 8 + i) * kFAStride + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
  }
  cp_async_wait<0>();
  const int c = n0 + tx * 4;
  if (c >= n) return;  // n % 8 == 0: the 4 columns are all in or all out
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r < rows)
      *reinterpret_cast<float4*>(out + (size_t)(tile.row0 + r) * n + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int BM, int WARPS_M, typename R>
cudaError_t launch_bf16(const void* lhs, const void* rhs, const int* offsets,
                        float* out, int m, int k, int n, int e,
                        cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<BM, R>();
  cudaError_t err = allow_smem(gmm_bf16_kernel<BM, WARPS_M, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + BM - 1) / BM + e + 2, (n + kBN - 1) / kBN);
  gmm_bf16_kernel<BM, WARPS_M, R><<<grid, kThreadsG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(lhs), static_cast<const R*>(rhs), offsets, out,
      m, k, n, e);
  return cudaGetLastError();
}

template <typename R>
cudaError_t launch_f32(const void* lhs, const void* rhs, const int* offsets, float* out,
                       int m, int k, int n, int e, cudaStream_t stream) {
  const dim3 grid((m + kFBM - 1) / kFBM + e + 2, (n + kFBN - 1) / kFBN);
  gmm_f32_kernel<R><<<grid, kThreadsG, 0, stream>>>(
      static_cast<const float*>(lhs), static_cast<const R*>(rhs), offsets, out, m, k, n, e);
  return cudaGetLastError();
}

}  // namespace gmm
}  // namespace xllm

// dtype: lhs (bf16 or f32); rtype: rhs (the lhs dtype, or e4m3 with n a
// multiple of 16); bm: the bf16 row tile (16 or 128); the f32 instance
// always uses 64.
extern "C" int xllm_gmm(int device, const void* lhs, const void* rhs,
                        const void* offsets, void* out, int dtype, int rtype, int m,
                        int k, int n, int e, int bm, void* stream) {
  using namespace xllm::gmm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* offs = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rtype == XLLM_DTYPE_E4M3 && n % 16) return (int)cudaErrorInvalidValue;
  if (dtype == XLLM_DTYPE_BF16) {
#define XLLM_ROW_TILES(R)                                                              \
  if (bm == 16) return (int)launch_bf16<16, 1, R>(lhs, rhs, offs, o, m, k, n, e, st);   \
  if (bm == 128) return (int)launch_bf16<128, 2, R>(lhs, rhs, offs, o, m, k, n, e, st);
    if (rtype == XLLM_DTYPE_BF16) { XLLM_ROW_TILES(__nv_bfloat16) }
    if (rtype == XLLM_DTYPE_E4M3) { XLLM_ROW_TILES(xllm::e4m3) }
#undef XLLM_ROW_TILES
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == XLLM_DTYPE_F32) {
    if (rtype == XLLM_DTYPE_F32) return (int)launch_f32<float>(lhs, rhs, offs, o, m, k, n, e, st);
    if (rtype == XLLM_DTYPE_E4M3)
      return (int)launch_f32<xllm::e4m3>(lhs, rhs, offs, o, m, k, n, e, st);
  }
  return (int)cudaErrorInvalidValue;
}
