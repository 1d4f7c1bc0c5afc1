// K5, K6, K7: matrix products that stream a weight [K, N] (or one layer
// of a stack [L, K, N]) against activations x [M, K] -> f32 out [M, N].
//
// Replaces the nine Pallas functions of xllm_tpu/ops/pallas/quant_matmul.py
// with one kernel shape and three contracts:
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
// DMA four ways and keep K resident in VMEM; here each block owns one
// (BM x BN) output tile, walks K in 3-stage cp.async rings of A and weight
// tiles, and runs mma.sync on the tensor cores:
// - bf16 / e4m3 weights: m16n8k16 bf16 MMAs with f32 accumulators, the
//   layout of K10 (csrc/gmm.cu). e4m3 tiles land as bytes and are converted
//   to bf16 in shared memory before the MMAs read them (half the bytes of
//   bf16 from device memory; x is not cast to fp8, which would change the
//   function).
// - int8: m16n8k32 s8 MMAs with s32 accumulators. The MMA takes B in
//   column-major fragments (4 consecutive k of one column n in a register),
//   the weight is [K, N] row-major and sm_90 has no ldmatrix.trans for
//   8-bit elements, so each stage's [64 x BN] byte tile is transposed in
//   shared memory, 4 x 4 bytes at a time with byte permutes (prmt), into
//   [BN x 64]; both operands' fragments are then plain 32-bit loads.
// Tiles: for decode-sized M, BM 16 x BN 64 (more blocks over N for 132
// SMs) with deep stages (128 bf16 / 256 int8 k a stage: each block keeps
// ~2 x 16 KB of weights in flight, which a latency-bound weight stream
// needs); otherwise BM 128 x BN 128 with 32 / 64 k a stage. The wrapper
// picks. Not yet done: TMA/wgmma, a persistent schedule.
#include "common.cuh"

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
// K6 / K7: bf16 tensor cores; the weight is bf16 or e4m3
// ---------------------------------------------------------------------------
// BK: k per stage (a multiple of 16, one m16n8k16 step each); STAGES: the
// depth of the cp.async ring
template <bool kFp8, int BM, int BN, int BK, int STAGES>
struct Bf16Tiles {
  static constexpr int kAStride = BK + 8;             // bf16 elements of an A row
  static constexpr int kBStride = BN + 8;             // bf16 elements of a B row
  static constexpr int kStageRow = kFp8 ? BN + 16 : kBStride * 2;  // bytes
  static constexpr int kAStage = BM * kAStride;       // elements
  static constexpr int kBStageBytes = BK * kStageRow;
  static constexpr size_t smem() {
    return (size_t)STAGES * kAStage * 2 + (size_t)STAGES * kBStageBytes +
           (kFp8 ? (size_t)BK * kBStride * 2 : 0);
  }
};

// BM x BN output tile, 4 warps as WARPS_M x (4 / WARPS_M); each warp owns a
// (BM / WARPS_M) x (BN / WARPS_N) block of m16n8 accumulators.
template <bool kFp8, int BM, int BN, int WARPS_M, int BK, int STAGES>
__global__ void __launch_bounds__(kThreadsQ)
    qmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                    const unsigned char* __restrict__ w,  // [K, N] bf16 / e4m3
                    const float* __restrict__ sw,         // [N] or null
                    float* __restrict__ out, int m, int k, int n) {
  using T = Bf16Tiles<kFp8, BM, BN, BK, STAGES>;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile");
  constexpr int kWBytes = kFp8 ? 1 : 2;
  constexpr int kRowChunks = BN * kWBytes / 16;  // 16-byte chunks of a B row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* bs = smem_raw + (size_t)STAGES * T::kAStage * 2;
  __nv_bfloat16* bconv =
      reinterpret_cast<__nv_bfloat16*>(bs + (size_t)STAGES * T::kBStageBytes);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int rows = min(BM, m - m0);
  const __nv_bfloat16* a_g = x + (size_t)m0 * k;
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* ad = as + stage * T::kAStage;
    for (int c = tid; c < BM * (BK / 8); c += kThreadsQ) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < k;
      cp_async16(ad + r * T::kAStride + kc, ok ? a_g + (size_t)r * k + k0 + kc : x, ok);
    }
    unsigned char* bd = bs + stage * T::kBStageBytes;
    for (int c = tid; c < BK * kRowChunks; c += kThreadsQ) {
      const int r = c / kRowChunks, cb = (c % kRowChunks) * 16;
      const int col = n0 + cb / kWBytes;
      const bool ok = k0 + r < k && col < n;  // n % 16 == 0: all or nothing
      cp_async16(bd + r * T::kStageRow + cb,
                 ok ? w + ((size_t)(k0 + r) * n + col) * kWBytes : w, ok);
    }
  };
  // e4m3 stage -> bf16 tile [BK, BN] in bconv
  auto convert_stage = [&](int stage) {
    const unsigned char* src = bs + stage * T::kBStageBytes;
    for (int c = tid; c < BK * (BN / 16); c += kThreadsQ) {
      const int r = c / (BN / 16), cb = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * T::kStageRow + cb);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = upcast2<e4m3>(in[i]);  // exact
        o[2 * i + 1] = upcast2<e4m3>(in[i] >> 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(bconv + r * T::kBStride + cb);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
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

  const int kt_n = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();               // ... every thread's; stage kt-1 is free
    const int next = kt + STAGES - 1;
    if (next < kt_n) load_stage(next % STAGES, next * BK);
    cp_async_commit();

    const __nv_bfloat16* at = as + (kt % STAGES) * T::kAStage;
    const __nv_bfloat16* bt;
    if constexpr (kFp8) {
      convert_stage(kt % STAGES);
      __syncthreads();
      bt = bconv;
    } else {
      bt = reinterpret_cast<const __nv_bfloat16*>(bs + (kt % STAGES) * T::kBStageBytes);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], at + (wm * WM + i * 16 + (lane % 16)) * T::kAStride + kk +
                               (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];  // (k 0-7, k 8-15) of n8 block j, then of block j+1
        ldmatrix_x4_trans(bf, bt + (kk + (lane % 16)) * T::kBStride + wn * WN + j * 8 +
                                  (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wm * WM + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + wn * WN + j * 8 + (lane % 4) * 2;
      if (c >= n) continue;  // n % 16 == 0: c + 1 < n as well
      const float s0 = sw ? sw[c] : 1.f, s1 = sw ? sw[c + 1] : 1.f;
      if (r < rows)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + r) * n + c) =
            make_float2(acc[i][j][0] * s0, acc[i][j][1] * s1);
      if (r + 8 < rows)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + r + 8) * n + c) =
            make_float2(acc[i][j][2] * s0, acc[i][j][3] * s1);
    }
  }
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

template <bool kFp8, int BM, int BN, int WARPS_M, int BK, int STAGES>
cudaError_t launch_bf16(const void* x, const void* w, const float* sw, float* out,
                        int m, int k, int n, cudaStream_t stream) {
  auto kernel = qmm_bf16_kernel<kFp8, BM, BN, WARPS_M, BK, STAGES>;
  const size_t smem = Bf16Tiles<kFp8, BM, BN, BK, STAGES>::smem();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreadsQ, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w), sw,
      out, m, k, n);
  return cudaGetLastError();
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

// wtype: the weight's dtype code (XLLM_DTYPE_I8: K5, x is the int8 xq and
// sx its row scales; XLLM_DTYPE_E4M3: K6; XLLM_DTYPE_BF16: K7, sw may be
// null). bm: the row tile, 16 (64 columns, deep stages) or 128 (128
// columns).
extern "C" int xllm_quant_matmul(int device, const void* x, const void* sx,
                                 const void* w, const void* sw, void* out, int wtype,
                                 int m, int k, int n, int bm, void* stream) {
  using namespace xllm::qmm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k % 16 || n % 16 || m <= 0 || (m + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wtype == XLLM_DTYPE_I8) {
    const float* r = static_cast<const float*>(sx);
    if (bm == 16) return (int)launch_int8<16, 64, 1, 256, 3>(x, r, w, s, o, m, k, n, st);
    if (bm == 128) return (int)launch_int8<128, 128, 2, 64, 3>(x, r, w, s, o, m, k, n, st);
  } else if (wtype == XLLM_DTYPE_E4M3) {
    if (bm == 16) return (int)launch_bf16<true, 16, 64, 1, 128, 3>(x, w, s, o, m, k, n, st);
    if (bm == 128) return (int)launch_bf16<true, 128, 128, 2, 32, 3>(x, w, s, o, m, k, n, st);
  } else if (wtype == XLLM_DTYPE_BF16) {
    if (bm == 16) return (int)launch_bf16<false, 16, 64, 1, 128, 3>(x, w, s, o, m, k, n, st);
    if (bm == 128) return (int)launch_bf16<false, 128, 128, 2, 32, 3>(x, w, s, o, m, k, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
