// K1: fused KV write + paged GQA decode attention.
//
// Replaces xllm_tpu/ops/pallas/decode_attention.py
// paged_decode_attention_write_v9_tpu (same contract: write each
// sequence's new K/V row at slot_mapping into the split cache at
// layer_idx, in place, then attend q over seq_lens tokens through
// block_tables with an f32 softmax and an optional sliding window; a row
// with seq_len 0 writes nothing and outputs zeros).
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
//   dead page is read; the softmax is online (f32 m/l/acc in shared
//   memory); a split publishes (m, l, acc) to a small f32 scratch and the
//   last split of a (sequence, head) to finish merges them (a
//   threadfence reduction on a per-(sequence, head) counter that the
//   merging block re-arms to 0), so one launch does the whole op.
// Not yet done: a cp.async/TMA ring inside a block.
//
// Write, then read: the split that holds position seq_len - 1 first
// stores the new row, then __syncthreads() makes that global store visible
// to the whole block, and its tile walk reads the row back from the cache
// like every other position; no other split reads that position.
// Sequences never share a page that is written (shared prefix pages are
// full and read-only), so no other block touches the row.
//
// Quantized caches (int8 codes or e4m3, 1 byte a value; q, the new rows and
// the output stay bf16 or f32): the tiles are upcast to bf16 on their way
// into shared memory, and two rules of the TPU kernel hold: the new token is
// attended as given, not as stored (the last split starts its softmax at
// m = q.k_new * scale, l = 1, acc = v_new and walks the cached positions
// [.., seq_len - 1) only; it writes the row cast to the cache dtype), and P
// is rounded to bf16 before P.V (l sums the unrounded P).
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

template <typename S, int D>
size_t decode_smem_bytes(int group) {
  return 2 * (size_t)kTile * (D + kPad) * sizeof(S) +
         ((size_t)group * (2 * D + kTile) + 3 * group) * sizeof(float);
}

// T: q / new rows / output; C: the cache (T itself, or int8 / e4m3)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_write_kernel(const T* __restrict__ q,      // [B, Hq, D]
                                  const T* __restrict__ k_new,  // [B, Hkv, D]
                                  const T* __restrict__ v_new,
                                  C* k_cache, C* v_cache,  // [L, NB, Hkv, bs, D]
                                  const int* __restrict__ slot_mapping,  // [B]
                                  const int* __restrict__ block_tables,  // [B, nbmax]
                                  const int* __restrict__ seq_lens,      // [B]
                                  T* __restrict__ out,                   // [B, Hq, D]
                                  float* part,    // [B, Hkv, nsplit, G, 2 + D]
                                  int* counters,  // [B * Hkv], 0 between launches
                                  int layer, int num_blocks, int hkv, int bs,
                                  int nbmax, int group, float scale,
                                  int window, int chunk, int nsplit) {
  using S = typename TileOf<C>::type;
  constexpr bool kQuant = kQuantCache<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ks = reinterpret_cast<S*>(smem);
  S* vs = ks + kTile * (D + kPad);
  float* qs = reinterpret_cast<float*>(vs + kTile * (D + kPad));  // [G, D]
  float* acc = qs + group * D;                                    // [G, D]
  float* ss = acc + group * D;                                    // [G, kTile]
  float* ms = ss + group * kTile;                                 // [G]
  float* ls = ms + group;
  float* alpha_s = ls + group;
  __shared__ int is_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq = hkv * group;
  const int seq_len = seq_lens[b];
  const size_t qrow = ((size_t)b * hq + (size_t)h * group) * D;
  T* o = out + qrow;
  if (seq_len <= 0) {  // padded row: no write, zero output
    if (split == 0)
      for (int i = tid; i < group * D; i += blockDim.x) o[i] = from_float<T>(0.f);
    return;
  }
  // this block's share of the live positions [lo, seq_len): split-th chunk
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int base = (lo / kTile) * kTile;
  const int nsp = (seq_len - base + chunk - 1) / chunk;  // splits with work
  if (split >= nsp) return;
  const int t_begin = base + split * chunk;
  const int t_end = min(t_begin + chunk, seq_len);

  // 1. the split holding the last position writes the new K/V row first
  const bool last = split == nsp - 1;
  const T* kn = k_new + ((size_t)b * hkv + h) * D;
  const T* vn = v_new + ((size_t)b * hkv + h) * D;
  if (last) {
    const int slot = slot_mapping[b];
    const size_t wrow =
        cache_row(layer, num_blocks, hkv, bs, slot / bs, h, slot % bs, D);
    for (int d = tid; d < D; d += blockDim.x) {
      if constexpr (kQuant) {
        k_cache[wrow + d] = to_cache<C>(to_float(kn[d]));
        v_cache[wrow + d] = to_cache<C>(to_float(vn[d]));
      } else {
        k_cache[wrow + d] = kn[d];
        v_cache[wrow + d] = vn[d];
      }
    }
  }
  for (int i = tid; i < group * D; i += blockDim.x) {
    qs[i] = to_float(q[qrow + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    ms[g] = -INFINITY;
    ls[g] = 0.f;
  }
  __syncthreads();  // the new row is visible to the whole block from here
  const int nwarps = blockDim.x / 32;
  if (kQuant && last) {
    // the new token as given: m = q.k_new * scale, l = 1, acc = v_new
    for (int g = warp; g < group; g += nwarps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(qs[g * D + d], to_float(kn[d]), s);
      s = warp_sum(s);
      if (lane == 0) {
        ms[g] = s * scale;
        ls[g] = 1.f;
      }
    }
    for (int i = tid; i < group * D; i += blockDim.x) acc[i] = to_float(vn[i % D]);
    __syncthreads();
  }

  // 2. online-softmax walk over [t_begin, t_end), kTile at a time (on a
  //    quantized cache over the cached positions, below seq_len - 1); every
  //    tile of a split that starts at m = -inf holds a live position, so m
  //    stays finite
  const int* bt = block_tables + (size_t)b * nbmax;
  const int t_walk = kQuant ? min(t_end, seq_len - 1) : t_end;
  for (int t0 = t_begin; t0 < t_walk; t0 += kTile) {
    const int jlo = max(lo - t0, 0);
    const int jhi = min(t_walk - t0, kTile);
    load_tile<C, D>(ks, vs, k_cache, v_cache, bt, layer, num_blocks, hkv, h, bs, t0,
                    jlo, jhi);
    __syncthreads();
    for (int i = tid; i < group * kTile; i += blockDim.x) {
      const int g = i / kTile, j = i % kTile;
      ss[i] = (j >= jlo && j < jhi)
                  ? dot_q_k<S, D>(qs + g * D, ks + j * (D + kPad)) * scale
                  : -INFINITY;
    }
    __syncthreads();
    for (int g = warp; g < group; g += nwarps) {
      float* srow = ss + g * kTile;
      const float a = srow[lane], c = srow[lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float p0 = expf(a - m_new), p1 = expf(c - m_new);
      srow[lane] = kQuant ? round_bf16(p0) : p0;
      srow[lane + 32] = kQuant ? round_bf16(p1) : p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ms[g] = m_new;
        ls[g] = ls[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* p = ss + g * kTile;
      float a = acc[i] * alpha_s[g];
      for (int j = jlo; j < jhi; ++j) a = fmaf(p[j], to_float(vs[j * (D + kPad) + d]), a);
      acc[i] = a;
    }
    __syncthreads();
  }
  if (nsp == 1) {
    for (int i = tid; i < group * D; i += blockDim.x)
      o[i] = from_float<T>(acc[i] / ls[i / D]);
    return;
  }

  // 3. several splits: publish (m, l, acc); the last split to finish
  //    merges them (threadfence-reduction pattern) and re-arms the counter
  float* pb = part + (((size_t)b * hkv + h) * nsplit) * group * (2 + D);
  float* pp = pb + (size_t)split * group * (2 + D);
  for (int i = tid; i < group * D; i += blockDim.x)
    pp[(i / D) * (2 + D) + 2 + i % D] = acc[i];
  for (int g = tid; g < group; g += blockDim.x) {
    pp[g * (2 + D)] = ms[g];
    pp[g * (2 + D) + 1] = ls[g];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[b * hkv + h], 1) == nsp - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < group * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float m = -INFINITY;
    for (int s = 0; s < nsp; ++s)
      m = fmaxf(m, __ldcg(pb + ((size_t)s * group + g) * (2 + D)));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsp; ++s) {
      const float* ps = pb + ((size_t)s * group + g) * (2 + D);
      const float w = expf(__ldcg(ps) - m);
      l = fmaf(__ldcg(ps + 1), w, l);
      a = fmaf(__ldcg(ps + 2 + d), w, a);
    }
    o[i] = from_float<T>(a / l);
  }
  if (tid == 0) counters[b * hkv + h] = 0;
}

template <typename T, typename C, int D>
cudaError_t launch_decode(const void* q, const void* k_new, const void* v_new,
                          void* k_cache, void* v_cache, const int* slot_mapping,
                          const int* block_tables, const int* seq_lens,
                          void* out, float* part, int* counters, int batch,
                          int layer, int num_blocks, int hkv, int bs, int nbmax,
                          int group, float scale, int window, int chunk,
                          int nsplit, cudaStream_t stream) {
  auto kernel = decode_attention_write_kernel<T, C, D>;
  const size_t smem = decode_smem_bytes<typename TileOf<C>::type, D>(group);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(nsplit, hkv, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<C*>(k_cache),
      static_cast<C*>(v_cache), slot_mapping, block_tables, seq_lens,
      static_cast<T*>(out), part, counters, layer, num_blocks, hkv, bs, nbmax,
      group, scale, window, chunk, nsplit);
  return cudaGetLastError();
}

}  // namespace xllm

extern "C" int xllm_decode_attention_write(
    int device, const void* q, const void* k_new, const void* v_new,
    void* k_cache, void* v_cache, const void* slot_mapping,
    const void* block_tables, const void* seq_lens, void* out, void* part,
    void* counters, int dtype, int qtype, int head_dim, int batch, int layer,
    int num_blocks, int hkv, int bs, int nbmax, int group, float scale,
    int window, int chunk, int nsplit, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (chunk <= 0 || chunk % xllm::kTile || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int* sm = static_cast<const int*>(slot_mapping);
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XLLM_LAUNCH(T, C, D)                                                     \
  return (int)xllm::launch_decode<T, C, D>(q, k_new, v_new, k_cache, v_cache, sm, \
                                           bt, sl, out, pt, ct, batch, layer,     \
                                           num_blocks, hkv, bs, nbmax, group,     \
                                           scale, window, chunk, nsplit, s)
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
  return (int)cudaErrorInvalidValue;
}
