#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xllm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (built for an H100: the kernels compile for sm_90a)
and the CUDA toolkit (nvcc). Imports neither jax nor ``xllm_tpu``. Every
phase raises on failure, so a non-zero exit means a phase failed:

1. build: compile ``xllm_tpu_torch/csrc/*.cu`` with nvcc (all sources at
   once) and print the card's name and power limit;
2. kernels: each hand-written kernel of the served paths against its plain
   PyTorch version on the card, at the served shapes, in bf16 and f32:
   K1-K4 at qwen3-1.7B's (Hq 16, Hkv 8, head_dim 128, block_size 64) with
   padded rows, chunks at q_offset > 0 (prefill attention at each chunk
   bucket the engine phase runs: 64, 512 and 2048) and mid-page writes,
   K3 also at Qwen3-30B-A3B's group (Hq 32, Hkv 4); K10 (grouped GEMM) at
   Qwen3-30B-A3B's expert shapes (gate_up and down, for a 16-token decode
   step and a full chunk of each prefill bucket, routed by a random
   router; each bf16-lhs instance at each shape: the TMA + wgmma kernel and
   the 16-row mma.sync one), and with empty experts, one expert holding
   every row, experts of more than 256 rows and rows outside every group
   under every instance (bf16, e4m3 and f32 rhs); K10 also at DeepSeek-V2-Lite's expert shapes (64 experts, top-6,
   gate_up K 2048 / N 2816, down K 1408 / N 2048); K11a-d (latent decode,
   latent batched prefill, the two latent writers) at DeepSeek-V2-Lite's
   shapes (16 heads, Dk 640 of which 576 live, dv 512, block_size 64) with
   padded rows, a 4,096-token context, a new token that opens a page, each
   prefill bucket with a chunk at q_offset > 0 and a write across a page
   boundary, K11a/b also at 20 and 128 heads; K1-K4 again on int8 and fp8
   caches at qwen3-1.7B's shapes (bf16 and f32 queries); K5 (w8a8), K6
   (fp8 weight-only) and K7 (bf16 weight streaming) at Qwen3-8B's
   projection shapes (qkv K 4096 / N 6144, o 4096 / 4096, gate and up 4096 /
   12,288, down 12,288 / 4096) for a 16-token decode step and a 2048-token
   chunk, bf16 and f32 x, through the stacked wrappers; the single-chunk
   kernels of prompt scoring and embeddings, K2b, K4b and K3b at
   qwen3-1.7B's shapes (K3b at S 2048 from q_offset 0 and 2048, 300 tokens
   in the 512 bucket, 52 at q_offset 2048 in the 64 bucket, and with a
   window; also on int8 and fp8 caches) and K11e-g at DeepSeek-V2-Lite's;
   the fp8 instances of the quantized MoE and MLA families: K10 with fp8
   expert stacks at both MoE models' shapes (bf16 and f32 lhs; the MoE block
   with fp8 experts once under the sync debug mode "error") and K11a-g on an
   fp8 latent cache at DeepSeek-V2-Lite's (bf16 and f32 q; the writers cast
   e4m3 edge values); and the P-rounding repairs (faults F1-F4): K1, K3,
   K3b on bf16, int8 and fp8 caches and K11a, K11b, K11e on bf16 and fp8
   latent caches at block_size 16, 32, 64 and 128, with and without a
   window; and K3 / K3b launches that split their context (a chunk deep in
   its prompt in the 64 bucket) at the GQA groups 2, 4 and 8 (Hq 16 / Hkv 8,
   32 / 8, 32 / 4), block_size 16, 64 and 128, on bf16, int8 and fp8 caches,
   with and without a window whose lower edge falls inside a split, each on
   grid inputs against the unsplit plain version and against the split
   model with the kernel's own plan (each launch's split count printed);
   K3 is also timed at Qwen3-8B's group (Hq 32, Hkv 8) at S 2048.
   Then the kernel, the plain version and one PyTorch library call
   (the yardstick, never used by the port) are timed with CUDA events,
   queued behind a device-side sleep so that the device's time is timed
   and not the host's launch rate, rotating over cache layers so that
   reads come from device memory and not from L2. The MoE block runs at a
   decode step's and a 512-token chunk's shape with the CUDA sync debug
   mode set to "error": nothing between its router and its combine reads
   back to the host;
3. engine: ``LLMEngine(device="cuda")`` at the full width of the
   qwen3-1.7B config (28 layers, bf16, random weights from a seed) serves
   two warm-up requests, then 16 greedy requests whose prompts take every
   kernel; the launch counters are zeroed just before those 16 and read
   just after, and also around each model pass, which must launch each
   kernel it uses once per layer. Then the same engine scores prompts of
   2,100 and 300 tokens and embeds prompts of 40 and 700 tokens beside two
   greedy requests, counters zeroed just before and read just after: every
   score or embed pass launches K3b and one of K2b / K4b once per layer and
   no K1-K4;
4. MoE engine: the same at the full width and depth of Qwen3-30B-A3B
   (48 layers, 128 experts, top-8, bf16, ~61 GB of random weights), after
   the dense engine is freed; every MoE model pass also launches K10 twice
   per layer, and it scores one 2,100-token prompt;
5. MLA engine: the same at the full width and depth of DeepSeek-V2-Lite
   (27 layers, MLA + 64 experts, bf16, ~31 GB of random weights); every
   decode pass launches K11a once per layer, every prefill pass K11b and
   one latent writer (K11c or K11d) once per layer and no K1-K4, and both
   K10 twice per MoE layer; its scores and embeds launch K11e and one of
   K11f / K11g once per layer and no K11a-d;
6. quantized engines: Qwen3-8B at full width and depth (36 layers) with
   int8 weights and an int8 KV cache under ``XLLM_QMM_KERNEL=pallas`` (every
   model pass launches K5 five times per layer, 180, and no K6 or K7), then
   with fp8 weights and an fp8 KV cache (K6, 180 a pass); then the
   qwen3-1.7B engine once more under ``XLLM_BF16_MM=pallas`` (every pass of
   at most 256 tokens launches K7 five times per layer, 140); each
   Qwen3-8B engine also scores a 2,100-token prompt (K2b, K3b, K4b on its
   int8 or fp8 cache); then Qwen3-30B-A3B (48 layers, ~31 GB) with fp8
   weights and an fp8 KV cache and DeepSeek-V2-Lite (27 layers, ~17 GB)
   with fp8 weights and an fp8 latent cache, at full width and depth with
   their weights drawn in e4m3, under ``XLLM_QMM_KERNEL=pallas``: every
   pass launches K6 once per ``*_proj_w`` (96 and 162), K10 (fp8 rhs) twice
   per MoE layer and the fp8 attention kernels once per layer; each scores
   a 2,100-token prompt;
7. parity: small f32 qwen3, qwen3-moe, glm4-moe (sigmoid routing with a
   non-zero router bias, a shared expert, a dense first layer and partial
   rope), deepseek_v2 (q_lora_rank 0, YaRN, latent padded from 144 to 256
   lanes), deepseek_v3 (q_lora_rank > 0, sigmoid routing in two groups) and
   glm4_moe_lite (rotate-half rope) models, each from one seed, served on
   the card (kernels) and on the CPU (plain versions), must give identical
   greedy tokens, and the qwen3 and deepseek_v2 models the same scores and
   embeddings within 1e-4; the small qwen3 with int8 weights and an int8 KV
   cache under ``XLLM_QMM_KERNEL=pallas`` (K5 and the int8-cache K1-K4);
   the small qwen3_moe and deepseek_v2 with fp8 weights and an fp8 KV /
   latent cache and deepseek_v2 with int8 weights, all under
   ``XLLM_QMM_KERNEL=pallas`` (K6 / K5, K10's fp8 instance, the fp8 K1-K4
   and K11a-g); then ``AsyncLLMEngine`` on the card, whose concurrent
   generate, embed and score calls must equal the same requests run alone.

8. layouts: the interleaved KV layouts' kernels against their plain
   versions at qwen3-1.7B's shapes, bf16 and f32 q: K8 (v11 decode, the
   two interleaved writers, the interleaved prefill) on bf16, f32, int8 and
   fp8 caches, K9 (v12 decode with row-major tail pages, the two
   row-major writers, the prefill's row-major tail) on bf16, f32 and fp8
   caches, on inputs whose scores are exact in f32 within ``TOL`` at every
   output and caches byte-equal after each call: padded rows, new tokens
   that open or complete a page (K9 then rewrites the page canonical),
   tails after ``nfull % 4 != 0`` full pages, random and block-contiguous
   page tables, chunks at q_offset > 0 in each prefill bucket ending
   mid-page, RMW chunks that complete their first page and cross into the
   next, a window; and at block_size 16, 32, 64 and 128 (K9's RMW writer,
   one launch a call, there on bf16, f32 and fp8 caches with a page
   completed from its first and by its last row). Each is timed (at
   K1-K4's own shapes first) beside its plain version and a yardstick;
9. layout engines: the qwen3-1.7B engine on ``kv_layout="interleaved_rm"``
   (the JAX bench's default), whose every decode pass launches K9's decode
   and every prefill, score and embed pass K8's prefill and one of K9's
   writers once per layer and no K1-K4; Qwen3-8B with int8 weights and an
   int8 KV cache asking for interleaved_rm, which resolves to interleaved
   (K8 once per layer, K5 180 times a pass, no K9); card = CPU greedy
   tokens for qwen3 on interleaved_rm (scores and embeddings within 1e-4)
   and interleaved, qwen3_moe asking for interleaved_rm (resolved to
   interleaved; scores and embeddings too), int8 qwen3 on interleaved and
   fp8-KV qwen3 on
   interleaved_rm, each asserting its resolved layout.
10. grammar: the decode functions ``XLLM_DECODE_KERNEL`` selects, each as
   ``ops/attention.resolve_decode_kernel`` resolves its name: K1b (v5),
   K12a-g (v1, v3, v4, v6, v7, v8c2, v10t2) and the tile instances v9t2,
   v9t3 (K1), v11t2 (K8) and v12t2 (K9) against their plain versions at
   qwen3-1.7B's heads, block_size 16, 32, 64 and 128, bf16 / int8 / fp8
   caches (bf16 q) and f32 / fp8 ones (f32 q), with and without a window
   (v1 takes none), on grid inputs within ``TOL`` at every output, caches
   byte-equal, padded rows zeros, three launches in a row (K9: one, its
   completed pages move); each timed at K1's shapes beside its plain
   version, SDPA and its bound, K1 (v9t4) in the same call. Then the
   backend rules (fault F5): at head_dim 64, and under
   ``XLLM_ATTENTION_BACKEND=ref`` at 128, decode and prefill launch no
   kernel and give JAX's portable function; ``interpret`` raises on a CUDA
   tensor;
11. grammar engines: the qwen3-1.7B engine (full width and depth) serves
   16 greedy requests x 32 tokens under each of v5, v1, v3, v4, v6, v7,
   v8c2, v10t2 and v9t2 (one engine, the variable switched between runs),
   and on an interleaved and an interleaved_rm engine under v11t2 and
   v12t2: every decode pass launches the name's kernel once per layer and
   no other decode kernel (K1 only under v9*); card = CPU greedy tokens on
   the f32 parity qwen3 under each name, and at head_dim 64 (no attention
   kernel launched: fault F5).

``python3 chip_smoke.py --phases kernels`` (a comma list of build, kernels,
qkernels, engines, quant, parity, layouts, layout-engines, grammar,
grammar-engines) runs a subset and prints no result line.

The line before the last is ``{"kernels": [...]}`` (errors, times, bounds
and launch counts); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from xllm_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
)
from xllm_tpu_torch.engine import LLMEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops import attention, attention_ref, moe
from xllm_tpu_torch.ops.cuda import decode_attention as k1
from xllm_tpu_torch.ops.cuda import gmm as k10
from xllm_tpu_torch.ops.cuda import kv_write as k24
from xllm_tpu_torch.ops.cuda import mla_attention as k11
from xllm_tpu_torch.ops.cuda import prefill_attention as k3
from xllm_tpu_torch.ops.cuda import quant_matmul as qmm
from xllm_tpu_torch.ops.kv_cache_ops import write_kv
from xllm_tpu_torch.ops.quant import quantize_fp8, to_e4m3
from xllm_tpu_torch.ops.rope import rope_mscale
from xllm_tpu_torch.runtime.model_runner import ModelRunner
from xllm_tpu_torch.server.async_engine import AsyncLLMEngine
from xllm_tpu_torch.weights import random_param_tree

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# dense bf16 tensor-core FLOP/s, dense int8 tensor-core OP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
# SM clock of an H100 SXM at its highest boost; torch.cuda._sleep counts
# SM cycles, so at a lower clock the sleep only lasts longer
SLEEP_CYCLES_PER_S = 1.98e9

HQ, HKV, D, BS = 16, 8, 128, 64
NB_MAX = 64  # block-table width at max_model_len 4096
LAYERS = 8  # cache layers the timing loops rotate over
# tolerances (atol, rtol), kernel vs plain version on the same card: both
# compute in f32 and round once to the cache dtype, so they differ by the
# f32 summation order (~1e-6) and, in bf16, by at most one bf16 ulp of the
# result, which is at most 2^-7 |x| (8 significand bits)
TOL = {torch.bfloat16: (1e-5, 2.0 ** -7), torch.float32: (1e-4, 0.0)}

# qwen3-1.7B-class config (bench.py:36-49; Qwen3-1.7B's published
# config.json widths)
QWEN3_1P7B = dict(
    model_type="qwen3",
    dtype="bfloat16",
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=6144,
    num_hidden_layers=28,
    num_attention_heads=16,
    num_key_value_heads=8,
    head_dim=128,
    qk_norm=True,
    tie_word_embeddings=True,
    rope_theta=1000000.0,
    max_position_embeddings=4096,
)
# Qwen3-8B (bench.py MODEL_8B; the widths of Qwen/Qwen3-8B's published
# config.json): 36 layers, 32 query / 8 KV heads, intermediate 12,288,
# untied lm_head; served with int8 or fp8 weights (~7.0 GB) beside the
# bf16 embedding and head (~2.5 GB), at full width and depth
QWEN3_8B = dict(
    model_type="qwen3",
    dtype="bfloat16",
    vocab_size=151936,
    hidden_size=4096,
    intermediate_size=12288,
    num_hidden_layers=36,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    qk_norm=True,
    tie_word_embeddings=False,
    rope_theta=1000000.0,
    max_position_embeddings=4096,
)
# Qwen3-30B-A3B (the published config.json of Qwen/Qwen3-30B-A3B): 48
# layers, 32 query / 4 KV heads, 128 experts of width 768, top-8 with
# renormalised weights, untied embeddings; ~61 GB of bf16 weights, so it
# runs at full width and depth on one 80 GB card
QWEN3_30B_A3B = dict(
    model_type="qwen3_moe",
    dtype="bfloat16",
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=6144,
    num_hidden_layers=48,
    num_attention_heads=32,
    num_key_value_heads=4,
    head_dim=128,
    qk_norm=True,
    tie_word_embeddings=False,
    rope_theta=1000000.0,
    max_position_embeddings=40960,
    num_experts=128,
    num_experts_per_tok=8,
    moe_intermediate_size=768,
    norm_topk_prob=True,
)
# DeepSeek-V2-Lite (the published config.json of deepseek-ai/DeepSeek-V2-Lite):
# 27 layers (the first dense), 16 heads, MLA with q_lora_rank 0,
# kv_lora_rank 512 and 64 rope dims (latent rows of 576 lanes, 640 in the
# cache), 64 routed experts of width 1408, top-6 softmax routing without
# renormalisation, 2 shared experts, YaRN (factor 40); ~31.4 GB of bf16
# weights, so it runs at full width and depth on one 80 GB card
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2",
    dtype="bfloat16",
    vocab_size=102400,
    hidden_size=2048,
    intermediate_size=10944,
    num_hidden_layers=27,
    num_attention_heads=16,
    num_key_value_heads=16,
    tie_word_embeddings=False,
    rope_theta=10000.0,
    rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                  "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                  "mscale_all_dim": 0.707},
    max_position_embeddings=163840,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    moe_intermediate_size=1408,
    n_shared_experts=2,
    first_k_dense_replace=1,
    scoring_func="softmax",
    norm_topk_prob=False,
    routed_scaling_factor=1.0,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(fn, iters: int = 40, warmup: int = 3) -> tuple[float, bool]:
    """Time per call of ``fn(i)`` over ``iters`` calls, with CUDA events.

    The calls are queued behind a device-side sleep long enough for the
    host to enqueue them all, so that the events time the device's work
    and not the host's launch rate. -> (ms per call, queued): ``queued`` is
    False when the device had already left the sleep once the host was
    done, which happens when ``fn`` waits on the device (a host sync); the
    time is then the serial time per call, host included."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0  # bounds one call's host time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # four times the calls' serial time, and at least 20 ms: one serial
    # call of a short kernel can undercount a later call's host time
    torch.cuda._sleep(int(min(max(4 * iters * serial_s, 0.02), 0.5) * SLEEP_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, queued


def host_us(fn, iters: int = 100) -> float:
    """Host time per call of ``fn(i)`` in microseconds, the device left to
    catch up after: a wrapper's Python, allocation and launch cost, which
    an eager engine step pays once per layer."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def time_three(kernel, plain, library, plain_iters: int) -> dict:
    """Kernel, plain version and library yardstick, each by ``time_ms``.
    The kernel's wrapper never waits on the device, so its calls must
    queue; a plain version may sync (boolean indexing) and is then timed
    serially, which ``plain_queued`` records."""
    ms, queued = time_ms(kernel)
    assert queued, "a kernel wrapper waited on the device"
    plain_ms, plain_queued = time_ms(plain, iters=plain_iters)
    library_ms, library_queued = time_ms(library)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                plain_queued=plain_queued, library_queued=library_queued)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa(q, k, v, mask, scale):
    """The library yardstick: one PyTorch attention call over [N, H, L, D]
    tensors, K/V with the Hkv heads (GQA; for K11a/b one latent head, K
    all Dk lanes and V the first dv)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Assert |out - ref| <= atol + rtol |ref| elementwise -> max abs err."""
    atol, rtol = TOL[ref.dtype]
    diff = (out.float() - ref.float()).abs()
    excess = (diff - atol - rtol * ref.float().abs()).max().item()
    err = diff.max().item()
    assert excess <= 0, (f"{what}: max abs err {err}, over atol {atol} + rtol "
                         f"{rtol} |ref| by {excess}")
    return err


def tol_text(dtype) -> str:
    atol, rtol = TOL[dtype]
    return f"atol {atol:g} + rtol {rtol:g} |ref|"


def page_tables(rng, lens, nb_total, bs: int = BS):
    """Disjoint random pages for each sequence (block 0 stays the null
    block) -> block_tables [N, NB_MAX] int32."""
    free = rng.permutation(np.arange(1, nb_total)).tolist()
    bt = np.zeros((len(lens), NB_MAX), np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = free.pop()
    return bt


def i32(a, dev):
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


# quantized KV caches: "int8" (codes; the model folds the per-head scales
# outside the kernels) or "fp8_e4m3" (values); None is the model dtype
QUANT_CACHES = ("int8", "fp8_e4m3")
# K1, K3, K3b on a bf16 cache round P to bf16 as on an int8 / fp8 one; on
# random inputs an ulp of a score can flip a rounding, on grid inputs
# (``GRID_TOL``) it cannot
ROUND_TOL = ("bf16, random inputs: |out - ref| <= 1e-5 + 2^-7 (|ref| + sum_j p_j |v_j|) "
             "(P rounded to bf16 on both sides, where an ulp of a score can flip a "
             "rounding); grid inputs: 1e-5 + 2^-7 |ref|; f32: 1e-4")
QUANT_TOL = ("int8 / fp8 cache: |out - ref| <= 1e-5 + 2^-7 (|ref| + sum_j p_j |v_j|) "
             "(both round P to bf16 against the same running maximum, the TPU kernels': "
             "K1 after each tile of 4 pages, K3 / K3b after each page, where an ulp of exp "
             "can still flip a rounding); writers: byte-equal caches")


def kv_tensor(g, dev, shape, dtype, cache):
    """A random cache (or rows bound for one): the model dtype, int8 codes
    in [-127, 127], or e4m3 values of N(0, 4)."""
    if cache is None:
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    if cache == "int8":
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    return to_e4m3(torch.randn(shape, generator=g, device=dev) * 2.0)


def new_rows(g, dev, shape, dtype, cache):
    """New K/V rows as the model hands them to the kernels: int8 codes for
    an int8 cache, else values in the model dtype."""
    if cache == "int8":
        return kv_tensor(g, dev, shape, dtype, cache)
    return (torch.randn(shape, generator=g, device=dev) * (2.0 if cache else 1.0)).to(dtype)


def q_scale(cache) -> float:
    """Queries against int8 codes carry the K scale folded in (the model's
    default s_k, 4 / 127); else unit scale."""
    return 4.0 / 127.0 if cache == "int8" else 1.0


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.element_size() == 1:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return torch.equal(a, b)


# Grid inputs, on which both sides of a check round each P alike: q and K
# on a grid (model-dtype values multiples of 2^-3 in [-3, 3]; int8 codes
# and e4m3 values integers in [-8, 8]) make every score exact in f32
# whatever the order of the dot, and a power-of-two softmax scale keeps it
# exact. A kernel that rounds P against another running maximum than its
# plain version (or keeps it in f32) then shows in outputs off by more than
# one bf16 ulp; the P-rounding checks (faults F1-F4) hold each kernel there
# to ``TOL`` at every output.
GRID_TOL = "grid inputs: bf16 out |out - ref| <= 1e-5 + 2^-7 |ref|; f32 out 1e-4"


def grid_tensor(g, dev, shape, dtype, cache=None, unit: float = 1.0) -> torch.Tensor:
    """q or K on the grid: values of ``dtype``, or int8 codes / e4m3
    values (``cache``) ``unit`` times an integer in [-8, 8]."""
    if cache is None:
        return (torch.randint(-24, 25, shape, generator=g, device=dev) * 0.125).to(dtype)
    x = torch.randint(-8, 9, shape, generator=g, device=dev)
    return x.to(torch.int8) if cache == "int8" else to_e4m3(x.float() * unit)


def grid_values(g, dev, shape, dtype, cache=None) -> torch.Tensor:
    """V beside grid keys, of about unit size: int8 codes in [-2, 2], else
    N(0, 1) in the cache dtype."""
    if cache == "int8":
        return torch.randint(-2, 3, shape, generator=g, device=dev, dtype=torch.int8)
    x = torch.randn(shape, generator=g, device=dev)
    return to_e4m3(x) if cache == "fp8_e4m3" else x.to(dtype)


def grid_scale(cache=None, mla: bool = False) -> float:
    """A power-of-two softmax scale that spreads grid scores by about 2."""
    return 2.0 ** -4 if cache is None and not mla else 2.0 ** -5


def check_quant_close(out, ref, pv, what: str) -> float:
    """Quantized-cache attention against its plain version within
    ``QUANT_TOL``; ``pv`` is sum_j p_j |v_j| -> max abs err."""
    diff = (out.float() - ref.float()).abs()
    lim = 1e-5 + 2.0 ** -7 * (ref.float().abs() + pv)
    excess = (diff - lim).max().item()
    assert excess <= 0, f"{what}: max abs err {diff.max().item()}, over the bound by {excess}"
    return diff.max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------
def check_decode(rng, dev, dtype, timed: bool, cache=None) -> dict:
    """K1 at B=16: 14 live rows over the served context mix, 2 padded;
    ``cache`` int8 / fp8_e4m3 for a quantized cache (q in ``dtype``)."""
    lens = [56, 316, 716, 2116] * 3 + [56, 316] + [0, 0]
    b = len(lens)
    nb = 1 + sum(-(-n // BS) for n in lens) + 8
    bt = page_tables(rng, lens, nb)
    slots = [bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0
             for i, n in enumerate(lens)]
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (LAYERS, nb, HKV, BS, D)
    kc = kv_tensor(g, dev, shape, dtype, cache)
    vc = kv_tensor(g, dev, shape, dtype, cache)
    q = (torch.randn(b, HQ, D, generator=g, device=dev) * q_scale(cache)).to(dtype)
    kn = new_rows(g, dev, (b, HKV, D), dtype, cache)
    vn = new_rows(g, dev, (b, HKV, D), dtype, cache)
    sm, btt, sl = i32(slots, dev), i32(bt, dev), i32(lens, dev)
    scale = D ** -0.5
    layer = 3

    kk, vk = kc.clone(), vc.clone()
    out = k1.paged_decode_attention_write(q, kn, vn, kk, vk, layer, sm, btt, sl, scale)
    kp, vp = kc.clone(), vc.clone()
    ref = k1.paged_decode_attention_write_plain(q, kn, vn, kp, vp, layer, sm, btt, sl, scale)
    sync()
    what = f"K1 {dtype} cache {cache or dtype}"
    if cache is None and dtype == torch.float32:
        err = check_close(out, ref, what)
    else:  # P rounded: sum_j p_j |v_j| from an f32 softmax over the written caches
        pv = k1.paged_decode_attention_write_plain(
            q.float(), kn.float(), vn.float().abs(), kp.float(), vp.float().abs(), layer,
            sm, btt, sl, scale)
        err = check_quant_close(out, ref, pv, what)
    assert same_bytes(kk, kp) and same_bytes(vk, vp), f"{what}: caches differ"
    assert not out[-2:].float().abs().any(), "K1: padded rows must be zeros"
    res = {"max_abs_err": err}
    if cache == "fp8_e4m3":
        # the in-kernel e4m3 cast of a new row gives the JAX package's bytes,
        # NaN beyond 464 included
        big = (torch.randn(b, HKV, D, generator=g, device=dev) * 300).to(dtype)
        kk, kp = kc.clone(), kc.clone()
        k1.paged_decode_attention_write(q, big, big, kk, vk, layer, sm, btt, sl, scale)
        k1.paged_decode_attention_write_plain(q, big, big, kp, vp, layer, sm, btt, sl, scale)
        sync()
        assert same_bytes(kk, kp), f"{what}: e4m3 cast of new rows differs"
    if not timed:
        return res

    q_el, c_el, n_el = q.element_size(), kc.element_size(), kn.element_size()
    ntok = sum(lens)
    nbytes = 2 * b * HQ * D * q_el + 2 * b * HKV * D * (n_el + c_el) + 2 * ntok * HKV * D * c_el
    flops = 4.0 * ntok * HQ * D
    # library yardstick: SDPA over K/V gathered into contiguous tensors (a
    # quantized cache upcast to q's dtype)
    lmax = -(-max(lens) // BS) * BS
    ctx = bt[:, : lmax // BS]
    idx = i32(ctx, dev).long()
    kg = [kc[l][idx].permute(0, 2, 1, 3, 4).reshape(b, HKV, lmax, D).to(dtype)
          for l in range(LAYERS)]
    vg = [vc[l][idx].permute(0, 2, 1, 3, 4).reshape(b, HKV, lmax, D).to(dtype)
          for l in range(LAYERS)]
    mask = (torch.arange(lmax, device=dev)[None, :] < sl[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    res.update(time_three(
        lambda i: k1.paged_decode_attention_write(
            q, kn, vn, kc, vc, i % LAYERS, sm, btt, sl, scale),
        lambda i: k1.paged_decode_attention_write_plain(
            q, kn, vn, kc, vc, i % LAYERS, sm, btt, sl, scale),
        lambda i: sdpa(q4, kg[i % LAYERS], vg[i % LAYERS], mask, scale),
        plain_iters=10,
    ))
    res["shape"] = (f"B={b} (2 padded), seq_lens {sorted(set(lens) - {0})}, "
                    f"Hq {HQ}, Hkv {HKV}, D {D}, bs {BS}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


# K1 variants beside the served shape: (head_dim, Hq, Hkv, block_size,
# block-table width, window); the widths give 1 to 16 context splits
DECODE_VARIANTS = [(128, 16, 8, 64, 64, 100), (64, 8, 2, 16, 40, 37),
                   (128, 32, 4, 64, 128, 0), (128, 16, 8, 64, 64, 4096)]


def check_decode_variants(rng, dev, dtype) -> float:
    """K1 against its plain version with sliding windows, head_dim 64 and
    contexts up to 8,192 tokens, three launches in a row (the split
    counters must re-arm), on grid inputs within ``TOL`` -> the largest
    max-abs error."""
    worst = 0.0
    for d, hq, hkv, bs, nbmax, window in DECODE_VARIANTS:
        lens = rng.integers(0, nbmax * bs + 1, 24)
        lens[:3] = [1, nbmax * bs, 0]
        nb = 1 + sum(-(-int(n) // bs) for n in lens) + 4
        free = rng.permutation(np.arange(1, nb)).tolist()
        bt = np.zeros((len(lens), nbmax), np.int32)
        for i, n in enumerate(lens):
            bt[i, : -(-int(n) // bs)] = [free.pop() for _ in range(-(-int(n) // bs))]
        slots = [bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                 for i, n in enumerate(lens)]
        g = torch.Generator(device=dev).manual_seed(4)
        kc = grid_tensor(g, dev, (2, nb, hkv, bs, d), dtype)
        vc = grid_values(g, dev, (2, nb, hkv, bs, d), dtype)
        q, kn = (grid_tensor(g, dev, (len(lens), h, d), dtype) for h in (hq, hkv))
        vn = grid_values(g, dev, (len(lens), hkv, d), dtype)
        args = (1, i32(slots, dev), i32(bt, dev), i32(lens, dev), grid_scale(), window)
        kk, vk = kc.clone(), vc.clone()
        for _ in range(3):
            out = k1.paged_decode_attention_write(q, kn, vn, kk, vk, *args)
        kp, vp = kc.clone(), vc.clone()
        ref = k1.paged_decode_attention_write_plain(q, kn, vn, kp, vp, *args)
        sync()
        what = f"K1 {dtype} d={d} hq={hq} hkv={hkv} bs={bs} ctx={nbmax * bs} window={window}"
        err = check_close(out, ref, what)
        assert torch.equal(kk, kp) and torch.equal(vk, vp), f"{what}: caches differ"
        worst = max(worst, err)
    return worst


# prefill chunks (q_offset, ntok): two fresh prompts, the second chunk of a
# chunked prompt (q_offset 512 > 0, bucket padding) and a padded row
PREFILL_ROWS = [(0, 300), (0, 512), (512, 188), (0, 0)]
PREFILL_S = 512
# K3 at each chunk bucket the engine phase gives it, S -> rows: the
# compute-bound 2048 bucket (the first chunk of a 2,100-token prompt and a
# 700-token prompt), the 512 rows above, and the 64 bucket with the
# 52-token second chunk at q_offset 2048 over the first chunk's 32 pages.
# The first entry is the one timed into the kernels line.
K3_SHAPES = {
    2048: [(0, 2048), (0, 700), (0, 0)],
    PREFILL_S: PREFILL_ROWS,
    64: [(2048, 52), (0, 40), (0, 0)],
}
# short chunks for the RMW writer: page-aligned, one full page from mid-page,
# one spanning two pages, a padded row
RMW_ROWS = [(2048, 52), (37, 27), (100, 60), (0, 0)]
RMW_S = 64


def _chunk_tables(rng, rows, dev, bs: int = BS):
    lens = [qo + n for qo, n in rows]
    nb = 1 + sum(-(-n // bs) for n in lens) + 8
    bt = page_tables(rng, lens, nb, bs)
    qo = i32([r[0] for r in rows], dev)
    nt = i32([r[1] for r in rows], dev)
    kvl = i32([qo_ + n if n else 0 for qo_, n in rows], dev)
    return nb, i32(bt, dev), qo, nt, kvl


def check_prefill(rng, dev, dtype, timed: bool, cache=None) -> dict:
    """K3 at every bucket of ``K3_SHAPES`` (chunks at q_offset > 0 and
    padded rows) -> the first bucket's result, with every bucket's in
    ``by_shape``."""
    results = [check_prefill_shape(rng, dev, dtype, timed, s, rows, cache=cache)
               for s, rows in K3_SHAPES.items()]
    if timed and cache is None:  # Qwen3-8B's group (Hq 32, Hkv 8) at S 2048
        results.append(check_prefill_shape(rng, dev, dtype, timed, 2048, [(0, 2048)],
                                           hq=32, hkv=8))
    res = dict(results[0])
    res["max_abs_err"] = max(r["max_abs_err"] for r in results)
    if timed:
        res["by_shape"] = results
    return res


def prefill_fns(single: bool):
    """K3 (P chunks) or K3b (one chunk, the same [1, S, ...] tensors seen
    through the single-chunk wrappers): -> (kernel, plain), each called as
    f(q, k_all, v_all, layer, block_tables, q_offsets, kv_lens, scale,
    window) and returning [P, S, Hq, D]."""
    if not single:
        return k3.paged_attention_prefill_batched, k3.paged_attention_prefill_batched_plain

    def one(fn):
        return lambda q, kc, vc, layer, bt, qo, kvl, scale, window=0: fn(
            q[0], kc, vc, layer, bt[0], qo[0], kvl[0], scale, window)[None]

    return one(k3.paged_attention_prefill), one(k3.paged_attention_prefill_plain)


def check_prefill_shape(rng, dev, dtype, timed: bool, s: int, rows,
                        hq: int = HQ, hkv: int = HKV, cache=None, single: bool = False,
                        window: int = 0, grid: bool = False) -> dict:
    """K3 over P chunks, or K3b (``single``) over one chunk of ``rows``;
    ``grid``: on grid inputs, within ``TOL``."""
    p = len(rows)
    assert p == 1 or not single
    kernel, plain = prefill_fns(single)
    nb, btt, qo, _, kvl = _chunk_tables(rng, rows, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    shape = (LAYERS, nb, hkv, BS, D)
    if grid:
        kc = grid_tensor(g, dev, shape, dtype, cache)
        vc = grid_values(g, dev, shape, dtype, cache)
        q = grid_tensor(g, dev, (p, s, hq, D), dtype)
        scale = grid_scale(cache)
    else:
        kc = kv_tensor(g, dev, shape, dtype, cache)
        vc = kv_tensor(g, dev, shape, dtype, cache)
        q = (torch.randn(p, s, hq, D, generator=g, device=dev) * q_scale(cache)).to(dtype)
        scale = D ** -0.5
    out = kernel(q, kc, vc, 5, btt, qo, kvl, scale, window)
    ref = plain(q, kc, vc, 5, btt, qo, kvl, scale, window)
    sync()
    what = (f"{'K3b' if single else 'K3'} {dtype} cache {cache or dtype} S={s} {rows} "
            f"Hq {hq} Hkv {hkv} window {window}")
    if grid or (cache is None and dtype == torch.float32):
        err = check_close(out, ref, what)
    else:  # P rounded to bf16: the bound takes sum_j p_j |v_j|
        pv = k3.paged_attention_prefill_batched_plain(
            q.float(), kc.float(), vc.float().abs(), 5, btt, qo, kvl, scale, window)
        err = check_quant_close(out, ref, pv, what)
        del pv
    for i, (_, n) in enumerate(rows):
        # a padded row and the bucket padding past ntok are zeros
        assert not out[i, n:].float().abs().any(), f"{what}: row {i} past ntok not zero"
    res = {"max_abs_err": err}
    if not timed:
        return res

    q_el, c_el = q.element_size(), kc.element_size()
    ntok = sum(n for _, n in rows)
    kv_rows = sum(qo_ + n for qo_, n in rows if n)
    pairs = sum(sum(min(qo_ + i + 1, window or qo_ + i + 1) for i in range(n))
                for qo_, n in rows)
    nbytes = 2 * ntok * hq * D * q_el + 2 * kv_rows * hkv * D * c_el
    flops = 4.0 * pairs * hq * D
    # library yardstick: one SDPA call over K/V gathered contiguous, with the
    # causal + kv_len mask of each chunk (a quantized cache upcast to q's
    # dtype)
    lmax = max(qo_ + n for qo_, n in rows)
    lmax = -(-lmax // BS) * BS
    idx = btt[:, : lmax // BS].long()
    kg = [kc[l][idx].permute(0, 2, 1, 3, 4).reshape(p, hkv, lmax, D).to(dtype)
          for l in range(LAYERS)]
    vg = [vc[l][idx].permute(0, 2, 1, 3, 4).reshape(p, hkv, lmax, D).to(dtype)
          for l in range(LAYERS)]
    qpos = qo.long()[:, None] + torch.arange(s, device=dev)[None, :]
    kvi = torch.arange(lmax, device=dev)
    mask = (kvi[None, None, :] <= qpos[:, :, None]) & (kvi[None, None, :] < kvl.long()[:, None, None])
    if window:
        mask &= kvi[None, None, :] > qpos[:, :, None] - window
    mask = mask[:, None]
    qt = q.transpose(1, 2)
    res.update(time_three(
        lambda i: kernel(q, kc, vc, i % LAYERS, btt, qo, kvl, scale, window),
        lambda i: plain(q, kc, vc, i % LAYERS, btt, qo, kvl, scale, window),
        lambda i: sdpa(qt, kg[i % LAYERS], vg[i % LAYERS], mask, scale),
        plain_iters=5,
    ))
    res["shape"] = (f"{'one chunk' if single else f'P={p} chunks'} of S={s} (q_offset, "
                    f"ntok) {rows}, Hq {hq}, Hkv {hkv}, D {D}, bs {BS}"
                    + (f", window {window}" if window else ""))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


# K3b / K11e at each chunk bucket a score or embed pass gives them, (S,
# [(q_offset, ntok)]): a 2048-token chunk from q_offset 0 and one from
# 2048, 300 tokens in the 512 bucket, the 52-token tail of a 2,100-token
# prompt at q_offset 2048 in the 64 bucket. The first is timed into the
# kernels line. K3b is also checked with a sliding window (not timed).
SINGLE_SHAPES = [(2048, [(0, 2048)]), (2048, [(2048, 2048)]), (PREFILL_S, [(0, 300)]),
                 (64, [(2048, 52)])]
SINGLE_WINDOW = (PREFILL_S, [(512, 300)], 100)


def check_single_prefill(rng, dev, dtype, timed: bool, cache=None) -> dict:
    """K3b at every bucket of ``SINGLE_SHAPES`` (bucket padding in the 512
    and 64 buckets) and with a window -> the first bucket's result, every
    bucket's in ``by_shape``."""
    results = [check_prefill_shape(rng, dev, dtype, timed, s, rows, cache=cache, single=True)
               for s, rows in SINGLE_SHAPES]
    s, rows, window = SINGLE_WINDOW
    win = check_prefill_shape(rng, dev, dtype, False, s, rows, cache=cache, single=True,
                              window=window)
    res = dict(results[0])
    res["max_abs_err"] = max([win["max_abs_err"]] + [r["max_abs_err"] for r in results])
    if timed:
        res["by_shape"] = results
    return res


# e4m3 casts at its edge (the largest value 448, the tie at 464 that rounds
# to it, and beyond, where JAX's cast gives NaN and torch's saturates),
# written by K2 / K4 into an fp8 cache
E4M3_EDGES = [448.0, 456.0, 464.0, 480.0, 1000.0, float("inf"), 2.0 ** -10, 0.0]


# single-chunk writers, (S, [(q_offset, ntok)]), the first of each timed:
# K2b a full 2048-token chunk, the 700-token embed prompt in the 2048
# bucket, 300 tokens in the 512 bucket; K4b the 52-token tail at q_offset
# 2048, a chunk from mid-page across a page boundary, 40 tokens from 0
SINGLE_WRITES = {False: [(2048, [(0, 2048)]), (2048, [(0, 700)]), (PREFILL_S, [(0, 300)])],
                 True: [(RMW_S, [(2048, 52)]), (RMW_S, [(100, 60)]), (RMW_S, [(0, 40)])]}


def writer_fns(rmw: bool, single: bool):
    """-> (kernel, plain) of K2 / K4 (P chunks) or K2b / K4b (one chunk,
    the same P = 1 tensors seen through the single-chunk wrappers), each
    called as f(kn, vn, k_all, v_all, layer, block_tables, q_offsets,
    ntoks) with the source in the kernel's own layout."""
    if not single:
        fn = k24.kv_write_rmw_batched if rmw else k24.kv_write_prefill_batched

        def plain(kn, vn, k_all, v_all, layer, btt, qo, nt):
            kr, vr = (kn, vn) if rmw else (kn.transpose(1, 2), vn.transpose(1, 2))
            k24.kv_write_rows_plain(kr, vr, k_all, v_all, layer, btt, qo, nt)

        return fn, plain

    def one(fn):
        return lambda kn, vn, k_all, v_all, layer, btt, qo, nt: fn(
            kn[0], vn[0], k_all, v_all, layer, btt[0], qo[0], nt[0])

    if rmw:
        return one(k24.kv_write_rmw), one(k24.kv_write_rmw_plain)
    return one(k24.kv_write_prefill), one(k24.kv_write_prefill_plain)


def check_single_writer(rng, dev, dtype, timed: bool, rmw: bool, cache=None) -> dict:
    """K2b or K4b at every chunk of ``SINGLE_WRITES`` -> the first's
    result (timed), each checked byte for byte."""
    shapes = SINGLE_WRITES[rmw]
    res = check_writer(rng, dev, dtype, timed, rmw, cache, rows=shapes[0][1],
                       s=shapes[0][0], single=True)
    for s, rows in shapes[1:]:
        check_writer(rng, dev, dtype, False, rmw, cache, rows=rows, s=s, single=True)
    return res


def check_writer(rng, dev, dtype, timed: bool, rmw: bool, cache=None, rows=None,
                 s: int = 0, single: bool = False) -> dict:
    """K2 (head-major, page-aligned, S=512) or K4 (token-major, S=64,
    mid-page starts), or with ``single`` K2b / K4b over the one chunk of
    ``rows``; into a quantized cache from int8 codes or from ``dtype`` rows
    that the kernel casts to e4m3 (``E4M3_EDGES`` among them)."""
    if rows is None:
        rows, s = (RMW_ROWS, RMW_S) if rmw else (PREFILL_ROWS, PREFILL_S)
    p = len(rows)
    nb, btt, qo, nt, _ = _chunk_tables(rng, rows, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (LAYERS, nb, HKV, BS, D)
    kc = kv_tensor(g, dev, shape, dtype, cache)
    vc = kv_tensor(g, dev, shape, dtype, cache)
    src_shape = (p, s, HKV, D) if rmw else (p, HKV, s, D)
    kn = new_rows(g, dev, src_shape, dtype, cache)
    vn = new_rows(g, dev, src_shape, dtype, cache)
    if cache == "fp8_e4m3":  # the kernel's cast where torch's own differs
        kn[0, 0, 0, :len(E4M3_EDGES)] = torch.tensor(E4M3_EDGES, dtype=dtype, device=dev)
        vn[0, 0, 0, :len(E4M3_EDGES)] = -torch.tensor(E4M3_EDGES, dtype=dtype, device=dev)
    fn, plain_fn = writer_fns(rmw, single)

    def plain(k_all, v_all, layer):
        plain_fn(kn, vn, k_all, v_all, layer, btt, qo, nt)

    kk, vk = kc.clone(), vc.clone()
    fn(kn, vn, kk, vk, 2, btt, qo, nt)
    kp, vp = kc.clone(), vc.clone()
    plain(kp, vp, 2)
    sync()
    name = (f"{'K4' if rmw else 'K2'}{'b' if single else ''} {dtype} cache {cache or dtype} "
            f"S={s} {rows}")
    assert same_bytes(kk, kp) and same_bytes(vk, vp), f"{name}: caches differ"
    assert not same_bytes(kk, kc), f"{name}: nothing was written"
    res = {"max_abs_err": 0.0}  # the bytes are equal (an fp8 cache holds NaN)
    if not timed:
        return res

    ntok = sum(n for _, n in rows)
    # K and V rows read once (as given), written once (in the cache dtype)
    nbytes = 2 * ntok * HKV * D * (kn.element_size() + kc.element_size())
    # library yardstick: one advanced-index row assignment per cache with
    # the row indices computed beforehand
    pos = [(i, qo_ + j) for i, (qo_, n) in enumerate(rows) for j in range(n)]
    bt_np = btt.cpu().numpy()
    blk = i32([bt_np[i, ps // BS] for i, ps in pos], dev).long()
    off = i32([ps % BS for _, ps in pos], dev).long()
    sel = [(i, j) for i, (_, n) in enumerate(rows) for j in range(n)]
    src_k = kn if rmw else kn.transpose(1, 2)
    src_v = vn if rmw else vn.transpose(1, 2)
    # (a quantized cache takes the rows' bytes, cast beforehand: the
    # yardstick's time leaves out the e4m3 cast that the kernel does)
    rk = torch.stack([src_k[i, j] for i, j in sel])  # [N, Hkv, D]
    rv = torch.stack([src_v[i, j] for i, j in sel])
    lk, lv = kc, vc
    if cache is not None:
        rk, rv = (to_e4m3(r) if cache == "fp8_e4m3" else r for r in (rk, rv))
        lk, lv, rk, rv = (t.view(torch.uint8) for t in (kc, vc, rk, rv))

    def library(i):
        lk[i % LAYERS, blk, :, off, :] = rk
        lv[i % LAYERS, blk, :, off, :] = rv

    res.update(time_three(
        lambda i: fn(kn, vn, kc, vc, i % LAYERS, btt, qo, nt),
        lambda i: plain(kc, vc, i % LAYERS),
        library,
        plain_iters=40,
    ))
    res["shape"] = (f"{'one chunk' if single else f'P={p} chunks'} of S={s} (q_offset, "
                    f"ntok) {rows}, {'token' if rmw else 'head'}-major, Hkv {HKV}, D {D}, "
                    f"bs {BS}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0)
    return res


# K10 at each served MoE model's expert shapes: (K, N) of each grouped GEMM,
# the experts and the top-k; the tokens of a decode step (batch 16) and of a
# full chunk of each prefill bucket the engine runs; each token brings top-k
# rows
GMM_MODELS = {
    "Qwen3-30B-A3B": dict(experts=128, topk=8,
                          weights={"gate_up": (2048, 2 * 768), "down": (768, 2048)}),
    "DeepSeek-V2-Lite": dict(experts=64, topk=6,
                             weights={"gate_up": (2048, 2 * 1408), "down": (1408, 2048)}),
}
E_MOE, TOPK = QWEN3_30B_A3B["num_experts"], QWEN3_30B_A3B["num_experts_per_tok"]
GMM_WEIGHTS = GMM_MODELS["Qwen3-30B-A3B"]["weights"]
GMM_TOKENS = {"decode": 16, "prefill64": 64, "prefill512": 512, "prefill2048": 2048}
GMM_TOL = "|out - ref| <= K 2^-24 (|lhs| @ |rhs_e|) + 1e-6"


def check_gmm_close(out, lhs, rhs, offsets, what: str) -> float:
    """K10 against its plain version, elementwise within K 2^-24 (|lhs| @
    |rhs_e|) + 1e-6: both accumulate exact products in f32, in different
    orders, so each of the K additions may round by 2^-24 of the running
    magnitude -> max abs err."""
    ref = k10.gmm_plain(lhs, rhs, offsets)
    lim = k10.gmm_plain(lhs.float().abs(), rhs.float().abs(), offsets)
    lim = lim * (lhs.shape[1] * 2.0 ** -24) + 1e-6
    diff = (out - ref).abs()
    worst = (diff / lim).max().item()
    assert worst <= 1.0, f"{what}: max abs err {diff.max().item()}, {worst:.3g} x the bound"
    return diff.max().item()


def moe_weights(dev, g, spec: dict) -> dict:
    """Random bf16 expert stacks and router of one MoE layer of ``spec``."""
    e, (k_in, n_gu), (k_dn, n_dn) = (spec["experts"], spec["weights"]["gate_up"],
                                     spec["weights"]["down"])
    return {
        "gate_up": (torch.randn(e, k_in, n_gu, generator=g, device=dev) * 0.02).bfloat16(),
        "down": (torch.randn(e, k_dn, n_dn, generator=g, device=dev) * 0.02).bfloat16(),
        "router": (torch.randn(k_in, e, generator=g, device=dev) * 0.02).bfloat16(),
    }


# the builds ``k10.plan`` picks for a bf16 lhs (each forced at every shape)
GMM_BF16_INSTANCES = ("ws256", "ws128", "mma16")


def gmm_instances(dev, lhs, rhs, offs, what: str) -> tuple[dict, float]:
    """K10 under each bf16-lhs build forced (``k10.layout``), whichever the
    wrapper would pick at this shape: each held to the plain version and
    timed -> ({build: ms}, worst error)."""
    m, e, n = lhs.shape[0], rhs.shape[0], rhs.shape[2]
    sms = _build.device_sms(dev)
    plans = [k10.layout("mma16", m, n, e)]
    if rhs.shape[1] % 64 == 0:
        plans += [k10.layout("ws", m, n, e, sms, bm=bm) for bm in k10.WS_ROWS]
    times, worst = {}, 0.0
    for p in plans:
        worst = max(worst, check_gmm_close(k10.gmm(lhs, rhs, offs, p), lhs, rhs, offs,
                                           f"{what} instance {p.name}"))
        ms, queued = time_ms(lambda i: k10.gmm(lhs, rhs, offs, p))
        assert queued, "a kernel wrapper waited on the device"
        times[p.name] = ms
    return times, worst


def check_gmm(dev, g, model: str) -> tuple[list[dict], float]:
    """K10 at ``model``'s served shapes (decode and each prefill bucket x
    gate_up / down): rows of random tokens sorted by the experts a random
    router picks for them, as the MoE block sorts them; bf16 (timed, with
    every row tile as well) and f32 (the same values) against the plain
    version -> (one result per shape, worst f32 error)."""
    spec = GMM_MODELS[model]
    e, topk, weights = spec["experts"], spec["topk"], spec["weights"]
    w = moe_weights(dev, g, spec)
    results = []
    worst_f32 = 0.0
    for phase, tokens in GMM_TOKENS.items():
        x = torch.randn(tokens, weights["gate_up"][0], generator=g, device=dev).bfloat16()
        _, topi = moe.route(x, w["router"], topk, True)
        order, offs = moe.group_by_expert(topi, e)
        m = order.numel()
        lhs_of = {"gate_up": x[order // topk],
                  "down": torch.randn(m, weights["down"][0], generator=g,
                                      device=dev).bfloat16()}
        touched = int((offs[1:] > offs[:-1]).sum())
        for name, (k, n) in weights.items():
            lhs, rhs = lhs_of[name], w[name]
            what = f"K10 {model} {phase} {name} M={m} K={k} N={n}"
            err = check_gmm_close(k10.gmm(lhs, rhs, offs), lhs, rhs, offs, what)
            lhs32, rhs32 = lhs.float(), rhs.float()
            worst_f32 = max(worst_f32, check_gmm_close(
                k10.gmm(lhs32, rhs32, offs), lhs32, rhs32, offs, what + " f32"))
            del rhs32
            # yardstick: PyTorch's grouped GEMM (its output is bf16)
            res = {"max_abs_err": err}
            res.update(time_three(
                lambda i: k10.gmm(lhs, rhs, offs),
                lambda i: k10.gmm_plain(lhs, rhs, offs),
                lambda i: torch._grouped_mm(lhs, rhs, offs=offs[1:]),
                plain_iters=5,
            ))
            res["instance"] = k10.plan(m, k, n, e, lhs.dtype, rhs.dtype,
                                       _build.device_sms(dev)).name
            res["ms_by_instance"], err = gmm_instances(dev, lhs, rhs, offs, what)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["shape"] = (f"{model} {phase}: {tokens} tokens x top-{topk} -> M={m} rows "
                            f"over {touched} of {e} experts, K {k}, N {n}, bf16, "
                            f"instance {res['instance']}")
            nbytes = m * k * 2 + touched * k * n * 2 + m * n * 4
            res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2.0 * m * k * n)
            results.append(res)
    # the bf16-rhs builds the wrapper can pick each run at a served shape
    assert {r["instance"] for r in results} == {"ws256", "mma16"}, results
    return results, worst_f32


def check_gmm_fp8(dev, g, model: str) -> list[dict]:
    """K10 with fp8 expert stacks (float8_e4m3fn, quantized per (expert,
    channel) as the model stores them) at ``model``'s served shapes: bf16
    lhs timed, f32 lhs checked, both against the plain version. Yardstick:
    the weights upcast to bf16, then ``torch._grouped_mm`` (one upcast and
    one grouped GEMM). Bound: the bytes with the weights at one byte."""
    spec = GMM_MODELS[model]
    e, topk, weights = spec["experts"], spec["topk"], spec["weights"]
    w = moe_weights(dev, g, spec)
    w8 = {name: quantize_fp8(w[name])[0] for name in weights}
    del w["gate_up"], w["down"]
    results = []
    for phase, tokens in GMM_TOKENS.items():
        x = torch.randn(tokens, weights["gate_up"][0], generator=g, device=dev).bfloat16()
        _, topi = moe.route(x, w["router"], topk, True)
        order, offs = moe.group_by_expert(topi, e)
        m = order.numel()
        lhs_of = {"gate_up": x[order // topk],
                  "down": torch.randn(m, weights["down"][0], generator=g,
                                      device=dev).bfloat16()}
        touched = int((offs[1:] > offs[:-1]).sum())
        for name, (k, n) in weights.items():
            lhs, rhs = lhs_of[name], w8[name]
            what = f"K10 fp8 rhs {model} {phase} {name} M={m} K={k} N={n}"
            res = {"max_abs_err": check_gmm_close(k10.gmm(lhs, rhs, offs), lhs, rhs, offs,
                                                  what),
                   "max_abs_err_f32": check_gmm_close(k10.gmm(lhs.float(), rhs, offs),
                                                      lhs.float(), rhs, offs, what + " f32")}
            res.update(time_three(
                lambda i: k10.gmm(lhs, rhs, offs),
                lambda i: k10.gmm_plain(lhs, rhs, offs),
                lambda i: torch._grouped_mm(lhs, rhs.to(torch.bfloat16), offs=offs[1:]),
                plain_iters=5,
            ))
            res["library"] = "rhs.to(bfloat16) + torch._grouped_mm"
            res["instance"] = k10.plan(m, k, n, e, lhs.dtype, rhs.dtype,
                                       _build.device_sms(dev)).name
            res["ms_by_instance"], err = gmm_instances(dev, lhs, rhs, offs, what)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["shape"] = (f"{model} {phase}: {tokens} tokens x top-{topk} -> M={m} rows "
                            f"over {touched} of {e} experts, K {k}, N {n}, bf16 lhs, fp8 "
                            f"rhs, instance {res['instance']}")
            nbytes = m * k * 2 + touched * k * n + m * n * 4
            res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2.0 * m * k * n)
            results.append(res)
    # ... and the e4m3-rhs ones (128-row tiles at the 512-token chunks)
    assert {r["instance"] for r in results} == set(GMM_BF16_INSTANCES), results
    return results


def check_moe_fp8_no_host_sync(dev, g) -> None:
    """The MoE block with fp8 expert stacks and their scales at a decode
    step's shape under the CUDA sync debug mode "error"."""
    w = moe_weights(dev, g, GMM_MODELS["Qwen3-30B-A3B"])
    (gu, gus), (dn, dns) = quantize_fp8(w["gate_up"]), quantize_fp8(w["down"])
    del w["gate_up"], w["down"]
    x = torch.randn(16, GMM_WEIGHTS["gate_up"][0], generator=g, device=dev).bfloat16()
    kw = dict(gate_up_scale=gus, down_scale=dns)
    moe.moe_mlp(x, w["router"], gu, dn, TOPK, True, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.moe_mlp(x, w["router"], gu, dn, TOPK, True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())


def check_gmm_edges(dev, w: dict, g) -> float:
    """K10 with empty experts, one expert holding every row, experts of
    more than 256 rows (two tiles of the TMA + wgmma instance), and rows
    outside every group at both ends (they come out as zeros), M 1000 (no
    multiple of any row tile); bf16 lhs under each bf16 instance with bf16
    and e4m3 rhs, f32 lhs (the FMA instance) with f32 and e4m3 rhs -> the
    largest max-abs error."""
    m = 1000
    lhs = torch.randn(m, GMM_WEIGHTS["gate_up"][0], generator=g, device=dev).bfloat16()
    one = [0] * 6 + [m] * (E_MOE - 5)  # expert 5 owns every row
    gaps = [3] + [3 + 7 * i for i in range(1, E_MOE)] + [m - 5]
    big = [0] * 3 + [300, 300, 301, 600] + [600 + 3 * i for i in range(1, E_MOE - 6)] + [m]
    rh8 = quantize_fp8(w["gate_up"])[0]
    worst = 0.0
    for offs in (one, gaps, big):
        assert len(offs) == E_MOE + 1 and offs == sorted(offs), offs
        offs = i32(offs, dev)
        lo, hi = int(offs[0]), int(offs[-1])
        for lh, rh in ((lhs, w["gate_up"]), (lhs, rh8), (lhs.float(), w["gate_up"].float()),
                       (lhs.float(), rh8)):
            if lh.dtype == torch.float32:
                out = k10.gmm(lh, rh, offs)
                worst = max(worst, check_gmm_close(out, lh, rh, offs, f"K10 edges f32 {rh.dtype}"))
                assert not out[:lo].any() and not out[hi:].any(), "K10: rows outside not zero"
                continue
            sms = _build.device_sms(dev)
            for p in [k10.layout("mma16", m, rh.shape[2], E_MOE)] + [
                    k10.layout("ws", m, rh.shape[2], E_MOE, sms, bm=bm) for bm in k10.WS_ROWS]:
                out = k10.gmm(lh, rh, offs, p)
                worst = max(worst, check_gmm_close(out, lh, rh, offs,
                                                   f"K10 edges {p.name} {rh.dtype}"))
                assert not out[:lo].any() and not out[hi:].any(), "K10: rows outside not zero"
    return worst


def check_moe_no_host_sync(dev, w: dict, g) -> None:
    """One MoE block at a decode step's shape and at a 512-token chunk's
    (K10's mma.sync and TMA + wgmma instances) with the CUDA sync debug
    mode set to "error": any read back to the host between the router and
    the combine raises."""
    rw, gu, dn = w["router"], w["gate_up"], w["down"]
    for tokens in (16, 512):
        x = torch.randn(tokens, GMM_WEIGHTS["gate_up"][0], generator=g, device=dev).bfloat16()
        moe.moe_mlp(x, rw, gu, dn, TOPK, True)  # first calls (cuBLAS set-up)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = moe.moe_mlp(x, rw, gu, dn, TOPK, True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())


# K11a-d at DeepSeek-V2-Lite's latent shapes: 16 heads, rows of 576 live
# lanes padded with zeros to 640, values the first 512 lanes
MLA_H, MLA_DK, MLA_DV = 16, 640, 512
MLA_DK_LIVE = 576
MLA_SCALE = (128 + 64) ** -0.5 * rope_mscale(DEEPSEEK_V2_LITE["rope_scaling"]) ** 2
# decode contexts: the engine phase's mix (prompts of 40 / 300 / 700 /
# 2,100 tokens after 32 new ones), a full context of NB_MAX pages (4,096
# tokens), a new token that opens a fresh page (577 = 9 pages + 1), and two
# padded rows
MLA_DECODE_LENS = [72, 332, 732, 2132] * 3 + [NB_MAX * BS, 577, 0, 0]
MLA_TOL = ("bf16: |out - ref| <= 1e-5 + 2^-7 |ref| + 2^-7 sum_j p_j |v_j| (each side "
           "rounds P to bf16, off by up to 2^-8 of each p_j |v_j|, and its output once, "
           "off by up to 2^-8 |x|); f32: 1e-4; writers: byte-equal caches")


def latent_rand(g, dev, dtype, *shape, cache=None) -> torch.Tensor:
    """Random latent rows or queries whose pad lanes (576:640) are zeros,
    as the model pads them; ``cache`` fp8_e4m3: e4m3 values of N(0, 4)."""
    x = torch.randn(*shape, generator=g, device=dev)
    x[..., MLA_DK_LIVE:] = 0
    return to_e4m3(x * 2.0) if cache == "fp8_e4m3" else x.to(dtype)


def pv_abs(q3, lat, limits, scale) -> torch.Tensor:
    """sum_j p_j |v_j| with the f32 softmax of the plain version:
    q3 [N, R, Dk], lat [N, KV, Dk], limits [N, R] -> [N, R, dv]."""
    scores = torch.einsum("nrd,nkd->nrk", q3.float(), lat.float()) * scale
    kv_idx = torch.arange(lat.shape[1], device=lat.device)
    mask = kv_idx[None, None, :] < limits[..., None]
    probs = torch.nan_to_num(torch.softmax(scores.masked_fill(~mask, float("-inf")), -1))
    del scores
    return torch.einsum("nrk,nkd->nrd", probs, lat[..., :MLA_DV].float().abs())


def check_mla_close(out, ref, pv, what: str, rounds: bool = False) -> float:
    """K11a/b against the plain version within ``MLA_TOL`` -> max abs err;
    ``rounds``: an f32 q against an fp8 cache, whose P is rounded to bf16,
    takes the bf16 bound."""
    diff = (out.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16 or rounds:
        lim = 1e-5 + 2.0 ** -7 * (ref.float().abs() + pv)
    else:
        lim = torch.full_like(diff, TOL[torch.float32][0])
    excess = (diff - lim).max().item()
    assert excess <= 0, f"{what}: max abs err {diff.max().item()}, over the bound by {excess}"
    return diff.max().item()


def sdpa_backend(call) -> str:
    """The first SDPA backend, in PyTorch's priority order, that takes
    ``call`` (the one its dispatcher picks)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                call()
            return b.name
        except RuntimeError:
            continue
    return "none"


def check_mla_decode(rng, dev, dtype, timed: bool, h: int = MLA_H, cache=None) -> dict:
    """K11a at B=16 over ``MLA_DECODE_LENS``: the written caches byte-equal,
    padded rows zeros; ``cache`` fp8_e4m3 for an fp8 latent cache (q in
    ``dtype``)."""
    lens = MLA_DECODE_LENS
    b = len(lens)
    nb = 1 + sum(-(-n // BS) for n in lens) + 8
    bt = page_tables(rng, lens, nb)
    slots = [bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0 for i, n in enumerate(lens)]
    g = torch.Generator(device=dev).manual_seed(11)
    kind = cache
    cache = latent_rand(g, dev, dtype, LAYERS, nb, 1, BS, MLA_DK, cache=kind)
    q = latent_rand(g, dev, dtype, b, h, MLA_DK)
    lat_new = latent_rand(g, dev, dtype, b, MLA_DK)
    sm, btt, sl = i32(slots, dev), i32(bt, dev), i32(lens, dev)
    layer = 3
    ck = cache.clone()
    out = k11.mla_decode_attention_write(q, lat_new, ck, layer, sm, btt, sl, MLA_SCALE, MLA_DV)
    cp = cache.clone()
    ref = k11.mla_decode_attention_write_plain(q, lat_new, cp, layer, sm, btt, sl,
                                               MLA_SCALE, MLA_DV)
    sync()
    what = f"K11a {dtype} H {h} cache {kind or dtype}"
    assert same_bytes(ck, cp), f"{what}: caches differ"
    pv = pv_abs(q, k11._gather_latent(cp, layer, btt), sl.long()[:, None].expand(-1, h),
                MLA_SCALE)
    res = {"max_abs_err": check_mla_close(out, ref, pv, what, rounds=kind is not None)}
    assert not out[-2:].float().abs().any(), f"{what}: padded rows must be zeros"
    if not timed:
        return res
    el, qel = cache.element_size(), q.element_size()
    ntok = sum(lens)
    live = sum(1 for n in lens if n)
    # q, the new rows and the output in q's dtype; the new rows written and
    # the context read in the cache's
    nbytes = ((b * h * MLA_DK + live * MLA_DK + b * h * MLA_DV) * qel
              + (live * MLA_DK + ntok * MLA_DK) * el)
    flops = 2.0 * ntok * h * (MLA_DK_LIVE + MLA_DV)
    lmax = -(-max(lens) // BS) * BS
    idx = btt[:, : lmax // BS].long()
    # the yardstick's pages gathered (an fp8 cache upcast to q's dtype)
    kg = [cache[l][idx].reshape(b, 1, lmax, MLA_DK).to(dtype) for l in range(LAYERS)]
    vg = [k[..., :MLA_DV].contiguous() for k in kg]
    mask = (torch.arange(lmax, device=dev)[None, :] < sl[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    res.update(time_three(
        lambda i: k11.mla_decode_attention_write(q, lat_new, cache, i % LAYERS, sm, btt, sl,
                                                 MLA_SCALE, MLA_DV),
        lambda i: k11.mla_decode_attention_write_plain(q, lat_new, cache, i % LAYERS, sm,
                                                       btt, sl, MLA_SCALE, MLA_DV),
        lambda i: sdpa(q4, kg[i % LAYERS], vg[i % LAYERS], mask, MLA_SCALE),
        plain_iters=10,
    ))
    res["library"] = "SDPA " + sdpa_backend(lambda: sdpa(q4, kg[0], vg[0], mask, MLA_SCALE))
    res["shape"] = (f"B={b} (2 padded), seq_lens {sorted(set(lens) - {0})}, H {h}, "
                    f"Dk {MLA_DK} ({MLA_DK_LIVE} live), dv {MLA_DV}, bs {BS}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


def mla_prefill_fns(single: bool):
    """-> (kernel, plain) of K11b (P chunks) or K11e (one chunk, the same
    P = 1 tensors seen through the single-chunk wrappers), each called as
    f(q, cache, layer, block_tables, q_offsets, kv_lens, scale, dv)."""
    if not single:
        return k11.mla_prefill_attention_batched, k11.mla_prefill_attention_batched_plain

    def one(fn):
        return lambda q, cache, layer, bt, qo, kvl, scale, dv: fn(
            q[0], cache, layer, bt[0], qo[0], kvl[0], scale, dv)[None]

    return one(k11.mla_prefill_attention), one(k11.mla_prefill_attention_plain)


def check_mla_prefill_shape(rng, dev, dtype, timed: bool, s: int, rows,
                            h: int = MLA_H, trim: bool = False, single: bool = False,
                            cache=None) -> dict:
    """K11b over one bucket's chunks (K11e with ``single``): rows past ntok
    and padded rows zeros. ``trim``: block tables only as wide as the
    chunks need (the plain version's scores then fit at H 128); ``cache``
    fp8_e4m3 for an fp8 latent cache."""
    p = len(rows)
    kernel, plain = mla_prefill_fns(single)
    nb, btt, qo, _, kvl = _chunk_tables(rng, rows, dev)
    if trim:
        btt = btt[:, : -(-max(a + n for a, n in rows) // BS)].contiguous()
    g = torch.Generator(device=dev).manual_seed(12)
    kind = cache
    cache = latent_rand(g, dev, dtype, LAYERS, nb, 1, BS, MLA_DK, cache=kind)
    q = latent_rand(g, dev, dtype, p, s, h, MLA_DK)
    out = kernel(q, cache, 5, btt, qo, kvl, MLA_SCALE, MLA_DV)
    ref = plain(q, cache, 5, btt, qo, kvl, MLA_SCALE, MLA_DV)
    sync()
    what = f"{'K11e' if single else 'K11b'} {dtype} cache {kind or dtype} S={s} {rows} H {h}"
    limits = k11.prefill_row_limits(s, h, qo, kvl)
    pv = pv_abs(q.reshape(p, s * h, MLA_DK), k11._gather_latent(cache, 5, btt), limits,
                MLA_SCALE).reshape(out.shape)
    res = {"max_abs_err": check_mla_close(out, ref, pv, what, rounds=kind is not None)}
    del pv, ref
    for i, (_, n) in enumerate(rows):
        assert not out[i, n:].float().abs().any(), f"{what}: row {i} past ntok not zero"
    if not timed:
        return res
    el, qel = cache.element_size(), q.element_size()
    ntok = sum(n for _, n in rows)
    kv_rows = sum(a + n for a, n in rows if n)
    pairs = sum(sum(a + i + 1 for i in range(n)) for a, n in rows)
    nbytes = (ntok * h * MLA_DK + ntok * h * MLA_DV) * qel + kv_rows * MLA_DK * el
    flops = 2.0 * pairs * h * (MLA_DK_LIVE + MLA_DV)
    lmax = -(-max(a + n for a, n in rows) // BS) * BS
    idx = btt[:, : lmax // BS].long()
    kg = [cache[l][idx].reshape(p, 1, lmax, MLA_DK).to(dtype) for l in range(LAYERS)]
    vg = [k[..., :MLA_DV].contiguous() for k in kg]
    qpos = qo.long()[:, None] + torch.arange(s, device=dev)[None, :]
    kvi = torch.arange(lmax, device=dev)
    mask = ((kvi[None, None, :] <= qpos[:, :, None])
            & (kvi[None, None, :] < kvl.long()[:, None, None]))[:, None]
    qt = q.transpose(1, 2)
    res.update(time_three(
        lambda i: kernel(q, cache, i % LAYERS, btt, qo, kvl, MLA_SCALE, MLA_DV),
        lambda i: plain(q, cache, i % LAYERS, btt, qo, kvl, MLA_SCALE, MLA_DV),
        lambda i: sdpa(qt, kg[i % LAYERS], vg[i % LAYERS], mask, MLA_SCALE),
        plain_iters=3,
    ))
    res["library"] = "SDPA " + sdpa_backend(lambda: sdpa(qt, kg[0], vg[0], mask, MLA_SCALE))
    res["shape"] = (f"{'one chunk' if single else f'P={p} chunks'} of S={s} (q_offset, "
                    f"ntok) {rows}, H {h}, Dk {MLA_DK} ({MLA_DK_LIVE} live), dv {MLA_DV}, "
                    f"bs {BS}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


def check_mla_prefill(rng, dev, dtype, timed: bool, cache=None) -> dict:
    """K11b at every chunk bucket of ``K3_SHAPES`` -> the 2048 bucket's
    result, with every bucket's in ``by_shape``."""
    results = [check_mla_prefill_shape(rng, dev, dtype, timed, s, rows, cache=cache)
               for s, rows in K3_SHAPES.items()]
    res = dict(results[0])
    res["max_abs_err"] = max(r["max_abs_err"] for r in results)
    if timed:
        res["by_shape"] = results
    return res


def check_mla_single_prefill(rng, dev, dtype, timed: bool, cache=None) -> dict:
    """K11e at every bucket of ``SINGLE_SHAPES`` -> the first's result,
    every bucket's in ``by_shape``."""
    results = [check_mla_prefill_shape(rng, dev, dtype, timed, s, rows, single=True,
                                       cache=cache)
               for s, rows in SINGLE_SHAPES]
    res = dict(results[0])
    res["max_abs_err"] = max(r["max_abs_err"] for r in results)
    if timed:
        res["by_shape"] = results
    return res


def latent_writer_fns(rmw: bool, single: bool):
    """-> (kernel, plain) of K11c / K11d (P chunks) or K11f / K11g (one
    chunk of the same P = 1 tensors), each called as f(src, cache, layer,
    block_tables, q_offsets, ntoks)."""
    if not single:
        fn = k24.latent_write_rmw_batched if rmw else k24.latent_write_prefill_batched
        return fn, k24.latent_write_rows_plain

    def one(fn):
        return lambda src, cache, layer, bt, qo, nt: fn(src[0], cache, layer, bt[0], qo[0],
                                                        nt[0])

    if rmw:
        return one(k24.latent_write_rmw), one(k24.latent_write_rmw_plain)
    return one(k24.latent_write_prefill), one(k24.latent_write_prefill_plain)


def check_single_latent_writer(rng, dev, dtype, timed: bool, rmw: bool, cache=None) -> dict:
    """K11f or K11g at every chunk of ``SINGLE_WRITES`` -> the first's
    result (timed), each checked byte for byte."""
    shapes = SINGLE_WRITES[rmw]
    res = check_latent_writer(rng, dev, dtype, timed, rmw, rows=shapes[0][1],
                              s=shapes[0][0], single=True, cache=cache)
    for s, rows in shapes[1:]:
        check_latent_writer(rng, dev, dtype, False, rmw, rows=rows, s=s, single=True,
                            cache=cache)
    return res


def check_latent_writer(rng, dev, dtype, timed: bool, rmw: bool, rows=None, s: int = 0,
                        single: bool = False, cache=None) -> dict:
    """K11c (S=512, page-aligned chunks) or K11d (S=64: mid-page starts, a
    chunk across a page boundary), or with ``single`` K11f / K11g over the
    one chunk of ``rows``: caches byte-equal to the plain version's;
    ``cache`` fp8_e4m3: ``dtype`` rows cast to e4m3 by the kernel
    (``E4M3_EDGES`` among them)."""
    if rows is None:
        rows, s = (RMW_ROWS, RMW_S) if rmw else (PREFILL_ROWS, PREFILL_S)
    p = len(rows)
    nb, btt, qo, nt, _ = _chunk_tables(rng, rows, dev)
    g = torch.Generator(device=dev).manual_seed(13)
    kind = cache
    cache = latent_rand(g, dev, dtype, LAYERS, nb, 1, BS, MLA_DK, cache=kind)
    src = latent_rand(g, dev, dtype, p, s, MLA_DK) * (100.0 if kind else 1.0)
    if kind == "fp8_e4m3":  # the kernel's cast where torch's own differs
        src[0, 0, :len(E4M3_EDGES)] = torch.tensor(E4M3_EDGES, dtype=dtype, device=dev)
    fn, plain = latent_writer_fns(rmw, single)
    ck, cp = cache.clone(), cache.clone()
    fn(src, ck, 2, btt, qo, nt)
    plain(src, cp, 2, btt, qo, nt)
    sync()
    name = ("K11g" if single else "K11d") if rmw else ("K11f" if single else "K11c")
    assert same_bytes(ck, cp), f"{name} {dtype} cache {kind or dtype}: caches differ"
    assert not same_bytes(ck, cache), f"{name}: nothing was written"
    res = {"max_abs_err": 0.0}  # the bytes are equal (an fp8 cache holds NaN)
    if not timed:
        return res
    ntok = sum(n for _, n in rows)
    # each row read once (as given), written once (in the cache dtype)
    nbytes = ntok * MLA_DK * (src.element_size() + cache.element_size())
    pos = [(i, a + j) for i, (a, n) in enumerate(rows) for j in range(n)]
    bt_np = btt.cpu().numpy()
    blk = i32([bt_np[i, ps // BS] for i, ps in pos], dev).long()
    off = i32([ps % BS for _, ps in pos], dev).long()
    sel = torch.stack([src[i, j] for i, (_, n) in enumerate(rows) for j in range(n)])
    lc = cache
    if kind == "fp8_e4m3":  # the rows' bytes cast beforehand (the cast left out)
        lc, sel = cache.view(torch.uint8), to_e4m3(sel).view(torch.uint8)

    def library(i):
        lc[i % LAYERS, blk, 0, off, :] = sel

    res.update(time_three(
        lambda i: fn(src, cache, i % LAYERS, btt, qo, nt),
        lambda i: plain(src, cache, i % LAYERS, btt, qo, nt),
        library,
        plain_iters=40,
    ))
    res["library"] = "index assign"
    res["shape"] = (f"{'one chunk' if single else f'P={p} chunks'} of S={s} (q_offset, "
                    f"ntok) {rows}, Dk {MLA_DK}, bs {BS}, {dtype} rows, cache "
                    f"{kind or dtype}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0)
    return res


def check_mla_heads(rng, dev, dtype) -> float:
    """K11a and K11b at GLM-4.7-Flash's 20 heads (every chunk bucket) and
    DeepSeek-V3's 128 (the 64 and 512 buckets, with block tables only as
    wide as the chunks, so that the plain version fits) -> worst error."""
    worst = 0.0
    for h in (20, 128):
        worst = max(worst, check_mla_decode(rng, dev, dtype, False, h=h)["max_abs_err"])
        for s, rows in K3_SHAPES.items():
            if h == 128 and s == 2048:
                continue
            worst = max(worst, check_mla_prefill_shape(rng, dev, dtype, False, s, rows,
                                                       h=h, trim=True)["max_abs_err"])
            free_device_memory()
    return worst


# K5-K7 at Qwen3-8B's projections (name, K, N), each timed at a decode
# step's 16 rows and a full 2048-token chunk; the weights are stacks of
# QMM_LAYERS layers (int8: 100-200 MB, more than the 50 MB L2) that the
# timing loops rotate over, through the stacked wrappers (the unstacked
# ones are held equal to them)
QMM_SHAPES = [("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 12288),
              ("down", 12288, 4096)]
QMM_ROWS = (16, 2048)
# also checked, untimed, at row counts that leave a row tile part-filled
# (16-row tiles at 5 and 24, 128-row tiles at 52, 64 and 192: prefill passes
# of the 64-token bucket hold 64 P rows)
QMM_EDGE_ROWS = (5, 24, 52, 64, 192)
# K7's own path, the qwen3-1.7B engine under XLLM_BF16_MM=pallas (qkv, o,
# gate and up, down): timed at a decode step and at the 256 rows of its
# largest pass, checked at the row counts of its other prefill passes
QMM_SHAPES_1P7B = [("qkv", 2048, 4096), ("o", 2048, 2048), ("gate_up", 2048, 6144),
                   ("down", 6144, 2048)]
QMM_ROWS_1P7B = (16, 64, 256)
QMM_EDGE_ROWS_1P7B = (52, 64, 128, 192)
# K6's own path, Qwen3-8B fp8 under XLLM_QMM_KERNEL=pallas, runs every pass
# size: a decode step, the 64, 512 and 2048 buckets
QMM_ROWS_FP8 = (16, 64, 512, 2048)
# K6 / K7 launches under forced plans (M, K, N, row tile, splits): part-filled
# row and column tiles, a last stage shorter than 64, 1-5 splits
QMM_SPLITS = [(5, 320, 144, 64, 2), (52, 320, 144, 64, 5), (64, 1024, 256, 64, 3),
              (130, 512, 384, 128, 2), (200, 4096, 128, 128, 5), (300, 384, 256, 256, 1),
              (600, 2048, 512, 256, 3), (16, 4096, 4096, 64, 4), (256, 6144, 2048, 128, 4)]
QMM_LAYERS = 4
QMM_TOL = ("K5: bit-equal to its plain version; K6, K7: |out - ref| <= K 2^-24 "
           "(|x| @ |w|) |s| + 1e-6 (exact products, f32 sums in another order)")
# kind -> (kernel name, stacked wrapper, unstacked wrapper, plain version)
QMM_KINDS = {
    "int8": (qmm.W8A8_NAME, qmm.quant_matmul_int8_stacked, qmm.quant_matmul_int8,
             qmm.quant_matmul_int8_plain),
    "fp8_e4m3": (qmm.FP8_NAME, qmm.quant_matmul_fp8_stacked, qmm.quant_matmul_fp8,
                 qmm.quant_matmul_fp8_plain),
    "bf16": (qmm.BF16_NAME, lambda x, w, s, li: qmm.matmul_bf16_stacked(x, w, li),
             lambda x, w, s: qmm.matmul_bf16(x, w),
             lambda x, w, s: qmm.matmul_bf16_plain(x, w)),
}
# kind -> [(model, shapes, timed rows, checked rows)]
QMM_MODELS = {
    "int8": [("Qwen3-8B", QMM_SHAPES, QMM_ROWS, QMM_EDGE_ROWS)],
    "fp8_e4m3": [("Qwen3-8B", QMM_SHAPES, QMM_ROWS_FP8, QMM_EDGE_ROWS)],
    "bf16": [("Qwen3-8B", QMM_SHAPES, QMM_ROWS, QMM_EDGE_ROWS),
             ("qwen3-1.7B", QMM_SHAPES_1P7B, QMM_ROWS_1P7B, QMM_EDGE_ROWS_1P7B)],
}


def qmm_weights(g, dev, kind, k, n):
    """A random weight stack [QMM_LAYERS, K, N] and its scales [.., N]."""
    shape = (QMM_LAYERS, k, n)
    spread = torch.rand(QMM_LAYERS, n, generator=g, device=dev) + 0.5
    if kind == "int8":
        w = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        return w, spread * (0.02 / 127.0)
    if kind == "fp8_e4m3":
        w = to_e4m3(torch.randn(shape, generator=g, device=dev) * 64.0)
        return w, spread * (0.02 / 64.0)
    return (torch.randn(shape, generator=g, device=dev) * 0.02).bfloat16(), None


def check_qmm_close(out, ref, x, w, s, exact: bool, what: str) -> float:
    """K5 bit-equal; K6 / K7 within ``QMM_TOL`` -> max abs err."""
    if exact:
        assert torch.equal(out, ref), f"{what}: not bit-equal, max abs err {max_err(out, ref)}"
        return 0.0
    lim = torch.mm(x.to(torch.bfloat16).float().abs(), w.float().abs())
    if s is not None:
        lim = lim * s.abs()
    lim = lim * (w.shape[0] * 2.0 ** -24) + 1e-6
    diff = (out - ref).abs()
    worst = (diff / lim).max().item()
    assert worst <= 1.0, f"{what}: max abs err {diff.max().item()}, {worst:.3g} x the bound"
    return diff.max().item()


def int_mm_yardstick(x, w, s):
    """K5's library yardstick: the same activation quantization, then
    ``torch._int_mm`` and the scaling. Where its shape rules refuse the rows
    (M <= 16), the quantized activations get zero rows up to 32 and the
    product's first M rows are kept. -> (call, description)."""
    m = x.shape[0]

    def call(i, pad=0):
        xq, sx = qmm.quantize_activations(x)
        if pad:
            xq = torch.cat([xq, xq.new_zeros(pad, xq.shape[1])])
        y = torch._int_mm(xq, w[i % QMM_LAYERS])[:m]
        return (y.float() * sx) * s[i % QMM_LAYERS]

    try:
        call(0)
        sync()
        return call, "torch._int_mm + scaling"
    except RuntimeError:
        pad = 32 - m
        call(0, pad)
        sync()
        return (lambda i: call(i, pad)), f"torch._int_mm + scaling, x padded from {m} to 32 rows"


def check_qmm_shape(g, dev, kind, model, proj, k, n, rows, edge_rows):
    """One kind of K5-K7 at one projection of ``model``: checked at
    ``rows`` and ``edge_rows`` with bf16 x, at ``rows`` also with f32 x and
    timed -> (timed results, worst f32-x error, worst edge-row error)."""
    name, stacked, unstacked, plain = QMM_KINDS[kind]
    exact = kind == "int8"
    w, s = qmm_weights(g, dev, kind, k, n)

    def scale(li):
        return None if s is None else s[li]

    timed, worst_f32, worst_edge = [], 0.0, 0.0
    for m in edge_rows:
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        what = f"{name} {model} {proj} M={m} K={k} N={n}"
        worst_edge = max(worst_edge, check_qmm_close(
            stacked(x, w, s, 3), plain(x, w[3], scale(3)), x, w[3], scale(3), exact, what))
    for m in rows:
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        what = f"{name} {model} {proj} M={m} K={k} N={n}"
        out = stacked(x, w, s, 1)
        ref = plain(x, w[1], scale(1))
        sync()
        err = check_qmm_close(out, ref, x, w[1], scale(1), exact, what)
        assert torch.equal(unstacked(x, w[1], scale(1)), out), f"{what}: stacked != unstacked"
        x32 = x.float() + torch.randn(m, k, generator=g, device=dev) * 1e-3
        worst_f32 = max(worst_f32, check_qmm_close(
            stacked(x32, w, s, 2), plain(x32, w[2], scale(2)),
            x32, w[2], scale(2), exact, what + " f32 x"))
        if kind == "int8":
            library, lib_name = int_mm_yardstick(x, w, s)
        elif kind == "fp8_e4m3":
            def library(i):  # the port's default: dequantize, one product
                wl = w[i % QMM_LAYERS].to(torch.bfloat16) * s[i % QMM_LAYERS].bfloat16()
                return torch.mm(x, wl, out_dtype=torch.float32)
            lib_name = "dequant + torch.mm(out_dtype=f32)"
        else:
            def library(i):
                return torch.mm(x, w[i % QMM_LAYERS], out_dtype=torch.float32)
            lib_name = "torch.mm(out_dtype=f32)"
        res = {"max_abs_err": err}
        if kind != "int8":  # the launch's plan, and its split model
            p = qmm.plan(m, k, n, kind, _build.device_sms(x.device))
            check_qmm_close(out, qmm.split_model(x, w[1], scale(1), p), x, w[1], scale(1),
                            False, what + " split model")
            res["plan"] = f"{p.path} {p.bm}x{p.bn}, {p.splits} splits, {p.units} units"
        res.update(time_three(
            lambda i: stacked(x, w, s, i % QMM_LAYERS),
            lambda i: plain(x, w[i % QMM_LAYERS], scale(i % QMM_LAYERS)),
            library,
            plain_iters=5,
        ))
        if kind == "int8":
            # the kernel alone, on activations quantized beforehand (the
            # wrapper's time above includes that quantization, in PyTorch)
            xq, sx = qmm.quantize_activations(x)
            assert torch.equal(qmm.launch_prepared(name, xq, sx, w, s, 1), out), what
            res["kernel_only_ms"], queued = time_ms(
                lambda i: qmm.launch_prepared(name, xq, sx, w, s, i % QMM_LAYERS))
            assert queued, f"{what}: the launch waited on the device"
        res["library"] = lib_name
        nbytes = (m * k * x.element_size() + k * n * w.element_size() + m * n * 4
                  + (0 if s is None else n * 4) + (m * 4 if kind == "int8" else 0))
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes, 2.0 * m * k * n, PEAK_INT8 if kind == "int8" else PEAK_BF16)
        res["row_tile"] = qmm.row_tile(m) if kind == "int8" else p.bm
        res["shape"] = (f"{model} {proj}: M={m} ({'decode' if m == 16 else 'prefill'}), "
                        f"K {k}, N {n}, {kind} weights, bf16 x")
        timed.append(res)
    del w, s
    free_device_memory()
    return timed, worst_f32, worst_edge


def check_qmm_splits(dev, g) -> dict:
    """K6 and K7 under the forced plans of ``QMM_SPLITS``, bf16 and f32 x,
    against the plain version and the split model; K6 also on weights with
    e4m3 NaN bytes (NaN columns where the plain version has them) -> {kernel
    name: worst error}."""
    worst = {}
    for kind in ("fp8_e4m3", "bf16"):
        name, _, unstacked, plain = QMM_KINDS[kind]
        worst[name] = 0.0
        for m, k, n, bm, splits in QMM_SPLITS:
            w, s = qmm_weights(g, dev, kind, k, n)
            sl = None if s is None else s[1]
            p = qmm.layout(m, k, n, splits, bm, _build.device_sms(dev))
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                out = qmm.launch_prepared(name, x.bfloat16().contiguous(), None, w, s, 1, p)
                what = f"{name} M={m} K={k} N={n} row tile {bm}, {splits} splits, {dtype} x"
                err = check_qmm_close(out, plain(x, w[1], sl), x, w[1], sl, False, what)
                check_qmm_close(out, qmm.split_model(x, w[1], sl, p), x, w[1], sl, False,
                                what + " split model")
                worst[name] = max(worst[name], err)
            del w, s
    w, s = qmm_weights(g, dev, "fp8_e4m3", 512, 256)
    w.view(torch.uint8)[1, 3, 5] = 0x7F  # e4m3 NaN bytes
    w.view(torch.uint8)[1, 300, 130] = 0xFF
    x = torch.randn(16, 512, generator=g, device=dev).bfloat16()
    out, ref = qmm.quant_matmul_fp8(x, w[1], s[1]), qmm.quant_matmul_fp8_plain(x, w[1], s[1])
    assert torch.equal(out.isnan(), ref.isnan()) and out[:, 5].isnan().all(), "e4m3 NaN"
    keep = ~ref.isnan()
    check_qmm_close(torch.where(keep, out, 0.0), torch.where(keep, ref, 0.0), x,
                    w[1].float().nan_to_num(), s[1], False, "quant_matmul_fp8 beside NaN weights")
    log(f"[kernels] K6 / K7 under {len(QMM_SPLITS)} forced plans x bf16 / f32 x: worst err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" against the plain version and the split model ({QMM_TOL}); e4m3 NaN bytes "
        "upcast to NaN")
    return worst


def check_qmm(dev) -> dict:
    """K5, K6, K7 at every shape of ``QMM_MODELS``: bf16 x at the timed
    and the edge rows, f32 x at the timed rows, K6 / K7 also under forced
    plans -> {kernel name: the first (Qwen3-8B decode qkv) result with
    every timed shape's in ``by_shape``}."""
    g = torch.Generator(device=dev).manual_seed(20)
    results = {}
    split_err = check_qmm_splits(dev, g)
    for kind, models in QMM_MODELS.items():
        name = QMM_KINDS[kind][0]
        by_shape, worst_f32, worst_edge, edges = [], 0.0, 0.0, []
        for model, shapes, rows, edge_rows in models:
            for proj, k, n in shapes:
                timed, f32, edge = check_qmm_shape(g, dev, kind, model, proj, k, n,
                                                   rows, edge_rows)
                by_shape += timed
                worst_f32, worst_edge = max(worst_f32, f32), max(worst_edge, edge)
            edges.append(f"{model} M {edge_rows}")
        row = dict(by_shape[0], by_shape=by_shape, max_abs_err_f32=worst_f32,
                   max_abs_err_edge_rows=worst_edge,
                   max_abs_err=max([worst_edge] + [r["max_abs_err"] for r in by_shape]))
        if name in split_err:
            row["max_abs_err_splits"] = split_err[name]
        results[name] = row
        log(f"[kernels] {name}: bf16 x err {row['max_abs_err']:.3g} (part-filled row "
            f"tiles, {'; '.join(edges)}: {worst_edge:.3g}), f32 x err {worst_f32:.3g} "
            f"({QMM_TOL})")
        for r in by_shape:
            lib = ("n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
            alone = (f" (the launch alone {r['kernel_only_ms']:.4f} ms)"
                     if "kernel_only_ms" in r else "")
            tile = r.get("plan", f"row tile {r['row_tile']}")
            log(f"[kernels]   {r['shape']}: kernel {r['ms']:.4f} ms{alone} ({tile}), "
                f"plain {r['plain_ms']:.4f} ms, library ({r['library']}) "
                f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def check_prefill_short_pages(rng, dev) -> float:
    """K3 and K3b on int8 and fp8 caches with pages of 16 and 32 positions,
    shorter than the kernel's 64-position tile (P then rounds against the
    running maximum after each page, as in the TPU kernel and the plain
    version), bf16 and f32 q, on grid inputs against the plain versions
    within ``TOL`` -> worst error."""
    worst, s = 0.0, 256
    rows = [(0, 200), (96, 100), (0, 0)]
    for bs in (16, 32):
        lens = [a + n for a, n in rows]
        nb = 1 + sum(-(-n // bs) for n in lens) + 4
        free = rng.permutation(np.arange(1, nb)).tolist()
        bt = np.zeros((len(rows), 256 // bs + 4), np.int32)
        for i, n in enumerate(lens):
            bt[i, : -(-n // bs)] = [free.pop() for _ in range(-(-n // bs))]
        btt, qo = i32(bt, dev), i32([a for a, _ in rows], dev)
        kvl = i32([a + n if n else 0 for a, n in rows], dev)
        g = torch.Generator(device=dev).manual_seed(6)
        for cache in QUANT_CACHES:
            for dtype in (torch.float32, torch.bfloat16):
                kc = grid_tensor(g, dev, (2, nb, HKV, bs, D), dtype, cache)
                vc = grid_values(g, dev, (2, nb, HKV, bs, D), dtype, cache)
                q = grid_tensor(g, dev, (len(rows), s, HQ, D), dtype)
                for single in (False, True):
                    kernel, plain = prefill_fns(single)
                    sel = slice(1, 2) if single else slice(None)
                    a = (1, btt[sel], qo[sel], kvl[sel], grid_scale(cache))
                    out, ref = kernel(q[sel], kc, vc, *a), plain(q[sel], kc, vc, *a)
                    sync()
                    what = (f"{'K3b' if single else 'K3'} {dtype} cache {cache} block_size "
                            f"{bs}")
                    worst = max(worst, check_close(out, ref, what))
    return worst


# context splits of the tensor-core kernel (the wrapper's plan splits a
# launch of few blocks): a chunk deep in its prompt in the 64 bucket at
# each GQA group the served models have (2: qwen3-1.7B, 4: Qwen3-8B, 8:
# Qwen3-30B-A3B), at block_size 16, 64 and 128, on bf16, int8 and fp8
# caches, with and without a window whose lower edge falls inside a split
SPLIT_GROUPS = ((16, 8), (32, 8), (32, 4))
SPLIT_PAGES = (16, 64, 128)
SPLIT_ROWS = {True: [(2048, 52)], False: [(2048, 52), (37, 27), (0, 0)]}
SPLIT_WINDOW = 300


def check_prefill_splits(rng, dev) -> dict:
    """K3 and K3b launches that split their context, on grid inputs: each
    against the unsplit plain version and against the split model with the
    kernel's own plan (``k3.split_plan``), within ``TOL`` at every output
    -> {kernel name: worst error}; prints each launch's split count."""
    worst: dict[str, float] = {}
    g = torch.Generator(device=dev).manual_seed(40)
    s = RMW_S
    for hq, hkv in SPLIT_GROUPS:
        for bs in SPLIT_PAGES:
            nbmax = 4096 // bs
            for cache in (None, "int8", "fp8_e4m3"):
                for single in (True, False):
                    rows = SPLIT_ROWS[single]
                    bt, nb = _paged(rng, [a + n for a, n in rows], bs, nbmax)
                    shape = (2, nb, hkv, bs, D)
                    kc = grid_tensor(g, dev, shape, torch.bfloat16, cache)
                    vc = grid_values(g, dev, shape, torch.bfloat16, cache)
                    q = grid_tensor(g, dev, (len(rows), s, hq, D), torch.bfloat16)
                    chunk, nsplit = k3.split_plan(len(rows), s, hq, hkv, nbmax * bs, bs)
                    assert nsplit > 1, f"Hq {hq} Hkv {hkv} bs {bs}: the plan does not split"
                    kernel, plain = prefill_fns(single)
                    name = k3.ONE_NAME if single else k3.NAME
                    for window in (0, SPLIT_WINDOW):
                        a = (1, i32(bt, dev), i32([a_ for a_, _ in rows], dev),
                             i32([a_ + n if n else 0 for a_, n in rows], dev),
                             grid_scale(cache), window)
                        out = kernel(q, kc, vc, *a)
                        ref = plain(q, kc, vc, *a)
                        model = k3.paged_attention_prefill_batched_plain(q, kc, vc, *a, chunk)
                        sync()
                        what = (f"{name} Hq {hq} Hkv {hkv} bs {bs} cache {cache or 'bf16'} "
                                f"window {window}, {nsplit} splits of {chunk}")
                        err = max(check_close(out, ref, what),
                                  check_close(out, model, what + " (split model)"))
                        for i, (_, n) in enumerate(rows):
                            assert not out[i, n:].float().abs().any(), f"{what}: row {i} past ntok"
                        worst[name] = max(worst.get(name, 0.0), err)
                    log(f"[kernels]   split launch: {name} Hq {hq} Hkv {hkv} bs {bs} cache "
                        f"{cache or 'bf16'} {rows}: {nsplit} splits of {chunk} positions")
            free_device_memory()
    return worst


def phase_quant_caches(rng, dev) -> dict:
    """K1-K4 on int8 and fp8 caches at qwen3-1.7B's shapes: bf16 q timed,
    f32 q checked -> {kernel name: {cache: result}}."""
    checks = {
        k1.NAME: lambda dt, t, c: check_decode(rng, dev, dt, t, cache=c),
        k24.PREFILL_NAME: lambda dt, t, c: check_writer(rng, dev, dt, t, rmw=False, cache=c),
        k3.NAME: lambda dt, t, c: check_prefill(rng, dev, dt, t, cache=c),
        k24.RMW_NAME: lambda dt, t, c: check_writer(rng, dev, dt, t, rmw=True, cache=c),
        k24.ONE_PREFILL_NAME: lambda dt, t, c: check_single_writer(rng, dev, dt, t, rmw=False,
                                                                   cache=c),
        k3.ONE_NAME: lambda dt, t, c: check_single_prefill(rng, dev, dt, t, cache=c),
        k24.ONE_RMW_NAME: lambda dt, t, c: check_single_writer(rng, dev, dt, t, rmw=True,
                                                               cache=c),
    }
    out = {}
    for name, check in checks.items():
        out[name] = {}
        for cache in QUANT_CACHES:
            f32 = check(torch.float32, False, cache)
            res = check(torch.bfloat16, True, cache)
            res["max_abs_err_f32"] = f32["max_abs_err"]
            out[name][cache] = res
            log(f"[kernels] {name} on a {cache} cache: bf16 q err {res['max_abs_err']:.3g}, "
                f"f32 q err {f32['max_abs_err']:.3g} ({QUANT_TOL})")
            for r in res.get("by_shape", [res]):
                log(f"[kernels]   {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            free_device_memory()
    err = check_prefill_short_pages(rng, dev)
    log(f"[kernels] {k3.NAME} and {k3.ONE_NAME} on int8 and fp8 caches with block_size 16 "
        f"and 32 (P rounded against the running maximum after each page), bf16 and f32 q: "
        f"worst err {err:.3g} ({GRID_TOL})")
    return out


# the P-rounding repairs at every page size the kernels take: (sequence
# lengths of a decode batch, prefill chunks (q_offset, ntok) in the 512
# bucket and in the 64 bucket)
PAGE_SIZES = (16, 32, 64, 128)
PAGE_LENS = [1, 17, 100, 700, 2100, 65, 4095, 0]
PAGE_ROWS = {512: [(0, 300), (96, 100), (0, 0)], 64: [(2048, 52), (37, 27)]}


def _paged(rng, lens, bs, nbmax, extra: int = 2):
    """Disjoint random pages of ``bs`` positions per sequence -> (block
    tables [N, nbmax] int32, number of blocks)."""
    nb = 1 + sum(-(-n // bs) for n in lens) + extra
    free = rng.permutation(np.arange(1, nb)).tolist()
    bt = np.zeros((len(lens), nbmax), np.int32)
    for i, n in enumerate(lens):
        bt[i, : -(-n // bs)] = [free.pop() for _ in range(-(-n // bs))]
    return bt, nb


def mla_grid(g, dev, dtype, *shape, cache=None) -> torch.Tensor:
    """Latent rows or queries on the grid, pad lanes (576:640) zeros; an
    fp8 cache's values are quarters in [-2, 2]."""
    if cache:
        x = torch.randint(-8, 9, shape, generator=g, device=dev) * 0.25
    else:
        x = grid_tensor(g, dev, shape, dtype)
    x[..., MLA_DK_LIVE:] = 0
    return to_e4m3(x) if cache else x


def check_page_sizes(rng, dev) -> dict:
    """The P-rounding repairs (faults F1-F4) at every page size: K1, K3, K3b
    at qwen3-1.7B's heads and K11a, K11b, K11e at DeepSeek-V2-Lite's on
    pages of 16, 32, 64 and 128 positions, bf16 q on bf16, int8 and fp8
    caches (K11: bf16 and fp8), f32 q on f32 and fp8 caches, on grid
    inputs: each kernel against its plain version within ``TOL`` at every
    output -> {kernel: worst error}."""
    worst: dict[str, float] = {}
    g = torch.Generator(device=dev).manual_seed(21)

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    gqa = [(torch.bfloat16, None), (torch.bfloat16, "int8"), (torch.bfloat16, "fp8_e4m3"),
           (torch.float32, None), (torch.float32, "fp8_e4m3")]
    for bs in PAGE_SIZES:
        nbmax = 4096 // bs
        for dtype, cache in gqa:
            # new K/V rows as the model hands them over: int8 codes or values
            new = "int8" if cache == "int8" else None
            scale = grid_scale(cache)
            # K1: a decode batch over contexts of 1 to 4,095 tokens, one padded
            bt, nb = _paged(rng, PAGE_LENS, bs, nbmax)
            shape = (2, nb, HKV, bs, D)
            kc, vc = grid_tensor(g, dev, shape, dtype, cache), grid_values(g, dev, shape, dtype,
                                                                          cache)
            b = len(PAGE_LENS)
            q = grid_tensor(g, dev, (b, HQ, D), dtype)
            kn = grid_tensor(g, dev, (b, HKV, D), dtype, new)
            vn = grid_values(g, dev, (b, HKV, D), dtype, new)
            sm = i32([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                      for i, n in enumerate(PAGE_LENS)], dev)
            a = (1, sm, i32(bt, dev), i32(PAGE_LENS, dev), scale)
            for window in (0, 100):
                kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                out = k1.paged_decode_attention_write(q, kn, vn, kk, vk, *a, window)
                ref = k1.paged_decode_attention_write_plain(q, kn, vn, kp, vp, *a, window)
                sync()
                what = f"K1 bs {bs} {dtype} cache {cache or dtype} window {window}"
                assert same_bytes(kk, kp) and same_bytes(vk, vp), f"{what}: caches differ"
                note(k1.NAME, check_close(out, ref, what))
            # K3 and K3b: chunks in the 512 and 64 buckets
            for s, rows in PAGE_ROWS.items():
                lens = [a_ + n for a_, n in rows]
                bt, nb = _paged(rng, lens, bs, nbmax)
                shape = (2, nb, HKV, bs, D)
                kc = grid_tensor(g, dev, shape, dtype, cache)
                vc = grid_values(g, dev, shape, dtype, cache)
                q = grid_tensor(g, dev, (len(rows), s, HQ, D), dtype)
                args = (1, i32(bt, dev), i32([a_ for a_, _ in rows], dev),
                        i32([a_ + n if n else 0 for a_, n in rows], dev), scale)
                for single in (False, True):
                    kernel, plain = prefill_fns(single)
                    sel = slice(0, 1) if single else slice(None)
                    a_ = (1,) + tuple(t[sel] for t in args[1:4]) + (args[4],)
                    out, ref = kernel(q[sel], kc, vc, *a_), plain(q[sel], kc, vc, *a_)
                    sync()
                    name = k3.ONE_NAME if single else k3.NAME
                    note(name, check_close(out, ref, f"{name} bs {bs} {dtype} cache "
                                           f"{cache or dtype} S {s}"))
        free_device_memory()
        for dtype, cache in ((torch.bfloat16, None), (torch.bfloat16, "fp8_e4m3"),
                             (torch.float32, None), (torch.float32, "fp8_e4m3")):
            scale = grid_scale(cache, mla=True)
            lens = [n for n in PAGE_LENS if n] + [0]
            bt, nb = _paged(rng, lens, bs, nbmax)
            c = mla_grid(g, dev, dtype, 2, nb, 1, bs, MLA_DK, cache=cache)
            b = len(lens)
            q = mla_grid(g, dev, dtype, b, MLA_H, MLA_DK)
            ln = mla_grid(g, dev, dtype, b, MLA_DK)  # cast to e4m3 on an fp8 cache
            btt, sl = i32(bt, dev), i32(lens, dev)
            sm = i32([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                      for i, n in enumerate(lens)], dev)
            ck, cp = c.clone(), c.clone()
            out = k11.mla_decode_attention_write(q, ln, ck, 1, sm, btt, sl, scale, MLA_DV)
            ref = k11.mla_decode_attention_write_plain(q, ln, cp, 1, sm, btt, sl, scale, MLA_DV)
            sync()
            what = f"K11a bs {bs} {dtype} cache {cache or dtype}"
            assert same_bytes(ck, cp), f"{what}: caches differ"
            note(k11.DECODE_NAME, check_close(out, ref, what))
            for s, rows in PAGE_ROWS.items():
                lens = [a_ + n for a_, n in rows]
                bt, nb = _paged(rng, lens, bs, nbmax)
                c = mla_grid(g, dev, dtype, 2, nb, 1, bs, MLA_DK, cache=cache)
                q = mla_grid(g, dev, dtype, len(rows), s, MLA_H, MLA_DK)
                btt = i32(bt, dev)
                qo = i32([a_ for a_, _ in rows], dev)
                kvl = i32([a_ + n if n else 0 for a_, n in rows], dev)
                for single in (False, True):
                    kernel, plain = mla_prefill_fns(single)
                    sel = slice(0, 1) if single else slice(None)
                    out = kernel(q[sel], c, 1, btt[sel], qo[sel], kvl[sel], scale, MLA_DV)
                    ref = plain(q[sel], c, 1, btt[sel], qo[sel], kvl[sel], scale, MLA_DV)
                    sync()
                    name = k11.ONE_PREFILL_NAME if single else k11.PREFILL_NAME
                    note(name, check_close(out, ref, f"{name} bs {bs} {dtype} cache "
                                           f"{cache or dtype} S {s}"))
            free_device_memory()
    return worst


def phase_fp8_kernels(rng, dev) -> dict:
    """This slice's fp8 instances: K10 with fp8 expert stacks at
    Qwen3-30B-A3B's and DeepSeek-V2-Lite's shapes, and K11a-g on an fp8
    latent cache at DeepSeek-V2-Lite's (bf16 q timed, f32 q checked) ->
    {kernel name: result of the fp8 instance}."""
    g = torch.Generator(device=dev).manual_seed(20)
    by_shape = []
    for model in GMM_MODELS:
        by_shape += check_gmm_fp8(dev, g, model)
        free_device_memory()
    out = {k10.NAME: dict(by_shape[0], max_abs_err=max(r["max_abs_err"] for r in by_shape),
                          max_abs_err_f32=max(r["max_abs_err_f32"] for r in by_shape),
                          by_shape=by_shape)}
    log(f"[qkernels] {k10.NAME} with an fp8 rhs: bf16 lhs err {out[k10.NAME]['max_abs_err']:.3g}"
        f", f32 lhs err {out[k10.NAME]['max_abs_err_f32']:.3g} ({GMM_TOL})")
    for r in by_shape:
        tiles = ", ".join(f"{kn}: {t:.4f}" for kn, t in r["ms_by_instance"].items())
        log(f"[qkernels]   {r['shape']}: kernel {r['ms']:.4f} ms (by instance {tiles}), "
            f"plain {r['plain_ms']:.4f} ms "
            f"(serial: it syncs), library ({r['library']}) {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    check_moe_fp8_no_host_sync(dev, g)
    log("[qkernels] MoE block with fp8 experts at decode shape under sync debug mode "
        "'error': no host sync")
    checks = {
        k11.DECODE_NAME: lambda dt, t: check_mla_decode(rng, dev, dt, t, cache="fp8_e4m3"),
        k11.PREFILL_NAME: lambda dt, t: check_mla_prefill(rng, dev, dt, t, cache="fp8_e4m3"),
        k11.ONE_PREFILL_NAME: lambda dt, t: check_mla_single_prefill(rng, dev, dt, t,
                                                                     cache="fp8_e4m3"),
        k24.LATENT_PREFILL_NAME: lambda dt, t: check_latent_writer(
            rng, dev, dt, t, rmw=False, cache="fp8_e4m3"),
        k24.LATENT_RMW_NAME: lambda dt, t: check_latent_writer(
            rng, dev, dt, t, rmw=True, cache="fp8_e4m3"),
        k24.ONE_LATENT_PREFILL_NAME: lambda dt, t: check_single_latent_writer(
            rng, dev, dt, t, rmw=False, cache="fp8_e4m3"),
        k24.ONE_LATENT_RMW_NAME: lambda dt, t: check_single_latent_writer(
            rng, dev, dt, t, rmw=True, cache="fp8_e4m3"),
    }
    for name, check in checks.items():
        f32 = check(torch.float32, False)
        res = check(torch.bfloat16, True)
        res["max_abs_err_f32"] = f32["max_abs_err"]
        out[name] = res
        log(f"[qkernels] {name} on an fp8 latent cache: bf16 inputs err "
            f"{res['max_abs_err']:.3g}, f32 inputs err {f32['max_abs_err']:.3g} ({MLA_TOL})")
        for r in res.get("by_shape", [res]):
            log(f"[qkernels]   {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library ({r.get('library', 'index assign')}) "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        free_device_memory()
    return out


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(0)
    checks = {
        k1.NAME: lambda dt, t: check_decode(rng, dev, dt, t),
        k24.PREFILL_NAME: lambda dt, t: check_writer(rng, dev, dt, t, rmw=False),
        k3.NAME: lambda dt, t: check_prefill(rng, dev, dt, t),
        k24.RMW_NAME: lambda dt, t: check_writer(rng, dev, dt, t, rmw=True),
        k11.DECODE_NAME: lambda dt, t: check_mla_decode(rng, dev, dt, t),
        k11.PREFILL_NAME: lambda dt, t: check_mla_prefill(rng, dev, dt, t),
        k24.LATENT_PREFILL_NAME: lambda dt, t: check_latent_writer(rng, dev, dt, t, rmw=False),
        k24.LATENT_RMW_NAME: lambda dt, t: check_latent_writer(rng, dev, dt, t, rmw=True),
        # the single-chunk kernels of prompt scoring and embeddings
        k24.ONE_PREFILL_NAME: lambda dt, t: check_single_writer(rng, dev, dt, t, rmw=False),
        k3.ONE_NAME: lambda dt, t: check_single_prefill(rng, dev, dt, t),
        k24.ONE_RMW_NAME: lambda dt, t: check_single_writer(rng, dev, dt, t, rmw=True),
        k11.ONE_PREFILL_NAME: lambda dt, t: check_mla_single_prefill(rng, dev, dt, t),
        k24.ONE_LATENT_PREFILL_NAME: lambda dt, t: check_single_latent_writer(
            rng, dev, dt, t, rmw=False),
        k24.ONE_LATENT_RMW_NAME: lambda dt, t: check_single_latent_writer(
            rng, dev, dt, t, rmw=True),
    }
    tol_of = {name: ROUND_TOL for name in (k1.NAME, k3.NAME, k3.ONE_NAME)}
    tol_of.update({name: MLA_TOL for name in (k11.DECODE_NAME, k11.PREFILL_NAME,
                                         k24.LATENT_PREFILL_NAME, k24.LATENT_RMW_NAME,
                                         k11.ONE_PREFILL_NAME, k24.ONE_LATENT_PREFILL_NAME,
                                         k24.ONE_LATENT_RMW_NAME)})
    results = {}
    for name, check in checks.items():
        f32 = check(torch.float32, False)
        res = check(torch.bfloat16, True)
        res["max_abs_err_f32"] = f32["max_abs_err"]
        results[name] = res
        tol = tol_of.get(name, f"bf16 {tol_text(torch.bfloat16)}, f32 {tol_text(torch.float32)}")
        log(f"[kernels] {name}: bf16 err {res['max_abs_err']:.3g}, f32 err "
            f"{f32['max_abs_err']:.3g} ({tol})")
        for r in res.get("by_shape", [res]):
            serial = {True: "", False: " (serial: it syncs)"}
            log(f"[kernels]   {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms{serial[r['plain_queued']]}, library "
                f"({r.get('library', 'SDPA or index assign')}) "
                f"{r['library_ms']:.4f} ms{serial[r['library_queued']]}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        free_device_memory()
    for dtype in (torch.float32, torch.bfloat16):
        err = check_decode_variants(rng, dev, dtype)
        log(f"[kernels] {k1.NAME} variants {DECODE_VARIANTS} (head_dim, Hq, Hkv, bs, "
            f"table width, window), {dtype}: worst err {err:.3g} ({GRID_TOL})")
        # K3 at Qwen3-30B-A3B's GQA group (G = 8)
        err = max(check_prefill_shape(rng, dev, dtype, False, s, rows, hq=32, hkv=4,
                                      grid=True)["max_abs_err"]
                  for s, rows in K3_SHAPES.items())
        log(f"[kernels] {k3.NAME} at Hq 32, Hkv 4, every chunk bucket, {dtype}: "
            f"worst err {err:.3g} ({GRID_TOL})")
        err = check_mla_heads(rng, dev, dtype)
        log(f"[kernels] {k11.DECODE_NAME} and {k11.PREFILL_NAME} at H 20 (every chunk "
            f"bucket) and H 128 (buckets 64, 512), {dtype}: worst err {err:.3g} ({MLA_TOL})")

    g = torch.Generator(device=dev).manual_seed(10)
    by_shape, worst_f32 = [], 0.0
    for model in GMM_MODELS:
        shapes, f32_err = check_gmm(dev, g, model)
        by_shape += shapes
        worst_f32 = max(worst_f32, f32_err)
        free_device_memory()
    # the kernels line's K10 numbers: Qwen3-30B-A3B's decode gate_up
    res = dict(by_shape[0], max_abs_err=max(r["max_abs_err"] for r in by_shape),
               max_abs_err_f32=worst_f32, by_shape=by_shape)
    results[k10.NAME] = res
    w = moe_weights(dev, g, GMM_MODELS["Qwen3-30B-A3B"])
    log(f"[kernels] {k10.NAME}: bf16 err {res['max_abs_err']:.3g}, f32 err "
        f"{res['max_abs_err_f32']:.3g} ({GMM_TOL})")
    for r in res["by_shape"]:
        tiles = ", ".join(f"{kn}: {t:.4f}" for kn, t in r["ms_by_instance"].items())
        log(f"[kernels]   {r['shape']}: kernel {r['ms']:.4f} ms (by instance {tiles}), "
            f"plain {r['plain_ms']:.4f} ms (serial: it syncs), library "
            f"(torch._grouped_mm, bf16 out) {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    err = check_gmm_edges(dev, w, g)
    log(f"[kernels] {k10.NAME} with empty experts, one expert holding every row, experts "
        f"of > 256 rows, rows outside every group, M 1000, each instance, bf16 / e4m3 / f32 "
        f"rhs: worst err {err:.3g} ({GMM_TOL})")
    check_moe_no_host_sync(dev, w, g)
    log("[kernels] MoE block at decode and 512-token shapes under sync debug mode 'error': "
        "no host sync")
    del w
    free_device_memory()
    worst = check_prefill_splits(rng, dev)
    log(f"[kernels] context splits of {k3.NAME} and {k3.ONE_NAME} at Hq / Hkv {SPLIT_GROUPS}, "
        f"block_size {SPLIT_PAGES}, bf16 / int8 / fp8 caches, window 0 and {SPLIT_WINDOW}, "
        f"against the unsplit plain version and the split model: worst errors {worst} "
        f"({GRID_TOL})")
    worst = check_page_sizes(rng, dev)
    log(f"[kernels] P-rounding repairs (F1-F4) at block_size {PAGE_SIZES}: {k1.NAME}, "
        f"{k3.NAME}, {k3.ONE_NAME} on bf16 / int8 / fp8 caches and {k11.DECODE_NAME}, "
        f"{k11.PREFILL_NAME}, {k11.ONE_PREFILL_NAME} on bf16 / fp8 latent caches, bf16 and "
        f"f32 q: worst errors {worst} ({GRID_TOL})")
    return results


# ---------------------------------------------------------------------------
# K8 and K9: the interleaved layouts, [L, NB, 2, Hkv, bs, D]
# ---------------------------------------------------------------------------
# a decode batch of 16 over the served contexts: padded rows, new tokens
# that open a page (seq_len 1, 65, 193, 449: n_win 0), that complete one
# (64, 320, 2112: w == bs - 1; K9 then rewrites the page canonical), full
# pages nfull % 4 != 0 before a tail (130, 716, 1000, 4095), up to 4,095
ILV_LENS = [56, 316, 716, 2116, 65, 1, 64, 320, 449, 2112, 4095, 193, 130, 1000, 0, 0]
# timed first at K1's own batch (check_decode), for a comparison at equal work
ILV_TIMED_LENS = [56, 316, 716, 2116] * 3 + [56, 316] + [0, 0]
# the caches each layout serves: K8 (interleaved) also int8, K9 not
ILV_CACHES = {False: (None, "int8", "fp8_e4m3"), True: (None, "fp8_e4m3")}
# writers: (S, chunks (q_offset, ntok)) in each bucket, the first timed;
# the full-page writers at S 512 and 2048 with chunks at q_offset > 0 that
# end mid-page; the RMW writers at S 64 with chunks that start mid-page,
# complete the first page (37 + 27 = 64) and cross a page boundary
ILV_WRITES = {False: [(PREFILL_S, PREFILL_ROWS), (2048, [(0, 2048), (2048, 1500), (0, 0)])],
              True: [(RMW_S, RMW_ROWS), (RMW_S, [(0, 64), (63, 1), (1, 63), (0, 0)])]}


def rm_rmw_rows(bs: int) -> list[tuple[int, int]]:
    """K9's RMW writer at block size ``bs``: a page completed from its
    first row (w0 = 0), one completed by its last row (w0 = bs - 1), a
    chunk that completes one page from row 3 and opens the next (two pages,
    one left incomplete), a page left incomplete, a padded row."""
    return [(0, bs), (bs - 1, 1), (bs + 3, bs - 1), (5 * bs, bs // 2), (0, 0)]
# K8's prefill at each bucket (chunks at q_offset > 0 ending mid-page); the
# first two timed, the first at K3's own timed shape
ILV_PREFILL = [(2048, K3_SHAPES[2048]), (2048, [(0, 2048), (2048, 1500), (0, 0)]),
               (PREFILL_S, PREFILL_ROWS), (64, [(2048, 52), (37, 27), (0, 0)])]
ILV_WINDOW = 100
ILV_TOL = ("grid inputs: bf16 out |out - ref| <= 1e-5 + 2^-7 |ref|, f32 out 1e-4, at every "
           "output; caches byte-equal")


def ilv_tables(rng, lens, bs, nbmax, contiguous: bool):
    """Each sequence's pages: distinct random blocks, or (``contiguous``)
    consecutive ones -> (block tables [N, nbmax] int32, number of blocks)."""
    if not contiguous:
        return _paged(rng, lens, bs, nbmax)
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        k = -(-n // bs)
        bt[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    return bt, nxt + 2


def ilv_decode_fns(rm: bool):
    if rm:
        return k1.paged_decode_attention_write_rm, k1.paged_decode_attention_write_rm_plain
    return k1.paged_decode_attention_write_ilv, k1.paged_decode_attention_write_ilv_plain


def ilv_name(kind: str, rm: bool) -> str:
    """The kernels line's name of K8's / K9's decode or writers."""
    return {("decode", False): k1.ILV_NAME, ("decode", True): k1.RM_NAME,
            ("prefill", False): k24.ILV_PREFILL_NAME, ("prefill", True): k24.RM_PREFILL_NAME,
            ("rmw", False): k24.ILV_RMW_NAME, ("rmw", True): k24.RM_RMW_NAME}[(kind, rm)]


def gathered(kv, l, idx, half, dtype):
    """Layer l's pages ``idx`` [N, n] of one half (0: K, 1: V) of an
    interleaved cache, contiguous [N, Hkv, n * bs, D] in ``dtype`` (the
    SDPA yardstick's K / V; row-major tails are read as canonical, which
    costs the same)."""
    pages = kv[l][idx][:, :, half]  # [N, n, Hkv, bs, D]
    n, npg, hkv, bs, d = pages.shape
    return pages.permute(0, 2, 1, 3, 4).reshape(n, hkv, npg * bs, d).to(dtype)


def check_ilv_decode(rng, dev, g, dtype, cache, rm: bool, bs: int = BS, lens=ILV_LENS,
                     contiguous: bool = False, window: int = 0, timed: bool = False,
                     tile: int = 4) -> dict:
    """K8, or K9 with ``rm``, against its plain version on grid inputs (q and
    K on the grid, a power-of-two scale) within ``TOL`` at every output; the
    caches byte-equal after the call (K9's new rows token-major, its
    completed pages canonical); padded rows zeros. ``tile``: the pages of
    its rounding tile (``XLLM_DECODE_KERNEL=v11tT`` / ``v12tT``)."""
    kernel, plain = ilv_decode_fns(rm)
    nbmax = 4096 // bs
    bt, nb = ilv_tables(rng, lens, bs, nbmax, contiguous)
    layers = LAYERS if timed else 2
    kc = grid_tensor(g, dev, (layers, nb, 2, HKV, bs, D), dtype, cache)
    b = len(lens)
    new = "int8" if cache == "int8" else None
    q = grid_tensor(g, dev, (b, HQ, D), dtype)
    kn = grid_tensor(g, dev, (b, HKV, D), dtype, new)
    vn = grid_values(g, dev, (b, HKV, D), dtype, new)
    sm = i32([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
              for i, n in enumerate(lens)], dev)
    btt, sl, scale = i32(bt, dev), i32(lens, dev), grid_scale(cache)
    kk, kp = kc.clone(), kc.clone()
    out = kernel(q, kn, vn, kk, 1, sm, btt, sl, scale, window, tile)
    ref = plain(q, kn, vn, kp, 1, sm, btt, sl, scale, window, tile)
    sync()
    what = (f"{ilv_name('decode', rm)} {dtype} cache {cache or dtype} bs {bs} window {window}"
            f" tile {tile}{' contiguous pages' if contiguous else ''}")
    err = check_close(out, ref, what)
    assert same_bytes(kk, kp), f"{what}: caches differ"
    assert not out[[i for i, n in enumerate(lens) if not n]].float().abs().any(), (
        f"{what}: padded rows must be zeros")
    res = {"max_abs_err": err}
    if not timed:
        return res
    q_el, c_el, n_el = q.element_size(), kc.element_size(), kn.element_size()
    live = [n for n in lens if n]
    ntok = sum(n - 1 for n in live)  # cached rows read once
    done = sum(1 for n in live if rm and n % bs == 0)  # K9's completed pages
    nbytes = (2 * b * HQ * D * q_el + 2 * len(live) * HKV * D * n_el
              + 2 * ntok * HKV * D * c_el
              + 2 * (len(live) - done) * HKV * D * c_el  # new rows written
              + done * 2 * HKV * bs * D * c_el)  # completed pages written whole
    flops = 4.0 * sum(live) * HQ * D
    lmax = -(-max(lens) // bs) * bs
    idx = btt[:, : lmax // bs].long()
    kg = [gathered(kc, l, idx, 0, dtype) for l in range(layers)]
    vg = [gathered(kc, l, idx, 1, dtype) for l in range(layers)]
    mask = (torch.arange(lmax, device=dev)[None, :] < sl[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    res.update(time_three(
        lambda i: kernel(q, kn, vn, kc, i % layers, sm, btt, sl, scale, 0, tile),
        lambda i: plain(q, kn, vn, kc, i % layers, sm, btt, sl, scale, 0, tile),
        lambda i: sdpa(q4, kg[i % layers], vg[i % layers], mask, scale),
        plain_iters=10,
    ))
    res["shape"] = (f"B={b} ({b - len(live)} padded), seq_lens {sorted(set(live))}, Hq {HQ}, "
                    f"Hkv {HKV}, D {D}, bs {bs}, random pages")
    # host cost per call, beside K1's on the same rows in two split caches
    ks, vs = kc[:, :, 0].contiguous(), kc[:, :, 1].contiguous()
    res["host_us"] = host_us(lambda i: kernel(q, kn, vn, kc, i % layers, sm, btt, sl, scale))
    res["host_us_k1"] = host_us(lambda i: k1.paged_decode_attention_write(
        q, kn, vn, ks, vs, i % layers, sm, btt, sl, scale))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


def ilv_writer_fns(rmw: bool, rm: bool):
    """-> (kernel, plain) of K8's / K9's writers, each called as f(kn, vn,
    kv_all, layer, block_tables, q_offsets, ntoks, kv_lens), the source
    token-major [P, S, Hkv, D] (RMW) or head-major [P, Hkv, S, D]."""
    def tok(kn, vn):
        return (kn, vn) if rmw else (kn.transpose(1, 2), vn.transpose(1, 2))

    if rm:
        fn = k24.kv_write_rmw_batched_rm if rmw else k24.kv_write_prefill_batched_rm

        def plain(kn, vn, kv, layer, btt, qo, nt, kvl):
            k24.kv_write_rm_plain(*tok(kn, vn), kv, layer, btt, qo, nt, kvl)

        return fn, plain
    fn = k24.kv_write_rmw_batched_ilv if rmw else k24.kv_write_prefill_batched_ilv

    def plain(kn, vn, kv, layer, btt, qo, nt, kvl):
        k24.kv_write_rows_plain(*tok(kn, vn), kv[:, :, 0], kv[:, :, 1], layer, btt, qo, nt)

    return (lambda kn, vn, kv, layer, btt, qo, nt, kvl: fn(kn, vn, kv, layer, btt, qo, nt)), plain


def check_ilv_writer(rng, dev, g, dtype, cache, rmw: bool, rm: bool, s: int, rows,
                     timed: bool = False, bs: int = BS) -> dict:
    """K8's or K9's full-page (``rmw`` False) or RMW writer against its
    plain version: caches byte-equal after the call, e4m3 edge values cast
    in the kernel on an fp8 cache, one launch a call."""
    p = len(rows)
    nb, btt, qo, nt, kvl = _chunk_tables(rng, rows, dev, bs)
    layers = LAYERS if timed else 2
    kc = kv_tensor(g, dev, (layers, nb, 2, HKV, bs, D), dtype, cache)
    src_shape = (p, s, HKV, D) if rmw else (p, HKV, s, D)
    kn = new_rows(g, dev, src_shape, dtype, cache)
    vn = new_rows(g, dev, src_shape, dtype, cache)
    if cache == "fp8_e4m3":
        kn[0, 0, 0, :len(E4M3_EDGES)] = torch.tensor(E4M3_EDGES, dtype=dtype, device=dev)
        vn[0, 0, 0, :len(E4M3_EDGES)] = -torch.tensor(E4M3_EDGES, dtype=dtype, device=dev)
    kernel, plain = ilv_writer_fns(rmw, rm)
    kk, kp = kc.clone(), kc.clone()
    name = ilv_name("rmw" if rmw else "prefill", rm)
    before = _build.launch_counts.get(name, 0)
    kernel(kn, vn, kk, 1, btt, qo, nt, kvl)
    assert _build.launch_counts[name] == before + 1, f"{name}: not one launch a call"
    plain(kn, vn, kp, 1, btt, qo, nt, kvl)
    sync()
    what = f"{name} {dtype} cache {cache or dtype} S={s} bs {bs} {rows}"
    assert same_bytes(kk, kp), f"{what}: caches differ"
    assert not same_bytes(kk, kc), f"{what}: nothing was written"
    res = {"max_abs_err": 0.0}
    if not timed:
        return res
    ntok = sum(n for _, n in rows)
    src_el, c_el = kn.element_size(), kc.element_size()
    nbytes = 2 * ntok * HKV * D * (src_el + c_el)
    if rm and rmw:  # a completed page: its earlier rows read, the page written whole
        for a, n in rows:
            for pg in range(a // BS, -(-(a + n) // BS) if n else 0):
                if (pg + 1) * BS <= a + n:
                    old = max(a - pg * BS, 0)
                    nbytes += 2 * HKV * D * c_el * (2 * old)
    # library yardstick: one advanced-index row assignment into each half,
    # the row indices computed beforehand (an fp8 cache takes the rows'
    # bytes, cast beforehand)
    pos = [(i, a + j) for i, (a, n) in enumerate(rows) for j in range(n)]
    bt_np = btt.cpu().numpy()
    blk = i32([bt_np[i, ps // BS] for i, ps in pos], dev).long()
    off = i32([ps % BS for _, ps in pos], dev).long()
    sel = [(i, j) for i, (_, n) in enumerate(rows) for j in range(n)]
    src_k = kn if rmw else kn.transpose(1, 2)
    src_v = vn if rmw else vn.transpose(1, 2)
    rk = torch.stack([src_k[i, j] for i, j in sel])
    rv = torch.stack([src_v[i, j] for i, j in sel])
    lc = kc
    if cache is not None:
        rk, rv = (to_e4m3(r) if cache == "fp8_e4m3" else r for r in (rk, rv))
        lc, rk, rv = (t.view(torch.uint8) for t in (kc, rk, rv))

    def library(i):
        lc[i % layers, blk, 0, :, off, :] = rk
        lc[i % layers, blk, 1, :, off, :] = rv

    res.update(time_three(
        lambda i: kernel(kn, vn, kc, i % layers, btt, qo, nt, kvl),
        lambda i: plain(kn, vn, kc, i % layers, btt, qo, nt, kvl),
        library,
        plain_iters=20,
    ))
    res["shape"] = (f"P={p} chunks of S={s} (q_offset, ntok) {rows}, "
                    f"{'token' if rmw else 'head'}-major, Hkv {HKV}, D {D}, bs {BS}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0)
    return res


def check_ilv_prefill(rng, dev, g, dtype, cache, rm: bool, s: int, rows, bs: int = BS,
                      window: int = 0, timed: bool = False) -> dict:
    """K8's prefill (K9's row-major tails with ``rm``) against its plain
    version on grid inputs within ``TOL`` at every output; rows past a
    chunk's tokens zeros."""
    lens = [a + n for a, n in rows]
    bt, nb = _paged(rng, lens, bs, max(4096 // bs, -(-max(lens) // bs)))
    btt = i32(bt, dev)
    qo = i32([a for a, _ in rows], dev)
    kvl = i32([a + n if n else 0 for a, n in rows], dev)
    layers = LAYERS if timed else 2
    kc = grid_tensor(g, dev, (layers, nb, 2, HKV, bs, D), dtype, cache)
    q = grid_tensor(g, dev, (len(rows), s, HQ, D), dtype)
    scale = grid_scale(cache)
    args = (btt, qo, kvl, scale, window, rm)
    out = k3.paged_attention_prefill_batched_ilv(q, kc, 1, *args)
    ref = k3.paged_attention_prefill_batched_ilv_plain(q, kc, 1, *args)
    sync()
    what = (f"{k3.ILV_NAME} {dtype} cache {cache or dtype} rowmajor_tail {rm} bs {bs} S={s} "
            f"{rows} window {window}")
    err = check_close(out, ref, what)
    for i, (_, n) in enumerate(rows):
        assert not out[i, n:].float().abs().any(), f"{what}: row {i} past ntok not zero"
    res = {"max_abs_err": err}
    if not timed:
        return res
    q_el, c_el = q.element_size(), kc.element_size()
    ntok = sum(n for _, n in rows)
    kv_rows = sum(a + n for a, n in rows if n)
    pairs = sum(sum(min(a + i + 1, window or a + i + 1) for i in range(n)) for a, n in rows)
    nbytes = 2 * ntok * HQ * D * q_el + 2 * kv_rows * HKV * D * c_el
    flops = 4.0 * pairs * HQ * D
    lmax = -(-max(lens) // bs) * bs
    idx = btt[:, : lmax // bs].long()
    kg = [gathered(kc, l, idx, 0, dtype) for l in range(layers)]
    vg = [gathered(kc, l, idx, 1, dtype) for l in range(layers)]
    qpos = qo.long()[:, None] + torch.arange(s, device=dev)[None, :]
    kvi = torch.arange(lmax, device=dev)
    mask = ((kvi[None, None, :] <= qpos[:, :, None])
            & (kvi[None, None, :] < kvl.long()[:, None, None]))[:, None]
    qt = q.transpose(1, 2)
    res.update(time_three(
        lambda i: k3.paged_attention_prefill_batched_ilv(q, kc, i % layers, *args),
        lambda i: k3.paged_attention_prefill_batched_ilv_plain(q, kc, i % layers, *args),
        lambda i: sdpa(qt, kg[i % layers], vg[i % layers], mask, scale),
        plain_iters=5,
    ))
    res["shape"] = (f"P={len(rows)} chunks of S={s} (q_offset, ntok) {rows}, Hq {HQ}, "
                    f"Hkv {HKV}, D {D}, bs {bs}")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


def phase_layouts(dev) -> dict:
    """K8 and K9 against their plain versions at qwen3-1.7B's shapes (Hq
    16, Hkv 8, D 128, bs 64), bf16 and f32 q, on each cache the layout
    serves (``ILV_CACHES``; f32 q on the f32 cache), with random and
    block-contiguous page tables and a window; the P-rounding grid checks
    at block_size 16, 32, 64 and 128; each kernel timed (bf16 q) on its
    layout's caches -> {kernel name: the bf16 cache's result, the others in
    ``by_cache``} (K8's prefill: K9's path, row-major tails, on the bf16
    cache; its other instances by "layout cache")."""
    rng = np.random.default_rng(7)
    g = torch.Generator(device=dev).manual_seed(30)
    timed: dict[str, dict] = {}  # name -> {instance: result}
    worst: dict[str, float] = {}

    def note(name, res):
        worst[name] = max(worst.get(name, 0.0), res["max_abs_err"])
        return res

    for rm in (False, True):
        layout = "interleaved_rm" if rm else "interleaved"
        for cache in ILV_CACHES[rm]:
            for dtype in (torch.bfloat16, torch.float32):
                t = dtype == torch.bfloat16
                name = ilv_name("decode", rm)
                res = note(name, check_ilv_decode(rng, dev, g, dtype, cache, rm,
                                                  lens=ILV_TIMED_LENS, timed=t))
                alt = note(name, check_ilv_decode(rng, dev, g, dtype, cache, rm, timed=t))
                if t:
                    res["by_shape"] = [dict(res), alt]
                    timed.setdefault(name, {})[cache or "bf16"] = res
                note(name, check_ilv_decode(rng, dev, g, dtype, cache, rm, contiguous=True,
                                            window=ILV_WINDOW))
                for rmw in (False, True):
                    name = ilv_name("rmw" if rmw else "prefill", rm)
                    for n, (s, rows) in enumerate(ILV_WRITES[rmw]):
                        res = note(name, check_ilv_writer(rng, dev, g, dtype, cache, rmw, rm,
                                                          s, rows, timed=t and n == 0))
                        if t and n == 0:
                            timed.setdefault(name, {})[cache or "bf16"] = res
                by_shape = []
                for n, (s, rows) in enumerate(ILV_PREFILL):
                    by_shape.append(note(k3.ILV_NAME, check_ilv_prefill(
                        rng, dev, g, dtype, cache, rm, s, rows, timed=t and n < 2)))
                if t:
                    res = dict(by_shape[0], by_shape=by_shape[:2])
                    timed.setdefault(k3.ILV_NAME, {})[f"{layout} {cache or 'bf16'}"] = res
                note(k3.ILV_NAME, check_ilv_prefill(rng, dev, g, dtype, cache, rm, PREFILL_S,
                                                    [(512, 300)], window=ILV_WINDOW))
                free_device_memory()
    # the P-rounding grid checks at every page size the kernels take
    for bs in PAGE_SIZES:
        for rm in (False, True):
            for dtype, cache in ((torch.bfloat16, None), (torch.bfloat16, "int8"),
                                 (torch.bfloat16, "fp8_e4m3"), (torch.float32, "fp8_e4m3")):
                if rm and cache == "int8":
                    continue
                for window in (0, ILV_WINDOW):
                    note(ilv_name("decode", rm), check_ilv_decode(
                        rng, dev, g, dtype, cache, rm, bs=bs, lens=PAGE_LENS, window=window))
                for s, rows in PAGE_ROWS.items():
                    note(k3.ILV_NAME, check_ilv_prefill(rng, dev, g, dtype, cache, rm, s, rows,
                                                        bs=bs))
            free_device_memory()
        # K9's RMW writer (one cluster a page) on each cache the layout serves
        for dtype, cache in ((torch.bfloat16, None), (torch.float32, None),
                             (torch.bfloat16, "fp8_e4m3"), (torch.float32, "fp8_e4m3")):
            note(ilv_name("rmw", True), check_ilv_writer(rng, dev, g, dtype, cache, True, True,
                                                         bs, rm_rmw_rows(bs), bs=bs))
    results = {}
    for name, by in timed.items():
        main = "interleaved_rm bf16" if name == k3.ILV_NAME else "bf16"
        res = dict(by[main], max_abs_err=worst[name],
                   by_cache={k: r for k, r in by.items() if k != main})
        results[name] = res
        log(f"[layouts] {name}: worst err {worst[name]:.3g} over every case ({ILV_TOL})")
        for inst, res_i in by.items():
            for r in res_i.get("by_shape", [res_i]):
                host = (f"; host {r['host_us']:.1f} us a call (K1 {r['host_us_k1']:.1f})"
                        if "host_us" in r else "")
                log(f"[layouts]   {inst} cache, {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}){host}")
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: the engines at full width
# ---------------------------------------------------------------------------
def engine_config(model_kw=QWEN3_1P7B, batch: int = 16,
                  num_blocks: int = 1024, quant: str = "",
                  kv_cache_dtype: str = "auto", kv_layout: str = "split") -> EngineConfig:
    """The served configuration: block_size 64, ``batch`` sequences,
    max_model_len 4096, prefill chunks of at most 2048 tokens, the split
    KV layout unless ``kv_layout``; ``quant`` and ``kv_cache_dtype`` for
    the quantized engines."""
    cfg = EngineConfig(
        model=ModelConfig(**model_kw),
        cache=CacheConfig(block_size=BS, num_blocks=num_blocks,
                          kv_cache_dtype=kv_cache_dtype, kv_layout=kv_layout),
        scheduler=SchedulerConfig(
            max_seqs_per_batch=batch,
            max_model_len=4096,
            max_tokens_per_chunk_for_prefill=2048,
            prefill_token_buckets=[64, 512, 2048],
            decode_batch_buckets=[batch],
        ),
        seed=0,
    )
    cfg.quant.method = quant
    return cfg


@contextlib.contextmanager
def environ(**kw):
    """Set environment variables for the duration of a phase."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def warm_up(eng: LLMEngine, rng) -> None:
    """Two short requests: first calls load CUDA modules and pick GEMM
    algorithms, which would otherwise land in the first measured step. A
    600-token prompt takes K2, K3 and K1, a 40-token prompt K4."""
    for n in (600, 40):
        eng.add_request(prompt_token_ids=rng.integers(1, 1000, n).tolist(),
                        sampling_params=SamplingParams(max_tokens=2, ignore_eos=True))
    eng.generate_all()


def count_per_pass(runner) -> list[tuple[str, int, dict]]:
    """Wrap the runner's model passes (one prefill group, one decode batch,
    one scored chunk, one embed request's final chunk) so that each appends
    ``(kind, rows, launch-count delta)`` to the list returned; ``rows`` is
    the token count of the pass's hidden state, the row count of each of
    its projections. The engine calls them through the instance, so the
    wrappers see every pass. A runner already wrapped keeps its wrappers;
    its list is emptied and returned."""
    if hasattr(runner, "pass_deltas"):
        del runner.pass_deltas[:]
        return runner.pass_deltas
    deltas: list[tuple[str, int, dict]] = []
    runner.pass_deltas = deltas
    model = runner.model
    rows = []
    run_layers = model._run_layers

    def seen_rows(x, *args, **kw):
        rows.append(x.shape[0])
        return run_layers(x, *args, **kw)

    model._run_layers = seen_rows

    def wrap(fn, kind):
        def counted(*args, **kw):
            before = dict(_build.launch_counts)
            rows.clear()
            out = fn(*args, **kw)
            assert len(rows) == 1, f"{kind} pass ran the layers {len(rows)} times"
            deltas.append((kind, rows[0], {k: v - before.get(k, 0)
                                           for k, v in _build.launch_counts.items()}))
            return out
        return counted

    runner.run_prefill_batched = wrap(runner.run_prefill_batched, "prefill")
    runner.run_decode = wrap(runner.run_decode, "decode")
    runner.run_score_chunk = wrap(runner.run_score_chunk, "score")
    runner.run_prefill_embed = wrap(runner.run_prefill_embed, "embed")
    return deltas


def pass_launches(layers: int, moe_layers: int, mla: bool, kind: str, rows: int,
                  qmm_name: str = "", qmm_max_rows: int = 0,
                  qmm_per_pass: int = 0, layout: str = "split",
                  decode_name: str = "") -> list[dict]:
    """The launches a model pass of ``kind`` over ``rows`` tokens must make
    (one of the dicts returned): a decode pass K1 (K11a in an MLA model)
    once per layer; a prefill pass K3 (K11b) once per layer and one of the
    two writers (K2 / K11c for a chunk bucket above block_size, K4 / K11d
    otherwise) once per layer; a score or embed pass (one chunk) K3b (K11e)
    once per layer and one of K2b / K4b (K11f / K11g) once per layer; in a
    MoE model each also K10 twice per MoE
    layer (gate_up and down); with ``qmm_name`` (K5, K6 or K7) that kernel
    ``qmm_per_pass`` times (once for each ``*_proj_w`` of the model: qkv, o,
    gate, up, down of a dense layer; q, kv_a, o of an MLA layer; the shared
    experts' three) if the pass has at most ``qmm_max_rows`` rows (0: in
    every pass), else not at all; nothing else. On an interleaved
    ``layout`` a decode pass launches K8 (K9 on ``interleaved_rm``) and
    every other pass, score and embed passes too, K8's prefill and one of
    the layout's two writers. ``decode_name``: the decode kernel that
    ``XLLM_DECODE_KERNEL`` selects, in place of the layout's default."""
    extra = {k10.NAME: 2 * moe_layers} if moe_layers else {}
    if qmm_name and (not qmm_max_rows or rows <= qmm_max_rows):
        extra[qmm_name] = qmm_per_pass
    decode, prefill, writers = (
        (k11.DECODE_NAME, k11.PREFILL_NAME, (k24.LATENT_PREFILL_NAME, k24.LATENT_RMW_NAME))
        if mla else (k1.NAME, k3.NAME, (k24.PREFILL_NAME, k24.RMW_NAME)))
    if kind in ("score", "embed"):
        prefill, writers = (
            (k11.ONE_PREFILL_NAME, (k24.ONE_LATENT_PREFILL_NAME, k24.ONE_LATENT_RMW_NAME))
            if mla else (k3.ONE_NAME, (k24.ONE_PREFILL_NAME, k24.ONE_RMW_NAME)))
    if layout != "split":
        rm = layout == "interleaved_rm"
        decode, prefill = ilv_name("decode", rm), k3.ILV_NAME
        writers = (ilv_name("prefill", rm), ilv_name("rmw", rm))
    if kind == "decode":
        return [{decode_name or decode: layers, **extra}]
    return [{prefill: layers, w: layers, **extra} for w in writers]


def check_passes(deltas, want) -> None:
    """Each pass's launches against ``want(kind, rows)``."""
    for i, (kind, rows, d) in enumerate(deltas):
        got = {k: n for k, n in d.items() if n}
        assert got in want(kind, rows), (
            f"{kind} pass {i} over {rows} rows: launches {got}, expected one of "
            f"{want(kind, rows)}")


# this slice's path in the engine phases: prompts scored and embedded
SCORE_LENS = (2100, 300)
EMBED_LENS = (40, 700)


def per_pass_summary(deltas, launches, want) -> dict:
    """Check each pass of a run against ``want`` and the run's counts
    against the passes: every kernel a pass of the run must launch was
    launched, the same number of times in each pass that launched it, and
    that times the passes is the run's count. -> {kernel: {launches_per_step,
    passes}}."""
    check_passes(deltas, want)
    per_pass = {}
    expected = {k: n for kind, rows, _ in deltas for d in want(kind, rows)
                for k, n in d.items()}
    for name, per in expected.items():
        assert launches.get(name, 0) > 0, f"kernel {name} never launched: {launches}"
        seen = sorted({d.get(name, 0) for _, _, d in deltas} - {0})
        passes = sum(1 for _, _, d in deltas if d.get(name, 0))
        assert seen == [per], f"{name}: launches per model pass {seen}, not [{per}]"
        assert passes * per == launches[name], (name, passes, launches[name])
        per_pass[name] = {"launches_per_step": seen[0], "passes": passes}
    return per_pass


def drive_scoring(eng: LLMEngine, rng, deltas, want, tag: str, score_lens,
                  embed_lens) -> tuple[dict, dict]:
    """Prompt scoring and embeddings on a served engine: ``score_prompt``
    over prompts of ``score_lens`` tokens, then embed requests of
    ``embed_lens`` tokens beside as many greedy requests. The counters are
    zeroed just before and read just after; every model pass of the run is
    checked (``pass_launches``: each score or embed pass K3b / K11e and one
    single-chunk writer once per layer, no K1-K4 or K11a-d). -> (launches,
    info)."""
    cfg = eng.config
    vocab = cfg.model.vocab_size
    eng.score_prompt(rng.integers(1, vocab, 100).tolist())  # first calls, uncounted
    scored = [rng.integers(1, vocab, n).tolist() for n in score_lens]
    embeds = [rng.integers(1, vocab, n).tolist() for n in embed_lens]
    greedy = [rng.integers(1, vocab, n).tolist() for n in embed_lens]
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    del deltas[:]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lps = [eng.score_prompt(p) for p in scored]
    t_score = time.perf_counter() - t0
    t0 = time.perf_counter()
    eids = [eng.add_request(prompt_token_ids=p, embed=True).request_id for p in embeds]
    gids = [eng.add_request(prompt_token_ids=p, sampling_params=sp).request_id
            for p in greedy]
    outs, t_embed = {}, 0.0
    while eng.has_unfinished():
        for ro in eng.step():
            if ro.finished:
                outs[ro.request_id] = ro
                if ro.request_id in eids:
                    t_embed = time.perf_counter() - t0
    sync()
    launches = dict(_build.launch_counts)
    for p, lp in zip(scored, lps):
        assert lp.shape == (len(p) - 1,) and np.isfinite(lp).all() and (lp < 1e-4).all(), tag
    for i in eids:
        v = np.asarray(outs[i].embedding)
        assert v.shape == (cfg.model.hidden_size,) and np.isfinite(v).all(), tag
        assert abs(np.linalg.norm(v) - 1.0) < 1e-4, f"{tag}: embedding norm {np.linalg.norm(v)}"
    for i in gids:
        assert len(outs[i].outputs[0].token_ids) == 8, tag
    assert eng.block_manager.num_used_blocks == 0, "KV blocks leaked"
    per_pass = per_pass_summary(deltas, launches, want)
    info = {
        "score_prompt_lens": list(score_lens),
        "score_s": t_score,
        "scored_tok_per_s": sum(score_lens) / t_score,
        "embed_prompt_lens": list(embed_lens),
        "embed_s": t_embed,
        "embeddings_per_s": len(embeds) / t_embed if embeds else None,
        "launches": launches,
        "per_pass": per_pass,
    }
    rate = (f"; {len(embeds)} embed requests beside {len(greedy)} greedy ones done in "
            f"{t_embed:.3f} s ({info['embeddings_per_s']:.1f} embeddings/s)" if embeds else "")
    log(f"[{tag}] scored prompts of {list(score_lens)} tokens in {t_score:.3f} s "
        f"({info['scored_tok_per_s']:.1f} scored tok/s, synchronous){rate}; "
        f"{card_line()}; launches {launches}; {len(deltas)} model passes, per kernel "
        f"{per_pass}")
    return launches, info


def phase_engine(model_kw=QWEN3_1P7B, num_blocks: int = 1024,
                 tag: str = "engine", quant: str = "", kv_cache_dtype: str = "auto",
                 qmm_name: str = "", qmm_max_rows: int = 0, score_lens=(),
                 embed_lens=(), kv_layout: str = "split",
                 resolved: str = "", engine: LLMEngine | None = None,
                 decode_name: str = "", seed: int = 0) -> tuple[dict, dict]:
    """Serve ``model_kw`` on the card (see the module docstring); with
    ``qmm_name`` every model pass must also launch that kernel once per
    ``*_proj_w`` of the model (``pass_launches``). Then, with ``score_lens``, score prompts
    and embed (``drive_scoring``): ``info["score"]`` holds that run's
    (launches, info). ``kv_layout`` is asked for; the runner must resolve
    it to ``resolved`` (default: itself). ``engine``: serve on this engine
    (built from ``model_kw`` and the rest) instead of a new one;
    ``decode_name``: the decode kernel every decode pass must launch, in
    place of the layout's default (``XLLM_DECODE_KERNEL``); ``seed``: of the
    prompts (another than an earlier run's on the same engine, whose
    prefix cache would otherwise serve them)."""
    t0 = time.perf_counter()
    eng = engine or LLMEngine(engine_config(model_kw, num_blocks=num_blocks, quant=quant,
                                            kv_cache_dtype=kv_cache_dtype,
                                            kv_layout=kv_layout), device="cuda")
    cfg = eng.config
    sync()
    layout = eng.runner.model.kv_layout
    assert layout == (resolved or kv_layout), f"{tag}: kv_layout resolved to {layout}"
    if engine is None:
        log(f"[{tag}] {model_kw['model_type']}, {model_kw['num_hidden_layers']} layers, "
            f"hidden {model_kw['hidden_size']}, {model_kw.get('num_experts', 0)} experts, "
            f"{model_kw['dtype']}, weights {quant or model_kw['dtype']} (random), KV cache "
            f"{kv_cache_dtype}, {num_blocks} KV blocks, {layout} layout (asked for "
            f"{kv_layout}): built in "
            f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} "
            "GiB allocated")
    rng = np.random.default_rng(seed)
    warm_up(eng, rng)  # before the counters are zeroed
    # 40 -> K4; 300, 700 -> K2; 2100 -> chunks of 2048 (K2) + 52 (K4, K3 at
    # q_offset 2048 over the first chunk's 32 pages)
    lens = [40, 300, 700, 2100] * 4
    prompts = [rng.integers(1, cfg.model.vocab_size, n).tolist() for n in lens]
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)

    deltas = count_per_pass(eng.runner)
    _build.reset_launch_counts()
    t_submit = time.perf_counter()
    reqs = [eng.add_request(prompt_token_ids=p, sampling_params=sp) for p in prompts]
    first: dict[str, float] = {}
    done: dict[str, list[int]] = {}
    steps = 0
    while eng.has_unfinished():
        for ro in eng.step():
            now = time.perf_counter()
            if ro.outputs[0].token_ids and ro.request_id not in first:
                first[ro.request_id] = now - t_submit
            if ro.finished:
                done[ro.request_id] = ro.outputs[0].token_ids
        steps += 1
    sync()
    t_all = time.perf_counter() - t_submit
    launches = dict(_build.launch_counts)

    assert len(done) == len(reqs), f"{len(done)} of {len(reqs)} requests finished"
    for r in reqs:
        toks = done[r.request_id]
        assert len(toks) == 32, f"{r.request_id}: {len(toks)} tokens"
        assert all(0 <= t < cfg.model.vocab_size for t in toks)
    assert eng.block_manager.num_used_blocks == 0, "KV blocks leaked"
    # every model pass launches the kernels it uses once per layer (K10
    # twice per MoE layer)
    layers = cfg.model.num_hidden_layers
    moe_layers = (layers - cfg.model.first_k_dense_replace) if cfg.model.num_experts else 0
    mla = cfg.model.kv_lora_rank > 0
    projections = sum(1 for n, _ in eng.runner.model.named_parameters()
                      if n.endswith("_proj_w"))

    def want(kind, rows):
        return pass_launches(layers, moe_layers, mla, kind, rows, qmm_name=qmm_name,
                             qmm_max_rows=qmm_max_rows, qmm_per_pass=projections,
                             layout=layout, decode_name=decode_name)

    per_pass = per_pass_summary(deltas, launches, want)
    if qmm_max_rows:  # the passes that take torch's product, by their rows
        per_pass[qmm_name]["passes_over_max_rows"] = sorted(
            rows for _, rows, d in deltas if not d.get(qmm_name, 0))
    ttft = sorted(first.values())
    gen = 32 * len(reqs)
    info = {
        "model": model_kw["model_type"],
        "quant": quant,
        "kv_cache_dtype": kv_cache_dtype,
        "kv_layout": layout,
        "layers": layers,
        "requests": len(reqs),
        "prompt_lens": sorted(set(lens)),
        "engine_steps": steps,
        "wall_s": t_all,
        "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "gen_tok_per_s": gen / t_all,
        "launches": launches,
        "per_pass": per_pass,
    }
    log(f"[{tag}] {len(reqs)} requests x 32 tokens in {steps} steps, {t_all:.2f} s; "
        f"TTFT median {info['ttft_s_median'] * 1e3:.1f} ms, max {ttft[-1] * 1e3:.1f} ms; "
        f"{info['gen_tok_per_s']:.1f} generated tok/s overall (eager, no CUDA graphs); "
        f"launches {launches}; {len(deltas)} model passes, per kernel {per_pass}")
    if score_lens:
        info["score"] = drive_scoring(eng, rng, deltas, want, tag, score_lens, embed_lens)
    return launches, info


# ---------------------------------------------------------------------------
# phase 5: card vs CPU parity
# ---------------------------------------------------------------------------
PARITY_DENSE = dict(model_type="qwen3", dtype="float32", vocab_size=1000,
                    hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                    qk_norm=True, max_position_embeddings=256, eos_token_ids=[0])
_PARITY_EXPERTS = dict(num_experts=8, num_experts_per_tok=2,
                       moe_intermediate_size=64, norm_topk_prob=True)
PARITY_MODELS = {
    "qwen3": PARITY_DENSE,
    "qwen3_moe": dict(PARITY_DENSE, model_type="qwen3_moe", **_PARITY_EXPERTS),
    # sigmoid routing with a (non-zero) correction bias and group-limited
    # top-k, a shared expert, a dense first layer, partial rotate-half rope
    "glm4_moe": dict(PARITY_DENSE, model_type="glm4_moe", attention_bias=True,
                     partial_rotary_factor=0.5, rope_interleaved=False,
                     scoring_func="sigmoid", n_group=2, topk_group=1,
                     routed_scaling_factor=1.5, first_k_dense_replace=1,
                     n_shared_experts=1, **_PARITY_EXPERTS),
}
# MLA: f32 latents through K11's FMA instances (the bf16 instances run in
# the kernel and MLA engine phases)
_PARITY_MLA = dict(PARITY_DENSE, num_key_value_heads=4, qk_nope_head_dim=32,
                   qk_rope_head_dim=16, v_head_dim=32, first_k_dense_replace=1,
                   **_PARITY_EXPERTS)
PARITY_MODELS.update({
    # q_lora_rank 0, YaRN, two shared experts, a dense first layer; latent
    # rows of 128 + 16 lanes, padded to 256 (dk_pad != dk)
    "deepseek_v2": dict(_PARITY_MLA, model_type="deepseek_v2", kv_lora_rank=128,
                        n_shared_experts=2, rope_scaling=DEEPSEEK_V2_LITE["rope_scaling"]),
    # q_lora_rank > 0, sigmoid routing with a non-zero bias, two groups,
    # routed_scaling_factor 2.5
    "deepseek_v3": dict(_PARITY_MLA, model_type="deepseek_v3", q_lora_rank=64,
                        kv_lora_rank=64, n_shared_experts=1, scoring_func="sigmoid",
                        n_group=2, topk_group=1, routed_scaling_factor=2.5),
    # rotate-half rope on the rope dims
    "glm4_moe_lite": dict(_PARITY_MLA, model_type="glm4_moe_lite", q_lora_rank=64,
                          kv_lora_rank=64, n_shared_experts=1, scoring_func="sigmoid",
                          routed_scaling_factor=1.8),
})


# the row-major tail layout needs 16 | 2 * Hkv and 2 * Hkv | block_size
# (else it resolves to plain interleaved): Hkv 8 at block_size 16
PARITY_RM = dict(PARITY_DENSE, num_attention_heads=16, num_key_value_heads=8)

# parity of scoring and embeddings (block_size 16, chunks of 64, buckets
# 16 and 64): scores of 70 tokens (64 + 6: K2b / K11f, then K4b / K11g), 40
# and 10; embeds of 100 (a batched first chunk, then 36 tokens at q_offset
# 64) and 10; card and CPU within PARITY_SCORE_TOL
SCORE_PARITY = {"score": (70, 40, 10), "embed": (100, 10)}
PARITY_SCORE_TOL = 1e-4


def parity_config(model_kw: dict, quant: str = "", kv_cache_dtype: str = "auto",
                  kv_layout: str = "split"):
    cfg = EngineConfig(
        model=ModelConfig(**model_kw),
        cache=CacheConfig(block_size=16, num_blocks=128, kv_cache_dtype=kv_cache_dtype,
                          kv_layout=kv_layout),
        scheduler=SchedulerConfig(max_seqs_per_batch=4, max_model_len=256,
                                  max_tokens_per_chunk_for_prefill=64,
                                  prefill_token_buckets=[16, 64],
                                  decode_batch_buckets=[2, 4]),
    )
    cfg.quant.method = quant
    return cfg


def phase_async(model_kw: dict = PARITY_DENSE) -> None:
    """``AsyncLLMEngine`` on the card: three greedy requests, an embed
    request and ``call("score_prompt")`` submitted together give what each
    gives alone on an engine with the same weights (tokens equal; scores
    and the embedding within 1e-6: the same kernels at the same shapes)."""
    cfg = parity_config(model_kw)
    tree = random_param_tree(cfg.model, seed=7)
    rng = np.random.default_rng(3)
    gen = [rng.integers(1, 1000, n).tolist() for n in (10, 40, 100)]
    emb = rng.integers(1, 1000, 70).tolist()
    scored = rng.integers(1, 1000, 90).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)

    def engine():
        runner = ModelRunner(cfg, device="cuda")
        runner.load_model(params=tree)
        return LLMEngine(cfg, runner=runner)

    eng = engine()
    alone = []
    for p in gen:
        eng.add_request(prompt_token_ids=p, sampling_params=sp)
        alone.append(eng.generate_all()[0].outputs[0].token_ids)
    eng.add_request(prompt_token_ids=emb, embed=True)
    alone_emb = np.asarray(eng.generate_all()[0].embedding)
    alone_lp = eng.score_prompt(scored)
    aeng = AsyncLLMEngine(cfg, engine=engine())
    aeng.start()

    async def last(agen):
        out = None
        async for out in agen:
            pass
        return out

    async def together():
        return await asyncio.gather(
            *(last(aeng.generate(prompt_token_ids=p, sampling_params=sp)) for p in gen),
            last(aeng.generate(prompt_token_ids=emb, embed=True)),
            aeng.call("score_prompt", scored))

    t0 = time.perf_counter()
    try:
        *outs, emb_out, lp = asyncio.run(together())
    finally:
        aeng.stop()
    assert [o.outputs[0].token_ids for o in outs] == alone, "async generate differs"
    err = max(float(np.abs(np.asarray(emb_out.embedding) - alone_emb).max()),
              float(np.abs(lp - alone_lp).max()))
    assert err <= 1e-6, f"async embed / score differ from alone by {err}"
    assert aeng.engine.block_manager.num_used_blocks == 0
    log(f"[async] AsyncLLMEngine on the card: {len(gen)} greedy requests, an embed request "
        f"and a score call together in {time.perf_counter() - t0:.2f} s equal each alone "
        f"(max abs diff {err:.3g})")


def parity_scores(eng: LLMEngine, rng_seed: int = 2) -> tuple[list, list]:
    """The ``SCORE_PARITY`` requests on ``eng`` -> (logprobs, embeddings)."""
    rng = np.random.default_rng(rng_seed)
    vocab = eng.config.model.vocab_size
    lps = [eng.score_prompt(rng.integers(1, vocab, n).tolist())
           for n in SCORE_PARITY["score"]]
    ids = [eng.add_request(prompt_token_ids=rng.integers(1, vocab, n).tolist(),
                           embed=True).request_id for n in SCORE_PARITY["embed"]]
    outs = {ro.request_id: ro.embedding for ro in eng.generate_all()}
    assert eng.block_manager.num_used_blocks == 0
    return lps, [np.asarray(outs[i]) for i in ids]


def phase_parity(name: str, model_kw: dict, devices=("cuda", "cpu"), quant: str = "",
                 kv_cache_dtype: str = "auto", scores: bool = False,
                 kv_layout: str = "split", resolved: str = "") -> int:
    """Greedy tokens of the card equal the CPU's; with ``scores`` also the
    scores and embeddings of ``SCORE_PARITY``, within ``PARITY_SCORE_TOL``.
    ``kv_layout`` is asked for and must resolve to ``resolved`` (default:
    itself) on both devices."""
    def make():
        return parity_config(model_kw, quant, kv_cache_dtype, kv_layout)

    tree = random_param_tree(make().model, seed=7)
    rng = np.random.default_rng(1)
    for group in tree.values():  # random_param_tree's biases are zeros
        if isinstance(group, dict):
            for key in ("router_bias", "qkv_proj_b"):
                if key in group:
                    group[key] = (rng.standard_normal(group[key].shape) * 0.5).astype(np.float32)
    # 10 and 70 -> S <= bs chunks (K4); 40, 100 -> K2, 100 chunked at 64
    prompts = [rng.integers(1, 1000, n).tolist() for n in (10, 40, 100, 70, 23, 5)]
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    got, scored = {}, {}
    for dev in devices:
        cfg = make()
        runner = ModelRunner(cfg, device=dev)
        runner.load_model(params=tree)
        eng = LLMEngine(cfg, runner=runner)
        assert runner.model.kv_layout == (resolved or kv_layout), (
            f"{name}: kv_layout {kv_layout} resolved to {runner.model.kv_layout}")
        ids = [eng.add_request(prompt_token_ids=p, sampling_params=sp).request_id
               for p in prompts]
        outs = {ro.request_id: ro.outputs[0].token_ids for ro in eng.generate_all()}
        assert eng.block_manager.num_used_blocks == 0
        got[dev] = [outs[i] for i in ids]
        if scores:
            scored[dev] = parity_scores(eng)
    a, b = (got[d] for d in devices)
    assert a == b, f"{name}: greedy tokens differ:\n{a}\n{b}"
    if scores:
        errs = []
        for x, y in zip(*(scored[d][0] + scored[d][1] for d in devices)):
            assert x.shape == y.shape
            errs.append(float(np.abs(x - y).max()))
        assert max(errs) <= PARITY_SCORE_TOL, f"{name}: scores / embeddings differ by {errs}"
        log(f"[parity] f32 {name}: scores of {SCORE_PARITY['score']} tokens and embeddings "
            f"of {SCORE_PARITY['embed']} on {' and '.join(devices)} within "
            f"{PARITY_SCORE_TOL:g} (max abs diff {max(errs):.3g})")
    log(f"[parity] f32 {name} (2 layers, bs 16{', ' + quant + ' weights' if quant else ''}"
        f"{', ' + kv_cache_dtype + ' KV' if kv_cache_dtype != 'auto' else ''}"
        f"{', ' + (resolved or kv_layout) + ' layout' if kv_layout != 'split' else ''}): "
        f"{len(prompts)} requests x 16 greedy tokens identical on {' and '.join(devices)}")
    return len(prompts)


def free_device_memory() -> None:
    """Drop what a finished phase left (engines hold reference cycles)."""
    gc.collect()
    torch.cuda.empty_cache()


PHASES = ("build", "kernels", "qkernels", "engines", "quant", "parity", "layouts",
          "layout-engines", "grammar", "grammar-engines")


def phase_layout_parity() -> None:
    """Card = CPU greedy tokens on the interleaved layouts, each run
    asserting the layout it resolved: qwen3 at Hkv 8 on interleaved_rm
    and on interleaved; qwen3_moe asking for interleaved_rm, which its Hkv
    2 resolves to interleaved (both rm runs: scores and embeddings too,
    within ``PARITY_SCORE_TOL``); qwen3 with
    int8 weights and an int8 KV cache on interleaved under
    ``XLLM_QMM_KERNEL=pallas``; qwen3 at Hkv 8 with an fp8 KV cache on
    interleaved_rm."""
    phase_parity("qwen3", PARITY_RM, kv_layout="interleaved_rm", scores=True)
    phase_parity("qwen3", PARITY_RM, kv_layout="interleaved")
    phase_parity("qwen3_moe", PARITY_MODELS["qwen3_moe"], kv_layout="interleaved_rm",
                 resolved="interleaved", scores=True)
    with environ(XLLM_QMM_KERNEL="pallas"):
        phase_parity("qwen3", PARITY_DENSE, quant="int8", kv_cache_dtype="int8",
                     kv_layout="interleaved")
    phase_parity("qwen3", PARITY_RM, kv_cache_dtype="fp8_e4m3", kv_layout="interleaved_rm")


# ---------------------------------------------------------------------------
# K1b and K12: the decode-kernel grammar (XLLM_DECODE_KERNEL)
# ---------------------------------------------------------------------------
# the names the qwen3-1.7B engine serves under on the split layout (K1b,
# K12a-g, a K1 tile instance), and on each interleaved layout (K8's and
# K9's tile instances)
GRAMMAR_NAMES = ("v5", "v1", "v3", "v4", "v6", "v7", "v8c2", "v10t2", "v9t2")
GRAMMAR_ILV = (("interleaved", "v11t2"), ("interleaved_rm", "v12t2"))
# the instances held to their plain versions: those, and K1 at a tile of 3
# pages (48 positions at bs 16: neither a divisor nor a multiple of the
# 64-position tile)
GRAMMAR_CHECKS = ([(n, "split") for n in GRAMMAR_NAMES + ("v9t3",)]
                  + [(n, layout) for layout, n in GRAMMAR_ILV])
GRAMMAR_CACHES = ((torch.bfloat16, None), (torch.bfloat16, "int8"),
                  (torch.bfloat16, "fp8_e4m3"), (torch.float32, None),
                  (torch.float32, "fp8_e4m3"))
GRAMMAR_WINDOW = 37


def grammar_fns(kver: str, layout: str):
    """``XLLM_DECODE_KERNEL=kver`` on ``layout``, as the dispatch resolves it
    -> (kernel, plain, tile, counter name)."""
    fn, tile = attention.resolve_decode_kernel(kver, layout, 0)
    if layout == "split":
        return fn, fn.plain, tile, fn.name
    rm = layout == "interleaved_rm"
    kernel, plain = ilv_decode_fns(rm)
    return kernel, plain, tile, ilv_name("decode", rm)


def check_grammar_split(rng, dev, g, kver, dtype, cache, bs: int = BS, lens=PAGE_LENS,
                        window: int = 0, timed: bool = False) -> dict:
    """A split-layout instance of the grammar against its plain version on
    grid inputs within ``TOL`` at every output, after three launches in a
    row (the split counters re-arm; the writes repeat), caches byte-equal,
    padded rows zeros; ``timed``: then timed at K1's shapes beside its plain
    version and SDPA."""
    kernel, plain, tile, name = grammar_fns(kver, "split")
    nbmax = 4096 // bs
    bt, nb = _paged(rng, lens, bs, nbmax)
    layers = LAYERS if timed else 2
    shape = (layers, nb, HKV, bs, D)
    kc, vc = grid_tensor(g, dev, shape, dtype, cache), grid_values(g, dev, shape, dtype, cache)
    b = len(lens)
    new = "int8" if cache == "int8" else None
    q = grid_tensor(g, dev, (b, HQ, D), dtype)
    kn = grid_tensor(g, dev, (b, HKV, D), dtype, new)
    vn = grid_values(g, dev, (b, HKV, D), dtype, new)
    sm = i32([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
              for i, n in enumerate(lens)], dev)
    btt, sl, scale = i32(bt, dev), i32(lens, dev), grid_scale(cache)
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    for _ in range(3):
        out = kernel(q, kn, vn, kk, vk, 1, sm, btt, sl, scale, window, tile)
    ref = plain(q, kn, vn, kp, vp, 1, sm, btt, sl, scale, window, tile)
    sync()
    what = f"{name} ({kver}) {dtype} cache {cache or dtype} bs {bs} window {window}"
    err = check_close(out, ref, what)
    assert same_bytes(kk, kp) and same_bytes(vk, vp), f"{what}: caches differ"
    assert not out[[i for i, n in enumerate(lens) if not n]].float().abs().any(), (
        f"{what}: padded rows must be zeros")
    res = {"max_abs_err": err}
    if not timed:
        return res
    q_el, c_el, n_el = q.element_size(), kc.element_size(), kn.element_size()
    live = [n for n in lens if n]
    nbytes = (2 * b * HQ * D * q_el + 2 * len(live) * HKV * D * (n_el + c_el)
              + 2 * sum(n - 1 for n in live) * HKV * D * c_el)
    flops = 4.0 * sum(live) * HQ * D
    lmax = -(-max(lens) // bs) * bs
    idx = btt[:, : lmax // bs].long()
    kg = [kc[l][idx].permute(0, 2, 1, 3, 4).reshape(b, HKV, lmax, D).to(dtype)
          for l in range(layers)]
    vg = [vc[l][idx].permute(0, 2, 1, 3, 4).reshape(b, HKV, lmax, D).to(dtype)
          for l in range(layers)]
    mask = (torch.arange(lmax, device=dev)[None, :] < sl[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    res.update(time_three(
        lambda i: kernel(q, kn, vn, kc, vc, i % layers, sm, btt, sl, scale, 0, tile),
        lambda i: plain(q, kn, vn, kc, vc, i % layers, sm, btt, sl, scale, 0, tile),
        lambda i: sdpa(q4, kg[i % layers], vg[i % layers], mask, scale),
        plain_iters=10,
    ))
    res["shape"] = (f"B={b} ({b - len(live)} padded), seq_lens {sorted(set(live))}, Hq {HQ}, "
                    f"Hkv {HKV}, D {D}, bs {bs}, grid inputs")
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    return res


def check_backend_settings(dev) -> None:
    """The dispatch's backend rules on the card (fault F5): at head_dim 64,
    and under ``XLLM_ATTENTION_BACKEND=ref`` at 128, decode and prefill
    launch no kernel and compute JAX's portable function (``attention_ref``
    over the scattered caches, bit for bit: the same PyTorch ops); under
    ``interpret`` a CUDA tensor raises ValueError."""
    g = torch.Generator(device=dev).manual_seed(41)
    rng = np.random.default_rng(9)
    lens = [1, 100, 700, 0]
    bt, nb = _paged(rng, lens, BS, 16)
    sm = i32([bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0
              for i, n in enumerate(lens)], dev)
    btt, sl = i32(bt, dev), i32(lens, dev)
    for d, env in ((64, {}), (128, {"XLLM_ATTENTION_BACKEND": "ref"})):
        shape = (2, nb, HKV, BS, d)
        kc, vc = grid_tensor(g, dev, shape, torch.bfloat16), grid_values(g, dev, shape,
                                                                         torch.bfloat16)
        q = grid_tensor(g, dev, (len(lens), HQ, d), torch.bfloat16)
        kn = grid_tensor(g, dev, (len(lens), HKV, d), torch.bfloat16)
        vn = grid_values(g, dev, (len(lens), HKV, d), torch.bfloat16)
        kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        _build.reset_launch_counts()
        with environ(**env):
            out, _, _ = attention.decode_attention_write(q, kn, vn, kk, vk, 1, sm, btt, sl,
                                                         grid_scale())
            qp = grid_tensor(g, dev, (1, 2 * BS, HQ, d), torch.bfloat16)
            knp = grid_tensor(g, dev, (1, 2 * BS, HKV, d), torch.bfloat16)
            smp = i32([[bt[2, j // BS] * BS + j % BS for j in range(2 * BS)]], dev)
            attention.prefill_attention_write_batched(
                qp, knp, knp, kk, vk, 1, smp, btt[2:3], i32([0], dev), i32([2 * BS], dev),
                grid_scale())
        sync()
        assert not any(_build.launch_counts.values()), (d, env, _build.launch_counts)
        write_kv(kp, vp, 1, kn, vn, sm)
        ref = attention_ref.paged_attention_decode_ref(q, kp, vp, 1, btt, sl, grid_scale())
        assert torch.equal(out, ref), f"head_dim {d} {env}: not the portable function"
    q = grid_tensor(g, dev, (len(lens), HQ, D), torch.bfloat16)
    with environ(XLLM_ATTENTION_BACKEND="interpret"):
        try:
            attention.decode_attention_write(q, q[:, :HKV], q[:, :HKV], kc, vc, 1, sm, btt,
                                             sl, 1.0)
        except ValueError as e:
            assert "XLLM_ATTENTION_BACKEND=interpret" in str(e)
        else:
            raise AssertionError("interpret on a CUDA tensor did not raise")


def phase_grammar(dev) -> dict:
    """K1b, K12a-g and the tile instances of K1, K8 and K9 (``GRAMMAR_CHECKS``)
    against their plain versions at qwen3-1.7B's heads, at block_size 16,
    32, 64 and 128, on bf16, int8 and fp8 caches (bf16 q) and f32 and fp8
    ones (f32 q), with and without a window (v1 takes none), padded rows and
    seq_len 1; each timed at K1's shapes, K1 (v9t4) too in the same call;
    then the backend rules (F5) -> {XLLM_DECODE_KERNEL name: result}."""
    rng = np.random.default_rng(8)
    g = torch.Generator(device=dev).manual_seed(40)
    results = {}
    for kver, layout in GRAMMAR_CHECKS + [("v9t4", "split")]:
        _, _, tile, name = grammar_fns(kver, layout)
        worst = 0.0
        for bs in PAGE_SIZES if kver != "v9t4" else ():
            for dtype, cache in GRAMMAR_CACHES:
                if layout == "interleaved_rm" and cache == "int8":
                    continue  # an int8 cache resolves rm to interleaved
                for window in (0,) if kver == "v1" else (0, GRAMMAR_WINDOW):
                    if layout == "split":
                        r = check_grammar_split(rng, dev, g, kver, dtype, cache, bs,
                                                window=window)
                    else:
                        r = check_ilv_decode(rng, dev, g, dtype, cache,
                                             layout == "interleaved_rm", bs=bs,
                                             lens=PAGE_LENS, window=window, tile=tile)
                    worst = max(worst, r["max_abs_err"])
            free_device_memory()
        if layout == "split":
            res = check_grammar_split(rng, dev, g, kver, torch.bfloat16, None,
                                      lens=ILV_TIMED_LENS, timed=True)
        else:
            res = check_ilv_decode(rng, dev, g, torch.bfloat16, None,
                                   layout == "interleaved_rm", lens=ILV_TIMED_LENS,
                                   timed=True, tile=tile)
        res.update(max_abs_err=max(worst, res["max_abs_err"]), counter=name, tile=tile,
                   layout=layout)
        results[kver] = res
        log(f"[grammar] {kver} on {layout}: {name}, tile {tile}; worst err {worst:.3g} "
            f"at block_size {PAGE_SIZES} ({GRID_TOL}; caches byte-equal); {res['shape']}: "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, SDPA "
            f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        free_device_memory()
    check_backend_settings(dev)
    log("[grammar] head_dim 64, and XLLM_ATTENTION_BACKEND=ref at 128: no kernel launched, "
        "JAX's portable function bit for bit; interpret on a CUDA tensor raises ValueError")
    return results


def phase_grammar_engines() -> dict:
    """The qwen3-1.7B engine at full width and depth serves 16 greedy
    requests x 32 tokens under each name of ``GRAMMAR_NAMES`` (one engine,
    the variable switched between runs) and, on an engine of each
    interleaved layout, under its ``GRAMMAR_ILV`` name: every decode pass
    launches that name's kernel once per layer and no other decode kernel
    (K1 only under v9*). Then card = CPU greedy tokens on the f32 parity
    qwen3 under each name, and at head_dim 64, where no attention kernel
    may launch (F5) -> {name: (launches, info)}."""
    runs = {}
    for layout, names in (("split", GRAMMAR_NAMES),) + tuple((l, (n,)) for l, n in GRAMMAR_ILV):
        eng = LLMEngine(engine_config(kv_layout=layout), device="cuda")
        for seed, kver in enumerate(names):
            with environ(XLLM_DECODE_KERNEL=kver):
                runs[kver] = phase_engine(tag=f"grammar {kver}", kv_layout=layout, engine=eng,
                                          decode_name=grammar_fns(kver, layout)[3], seed=seed)
        del eng
        free_device_memory()
    for kver, layout in [(n, "split") for n in GRAMMAR_NAMES] + [
            (n, layout) for layout, n in GRAMMAR_ILV]:
        with environ(XLLM_DECODE_KERNEL=kver):
            phase_parity("qwen3", PARITY_DENSE if layout == "split" else PARITY_RM,
                         kv_layout=layout)
        log(f"[grammar] parity above: XLLM_DECODE_KERNEL={kver} on {layout}")
    # F5: at head_dim 64 the engine runs JAX's portable attention (a dense
    # f32 model launches no other kernel)
    _build.reset_launch_counts()
    phase_parity("qwen3", dict(PARITY_DENSE, head_dim=64))
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    assert not launched, f"head_dim 64 launched kernels {launched}"
    log("[grammar] parity above: head_dim 64, no attention kernel or cache writer "
        "launched on the card")
    return runs


def grammar_rows(gram: dict, runs: dict, rows: list) -> list[dict]:
    """The kernels line's rows of K1b and K12a-g, each with its launches
    from its own engine run (counters zeroed just before it); the tile
    instances of K1, K8 and K9 join those kernels' rows as ``by_tile``."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_name = {r["name"]: r for r in rows}
    new = []
    for kver, res in gram.items():
        name = res["counter"]
        launches, info = runs.get(kver, ({}, {"per_pass": {}}))
        inst = {k: res[k] for k in keys}
        if kver in runs:
            inst.update(launches=launches[name],
                        launches_per_step=info["per_pass"][name]["launches_per_step"],
                        passes=info["per_pass"][name]["passes"])
        if name in by_name:  # K1 / K8 / K9 at another tile (v9t4: K1 in this call)
            by_name[name].setdefault("by_tile", {})[kver] = inst
            continue
        fn = grammar_fns(kver, "split")[0]
        where, func = fn.tpu_kernel.split()
        new.append({"name": name, "route": "cuda",
                    "source": "xllm_tpu_torch/csrc/decode_attention.cu", "replaces": where,
                    "tpu_counterpart": func, "decode_kernel": kver, "mode": fn.mode,
                    "rounding_tile_pages": fn.pages or res["tile"], "library": "SDPA",
                    **inst})
    return new


def timed_phase(label: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    free_device_memory()
    log(f"[{label}] done in {time.perf_counter() - t0:.1f} s")
    return out


def ilv_rows(ilv: dict, runs: dict, keys) -> list[dict]:
    """The kernels line's rows of K8 and K9: times from ``phase_layouts``,
    launches from the run of each one's engine path, counters zeroed just
    before it: K9's (and K8's prefill) the qwen3-1.7B engine on
    interleaved_rm, K8's decode and writers the int8 Qwen3-8B engine, which
    interleaved_rm resolves to interleaved (its int8 instances)."""
    meta = {
        k1.ILV_NAME: (k1.ILV_TPU_KERNEL, "decode_attention.cu", "int8_ilv"),
        k1.RM_NAME: (k1.RM_TPU_KERNEL, "decode_attention.cu", "rm"),
        k24.ILV_PREFILL_NAME: (k24.ILV_PREFILL_TPU_KERNEL, "kv_write.cu", "int8_ilv"),
        k24.ILV_RMW_NAME: (k24.ILV_RMW_TPU_KERNEL, "kv_write.cu", "int8_ilv"),
        k24.RM_PREFILL_NAME: (k24.RM_PREFILL_TPU_KERNEL, "kv_write.cu", "rm"),
        k24.RM_RMW_NAME: (k24.RM_RMW_TPU_KERNEL, "kv_write.cu", "rm"),
        k3.ILV_NAME: (k3.ILV_TPU_KERNEL, "prefill_attention.cu", "rm"),
    }
    rows = []
    for name, res in ilv.items():
        tpu, src, run = meta[name]
        where, func = tpu.split()
        launches, info = runs[run]
        row = {
            "name": name,
            "route": "cuda",
            "source": f"xllm_tpu_torch/csrc/{src}",
            "replaces": where,
            "tpu_counterpart": func,
            "launches": launches[name],
            "launches_engine": info["model"] + ("-int8-interleaved" if run == "int8_ilv"
                                                else "-interleaved_rm"),
            "launches_per_step": info["per_pass"][name]["launches_per_step"],
            "passes": info["per_pass"][name]["passes"],
            "launches_score_run": info["score"][0].get(name, 0),
            **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape")},
            **{k: res[k] for k in ("host_us", "host_us_k1") if k in res},
            "library": "SDPA" if "attention" in name else "index assign",
            "by_cache": {inst: dict({k: r[k] for k in keys if k in r},
                                    **({"by_shape": [{k: x[k] for k in keys if k in x}
                                                     for x in r["by_shape"]]}
                                       if "by_shape" in r else {}))
                         for inst, r in res["by_cache"].items()},
        }
        if "by_shape" in res:
            row["by_shape"] = [{k: x[k] for k in keys if k in x} for x in res["by_shape"]]
        if name == k3.ILV_NAME:  # K8's own path: the int8 Qwen3-8B engine
            row["launches_int8_engine"] = runs["int8_ilv"][0][name]
            row["by_cache"]["interleaved int8"]["launches"] = runs["int8_ilv"][0][name]
        elif run == "int8_ilv":  # the int8 instance is the one that engine runs
            row["by_cache"]["int8"]["launches"] = launches[name]
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ", ".join(PHASES) + " (a subset prints no "
                    "result line)")
    phases = set(ap.parse_args().phases.split(","))
    if not phases <= set(PHASES):
        raise SystemExit(f"unknown phases {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phase 1: build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for stem, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {stem}: {line.strip()}")
    card = card_line()
    log(card)
    log(f"[build] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    kern, qcache, runs = {}, {}, {}
    if "kernels" in phases:
        kern.update(timed_phase("kernels", phase_kernels, dev))
    fp8 = {}
    if "qkernels" in phases:
        kern.update(timed_phase("qkernels", check_qmm, dev))
        qcache = timed_phase("qkernels", phase_quant_caches, np.random.default_rng(1), dev)
        fp8 = timed_phase("qkernels", phase_fp8_kernels, np.random.default_rng(2), dev)
    if "engines" in phases:
        # scores of 2,100 tokens (chunks of 2048 and 52: K2b and K4b) and
        # 300 (K2b in the 512 bucket); embeds of 40 (K4b) and 700 (K2b)
        scoring = dict(score_lens=SCORE_LENS, embed_lens=EMBED_LENS)
        runs["dense"] = timed_phase("engine", phase_engine, **scoring)
        runs["moe"] = timed_phase("moe-engine", phase_engine, QWEN3_30B_A3B,
                                  num_blocks=512, tag="moe-engine", score_lens=(2100,))
        runs["mla"] = timed_phase("mla-engine", phase_engine, DEEPSEEK_V2_LITE,
                                  num_blocks=512, tag="mla-engine", **scoring)
    if "quant" in phases:
        with environ(XLLM_QMM_KERNEL="pallas"):
            runs["int8"] = timed_phase(
                "int8-engine", phase_engine, QWEN3_8B, tag="int8-engine", quant="int8",
                kv_cache_dtype="int8", qmm_name=qmm.W8A8_NAME, score_lens=(2100,))
            runs["fp8_e4m3"] = timed_phase(
                "fp8-engine", phase_engine, QWEN3_8B, tag="fp8-engine", quant="fp8_e4m3",
                kv_cache_dtype="fp8_e4m3", qmm_name=qmm.FP8_NAME, score_lens=(2100,))
        with environ(XLLM_BF16_MM="pallas"):
            runs["bf16mm"] = timed_phase(
                "bf16mm-engine", phase_engine, tag="bf16mm-engine", qmm_name=qmm.BF16_NAME,
                qmm_max_rows=256)
        # the quantized MoE and MLA families: fp8 expert stacks through K10's
        # fp8 instance, the projections through K6, an fp8 KV / latent cache
        with environ(XLLM_QMM_KERNEL="pallas"):
            runs["fp8_moe"] = timed_phase(
                "fp8-moe-engine", phase_engine, QWEN3_30B_A3B, num_blocks=512,
                tag="fp8-moe-engine", quant="fp8_e4m3", kv_cache_dtype="fp8_e4m3",
                qmm_name=qmm.FP8_NAME, score_lens=(2100,))
            runs["fp8_mla"] = timed_phase(
                "fp8-mla-engine", phase_engine, DEEPSEEK_V2_LITE, num_blocks=512,
                tag="fp8-mla-engine", quant="fp8_e4m3", kv_cache_dtype="fp8_e4m3",
                qmm_name=qmm.FP8_NAME, score_lens=(2100,))
    if "parity" in phases:
        t0 = time.perf_counter()
        for name, model_kw in PARITY_MODELS.items():
            phase_parity(name, model_kw, scores=name in ("qwen3", "deepseek_v2"))
        with environ(XLLM_QMM_KERNEL="pallas"):
            phase_parity("qwen3", PARITY_DENSE, quant="int8", kv_cache_dtype="int8")
            for name in ("qwen3_moe", "deepseek_v2"):  # fp8 experts, fp8 KV / latent
                phase_parity(name, PARITY_MODELS[name], quant="fp8_e4m3",
                             kv_cache_dtype="fp8_e4m3")
            phase_parity("deepseek_v2", PARITY_MODELS["deepseek_v2"], quant="int8")
        phase_async()
        log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    ilv = {}
    if "layouts" in phases:
        ilv = timed_phase("layouts", phase_layouts, dev)
    if "layout-engines" in phases:
        # the JAX bench's default deployment: qwen3-1.7B on interleaved_rm
        runs["rm"] = timed_phase("rm-engine", phase_engine, tag="rm-engine",
                                 kv_layout="interleaved_rm", score_lens=SCORE_LENS,
                                 embed_lens=EMBED_LENS)
        # its int8 phase: rm asked for, interleaved served (int8 KV)
        with environ(XLLM_QMM_KERNEL="pallas"):
            runs["int8_ilv"] = timed_phase(
                "int8-ilv-engine", phase_engine, QWEN3_8B, tag="int8-ilv-engine",
                quant="int8", kv_cache_dtype="int8", qmm_name=qmm.W8A8_NAME,
                score_lens=(2100,), kv_layout="interleaved_rm", resolved="interleaved")
        timed_phase("layout-parity", phase_layout_parity)
    gram, gram_runs = {}, {}
    if "grammar" in phases:
        gram = timed_phase("grammar", phase_grammar, dev)
    if "grammar-engines" in phases:
        gram_runs = timed_phase("grammar-engines", phase_grammar_engines)
    if phases != set(PHASES):
        log(card)
        log(f"chip_smoke: partial run ({', '.join(sorted(phases))}); no result line")
        return 0

    meta = {
        k1.NAME: (k1.TPU_KERNEL, "decode_attention.cu"),
        k24.PREFILL_NAME: (k24.PREFILL_TPU_KERNEL, "kv_write.cu"),
        k3.NAME: (k3.TPU_KERNEL, "prefill_attention.cu"),
        k24.RMW_NAME: (k24.RMW_TPU_KERNEL, "kv_write.cu"),
        k10.NAME: (k10.TPU_KERNEL, "gmm.cu"),
        k11.DECODE_NAME: (k11.DECODE_TPU_KERNEL, "mla_attention.cu"),
        k11.PREFILL_NAME: (k11.PREFILL_TPU_KERNEL, "mla_attention.cu"),
        k24.LATENT_PREFILL_NAME: (k24.LATENT_PREFILL_TPU_KERNEL, "kv_write.cu"),
        k24.LATENT_RMW_NAME: (k24.LATENT_RMW_TPU_KERNEL, "kv_write.cu"),
        qmm.W8A8_NAME: (qmm.W8A8_TPU_KERNEL, "quant_matmul.cu"),
        qmm.FP8_NAME: (qmm.FP8_TPU_KERNEL, "quant_matmul.cu"),
        qmm.BF16_NAME: (qmm.BF16_TPU_KERNEL, "quant_matmul.cu"),
        k24.ONE_PREFILL_NAME: (k24.ONE_PREFILL_TPU_KERNEL, "kv_write.cu"),
        k3.ONE_NAME: (k3.ONE_TPU_KERNEL, "prefill_attention.cu"),
        k24.ONE_RMW_NAME: (k24.ONE_RMW_TPU_KERNEL, "kv_write.cu"),
        k11.ONE_PREFILL_NAME: (k11.ONE_PREFILL_TPU_KERNEL, "mla_attention.cu"),
        k24.ONE_LATENT_PREFILL_NAME: (k24.ONE_LATENT_PREFILL_TPU_KERNEL, "kv_write.cu"),
        k24.ONE_LATENT_RMW_NAME: (k24.ONE_LATENT_RMW_TPU_KERNEL, "kv_write.cu"),
    }
    # each kernel's launches come from the run of its own slice's path, with
    # the counters zeroed just before it: K1-K4 the dense engine phase, K10
    # the MoE engine phase, K11a-d the MLA engine phase, K5 and K6 the int8
    # and fp8 Qwen3-8B phases, K7 the qwen3-1.7B phase under XLLM_BF16_MM
    # (and each quantized-cache row of K1-K4 its cache's Qwen3-8B phase)
    path_of = {k10.NAME: runs["moe"], qmm.W8A8_NAME: runs["int8"],
               qmm.FP8_NAME: runs["fp8_e4m3"], qmm.BF16_NAME: runs["bf16mm"]}
    path_of.update({name: runs["mla"] for name in meta
                    if name.startswith(("mla_", "latent_"))})
    # the single-chunk kernels' launches come from the scoring and embedding
    # run of their engine (zeroed just before it): K2b-K4b the dense engine's
    # (and each quantized-cache row its Qwen3-8B engine's), K11e-g the MLA
    # engine's
    single = {k24.ONE_PREFILL_NAME, k3.ONE_NAME, k24.ONE_RMW_NAME, k11.ONE_PREFILL_NAME,
              k24.ONE_LATENT_PREFILL_NAME, k24.ONE_LATENT_RMW_NAME}

    def run_of(run, name):
        return run[1]["score"] if name in single else run
    keys = ("shape", "max_abs_err", "max_abs_err_f32", "ms", "kernel_only_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library", "row_tile", "instance",
            "ms_by_instance", "plan")
    rows = []
    for name, res in kern.items():
        tpu, src = meta[name]
        where, func = tpu.split()
        path_launches, path_info = run_of(path_of.get(name, runs["dense"]), name)
        row = {
            "name": name,
            "route": "cuda",
            "source": f"xllm_tpu_torch/csrc/{src}",
            "replaces": where,
            "tpu_counterpart": func,
            "launches": path_launches[name],
            # measured: launches of each model pass that launched it
            "launches_per_step": path_info["per_pass"][name]["launches_per_step"],
            "passes": path_info["per_pass"][name]["passes"],
            "max_abs_err": res["max_abs_err"],
            "max_abs_err_f32": res["max_abs_err_f32"],
            "ms": res["ms"],
            **{k: res[k] for k in ("kernel_only_ms", "max_abs_err_edge_rows",
                                   "max_abs_err_splits", "plan") if k in res},
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
            "library": res.get("library", "SDPA" if "attention" in name else
                               "torch._grouped_mm" if name == k10.NAME else "index assign"),
            "shape": res["shape"],
        }
        if "by_shape" in res:
            row["by_shape"] = [{k: r[k] for k in keys if k in r} for r in res["by_shape"]]
        if name == k10.NAME and fp8:
            r = fp8[name]
            row["by_rhs"] = {"fp8_e4m3": dict(
                {k: r[k] for k in keys if k in r}, library=r["library"],
                launches=runs["fp8_moe"][0][name],
                launches_per_step=runs["fp8_moe"][1]["per_pass"][name]["launches_per_step"],
                launches_mla_engine=runs["fp8_mla"][0][name],
                by_shape=[{k: x[k] for k in keys if k in x} for x in r["by_shape"]])}
        if name in fp8 and name != k10.NAME:  # the fp8 latent cache
            r = fp8[name]
            launches, info = run_of(runs["fp8_mla"], name)
            row["by_cache"] = {"fp8_e4m3": dict(
                {k: r[k] for k in keys if k in r}, launches=launches[name],
                launches_per_step=info["per_pass"][name]["launches_per_step"],
                by_shape=[{k: x[k] for k in keys if k in x} for x in r.get("by_shape", [])])}
        if name in qcache:
            row["by_cache"] = {
                cache: dict({k: r[k] for k in keys if k in r},
                            launches=run_of(runs[cache], name)[0][name],
                            launches_per_step=run_of(runs[cache], name)[1]["per_pass"][name][
                                "launches_per_step"],
                            by_shape=[{k: x[k] for k in keys if k in x}
                                      for x in r.get("by_shape", [])])
                for cache, r in qcache[name].items()}
        rows.append(row)
    rows += ilv_rows(ilv, runs, keys)
    rows += grammar_rows(gram, gram_runs, rows)
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
