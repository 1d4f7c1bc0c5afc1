#!/usr/bin/env python3
"""Where an engine step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/profile_torch_step.py
        [--model qwen3-1.7b|qwen3-30b-a3b|deepseek-v2-lite|qwen3-8b|qwen3-8b-int8|qwen3-8b-fp8
                 |qwen3-30b-a3b-fp8|deepseek-v2-lite-fp8]
        [--prompt-len 512] [--steps 16]
        [--kv-layout split|interleaved|interleaved_rm[,...]]
        [--qmm default,pallas] [--bf16-mm default|pallas] [--requests 16]

Serves a config of ``chip_smoke.py`` (the qwen3-1.7B-class dense model, 28
layers; Qwen3-30B-A3B, 48 layers with 128 experts; DeepSeek-V2-Lite, 27
MLA layers with 64 experts; Qwen3-8B, 36 layers, with bf16 weights, or
int8 weights and an int8 KV cache, or fp8 weights and an fp8 KV cache;
Qwen3-30B-A3B with fp8 weights, experts included, and an fp8 KV cache;
DeepSeek-V2-Lite with fp8 weights and an fp8 latent cache; random weights) through ``xllm_tpu_torch.engine.LLMEngine`` on the card.
A quantized model runs twice, one engine after the other in one process:
with the dequant default, then with ``XLLM_QMM_KERNEL=pallas`` (K5 / K6);
``--qmm pallas`` keeps the second only. ``--bf16-mm pallas`` serves a bf16
model under ``XLLM_BF16_MM=pallas``: its passes of at most 256 token rows
(decode steps; prefill passes of up to four 64-token chunks) take K7 for
every projection.
``--kv-layout`` takes a comma list of KV layouts (default split), each
served by an engine of its own, one after the other in the listed order
(``split,interleaved_rm,interleaved_rm,split`` compares two layouts in
turns, on one card). Each engine:
``--requests`` (16) greedy requests of ``--prompt-len`` tokens, after two
warm-up requests (first calls load CUDA modules and pick GEMM algorithms). Two windows are
traced with ``torch.profiler``:

- prefill: from the first step until every prompt has been computed;
- decode: ``--steps`` steady decode steps (every request running, the
  decode batch padded to 16 rows),
  after a few warm-up steps.

For each window it reports the host-clock time per step (between two
``torch.cuda.synchronize()`` calls), the device busy time per step (the
union of the kernel and copy intervals on the trace), the device idle
share, and the device time per step by kernel group: the port's
hand-written kernels by name, GEMMs, and everything else. The last line
of the output is one JSON object with those numbers (by variant) and the
card's name and power limit. Needs one CUDA card and nvcc; imports
neither jax nor ``xllm_tpu``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the smoke run's config and helpers)
from xllm_tpu_torch.engine import LLMEngine  # noqa: E402
from xllm_tpu_torch.framework.sampling_params import SamplingParams  # noqa: E402
from xllm_tpu_torch.ops.cuda import _build  # noqa: E402

BATCH = 16
# kernel-name fragments of the port's hand-written kernels (csrc/*.cu)
OWN_KERNELS = {
    "decode_attention_write_kernel": "K1/K8/K9 decode_attention_write",
    "decode_granule_max_kernel": "K1/K8/K9 decode_attention_write",
    "rm_complete_kernel": "K9 decode_attention_write_rm (page rewrite)",
    "kv_write_rows_kernel": "K2/K4/K8/K9 kv_write_rows",
    "kv_write_rmw_rm_kernel": "K9 kv_write_rmw_batched_rm",
    "prefill_attention_kernel": "K3/K8 prefill_attention",
    "prefill_tc_kernel": "K3/K8 prefill_attention",
    "gmm_bf16_kernel": "K10 gmm",
    "gmm_ws_kernel": "K10 gmm",
    "gmm_f32_kernel": "K10 gmm",
    "mla_attention_tc_kernel<1": "K11a mla_decode_attention_write",
    "mla_attention_tc_kernel<2": "K11b mla_prefill_attention_batched",
    "latent_write_rows_kernel": "K11c/K11d latent_write_rows",
    "qmm_int8_kernel": "K5 quant_matmul_int8",
    "qmm_bf16_kernel<true": "K6 quant_matmul_fp8",
    "qmm_bf16_kernel<false": "K7 matmul_bf16",
    "qmm_ws_kernel<true": "K6 quant_matmul_fp8",
    "qmm_ws_kernel<false": "K7 matmul_bf16",
}
# --model -> (chip_smoke model config, KV blocks, quant method, KV dtype)
MODELS = {
    "qwen3-1.7b": (chip_smoke.QWEN3_1P7B, 1024, "", "auto"),
    "qwen3-30b-a3b": (chip_smoke.QWEN3_30B_A3B, 512, "", "auto"),
    "deepseek-v2-lite": (chip_smoke.DEEPSEEK_V2_LITE, 512, "", "auto"),
    "qwen3-8b": (chip_smoke.QWEN3_8B, 1024, "", "auto"),
    "qwen3-8b-int8": (chip_smoke.QWEN3_8B, 1024, "int8", "int8"),
    "qwen3-8b-fp8": (chip_smoke.QWEN3_8B, 1024, "fp8_e4m3", "fp8_e4m3"),
    "qwen3-30b-a3b-fp8": (chip_smoke.QWEN3_30B_A3B, 512, "fp8_e4m3", "fp8_e4m3"),
    "deepseek-v2-lite-fp8": (chip_smoke.DEEPSEEK_V2_LITE, 512, "fp8_e4m3", "fp8_e4m3"),
}
GEMM_MARKS = ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")


def kernel_group(name: str) -> str:
    for frag, label in OWN_KERNELS.items():
        if frag in name:
            return label
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "GEMM (torch.matmul)"
    return "other"


def device_breakdown(prof, steps: int) -> dict:
    """Per-step device numbers from a profiler trace."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    groups: dict[str, float] = {}
    for name, us in by_name.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(
        ((e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()),
        key=lambda kv: -kv[1],
    )[:10]
    return {
        "top_host_ops_ms_per_step": [
            [name[:60], us / 1e3 / steps, n / steps] for name, us, n in host
        ],
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_ms_per_step_by_group": {
            g: us / 1e3 / steps for g, us in sorted(groups.items(), key=lambda kv: -kv[1])
        },
        "top_kernels_ms_per_step": [[n[:90], us / 1e3 / steps] for n, us in top],
    }


def traced(eng: LLMEngine, n_steps: int | None, until=None) -> dict:
    """Run engine steps under the profiler: ``n_steps`` of them, or until
    ``until()`` holds. -> host ms per step and the device breakdown."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    steps = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while (steps < n_steps) if n_steps is not None else not until():
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"steps": steps, "host_ms_per_step_traced": wall / steps * 1e3,
           "launches": dict(_build.launch_counts)}
    out.update(device_breakdown(prof, steps))
    out["device_idle_share"] = 1.0 - out["device_busy_ms_per_step"] / out["host_ms_per_step_traced"]
    return out


def profile_engine(args, model: str, kv_layout: str = "split") -> dict:
    """Serve ``model`` once on ``kv_layout`` and trace its prefill and
    decode windows."""
    model_kw, num_blocks, quant, kv = MODELS[model]
    cfg = chip_smoke.engine_config(model_kw, batch=BATCH, num_blocks=num_blocks,
                                   quant=quant, kv_cache_dtype=kv, kv_layout=kv_layout)
    eng = LLMEngine(cfg, device="cuda")
    rng = np.random.default_rng(0)
    chip_smoke.warm_up(eng, rng)
    # enough tokens that every sequence still decodes through both windows
    decode_tokens = 16 + 2 * args.steps + 4 * cfg.scheduler.overlap_depth
    sp = SamplingParams(temperature=0.0, max_tokens=decode_tokens, ignore_eos=True)
    reqs = [eng.add_request(prompt_token_ids=rng.integers(1, cfg.model.vocab_size,
                                                          args.prompt_len).tolist(),
                            sampling_params=sp)
            for _ in range(args.requests)]
    seqs = [r.sequences[0] for r in reqs]

    prefill = traced(eng, None, until=lambda: all(
        s.num_computed_tokens >= s.num_prompt_tokens for s in seqs))
    prefill["prompt_tokens"] = args.requests * args.prompt_len
    for _ in range(8):  # past the prefill-drain depth, steady decode
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3
    decode = traced(eng, args.steps)
    decode["host_ms_per_step_untraced"] = host_ms
    decode["tok_per_s_untraced"] = args.requests / host_ms * 1e3
    decode["device_idle_share_untraced"] = 1.0 - decode["device_busy_ms_per_step"] / host_ms
    decode["context_tokens_at_end"] = sorted({int(s.num_computed_tokens) for s in seqs})
    while eng.has_unfinished():
        eng.step()
    assert eng.block_manager.num_used_blocks == 0, "KV blocks leaked"
    return {"kv_layout": eng.runner.model.kv_layout, "prefill": prefill, "decode": decode}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="qwen3-1.7b")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--requests", type=int, default=BATCH,
                    help="prompts served together (at most the batch of 16; 4 prompts of "
                    "40 tokens make one 256-row prefill pass)")
    ap.add_argument("--kv-layout", default="split",
                    help="comma list of split, interleaved, interleaved_rm: one engine "
                    "each, in this order")
    ap.add_argument("--qmm", default="default,pallas",
                    help="a quantized model's matmuls: comma list of default (dequant) "
                    "and pallas (K5 / K6)")
    ap.add_argument("--bf16-mm", choices=("default", "pallas"), default="default",
                    help="pallas: a bf16 model's passes of <= 256 rows through K7")
    args = ap.parse_args()
    layouts = args.kv_layout.split(",")
    if not set(layouts) <= {"split", "interleaved", "interleaved_rm"}:
        raise SystemExit(f"unknown kv layouts in {args.kv_layout!r}")
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all()
    kernels = args.qmm.split(",") if MODELS[args.model][2] else ["default"]
    if not set(kernels) <= {"default", "pallas"}:
        raise SystemExit(f"unknown --qmm {args.qmm!r}")
    bf16_mm = "pallas" if args.bf16_mm == "pallas" and not MODELS[args.model][2] else ""
    results = {}
    for i, layout in enumerate(layouts):
        for kernel in kernels:
            # a variant: the matmul kernels, and the layout when several are asked
            variant = kernel if len(layouts) == 1 else f"{kernel} {layout} #{i + 1}"
            env = {"XLLM_QMM_KERNEL": "pallas" if kernel == "pallas" else "",
                   "XLLM_BF16_MM": bf16_mm}
            with chip_smoke.environ(**env):
                results[variant] = profile_engine(args, args.model, layout)
            gc.collect()
            torch.cuda.empty_cache()
            for name in ("prefill", "decode"):
                res = results[variant][name]
                untraced = (f", untraced {res['host_ms_per_step_untraced']:.3f} ms/step"
                            if name == "decode" else "")
                print(f"[{variant} {name}] {res['steps']} steps: host "
                      f"{res['host_ms_per_step_traced']:.3f} ms/step (traced){untraced}, "
                      f"device busy {res['device_busy_ms_per_step']:.3f} ms/step, idle "
                      f"share {res['device_idle_share']:.3f}", flush=True)
                for g, ms in res["device_ms_per_step_by_group"].items():
                    print(f"[{variant} {name}]   device {g}: {ms:.4f} ms/step", flush=True)
                for op, ms, n in res["top_host_ops_ms_per_step"]:
                    print(f"[{variant} {name}]   host {op}: {ms:.4f} ms/step over "
                          f"{n:.0f} calls", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "model": args.model, "batch": BATCH,
                      "requests": args.requests,
                      "prompt_len": args.prompt_len, "bf16_mm": bf16_mm or "default",
                      "variants": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
