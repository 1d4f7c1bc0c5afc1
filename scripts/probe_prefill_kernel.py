#!/usr/bin/env python3
"""Quick check and timing of the prefill attention kernels on one GPU.

    python3 scripts/probe_prefill_kernel.py

K3, K3b and K8 / K9's prefill (``xllm_tpu_torch/csrc/prefill_attention.cu``)
against their plain versions on inputs whose scores are exact in f32
(``chip_smoke.grid_tensor``), on bf16, int8 and fp8 caches, at every chunk
bucket, at block_size 8-256 with and without a window (each launch also
against the split model with the kernel's own plan), and on the
interleaved layouts. It prints the worst ratio of an error to its bound
(1e-5 + 2^-7 |ref|; one bf16 ulp of the output reaches 0.9997), then times
the kernel beside SDPA over gathered K/V at the chunk shapes of
``chip_smoke.py`` and at Qwen3-8B's and Qwen3-30B-A3B's groups. A short
call after a change to the kernel: it builds only what it runs, needs one
card and nvcc, and imports neither jax nor ``xllm_tpu``. The last line is
one JSON object with the worst ratio, the timings and the card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (the smoke run's checks and helpers)
from xllm_tpu_torch.ops.cuda import _build  # noqa: E402
from xllm_tpu_torch.ops.cuda import prefill_attention as k3  # noqa: E402

CACHES = (None, "int8", "fp8_e4m3")
PAGE_SIZES = (8, 16, 32, 64, 128, 256)
# (S, chunks, one chunk (K3b)?, Hq, Hkv), as chip_smoke.py times them
TIMED = [(2048, [(2048, 2048)], True, 16, 8), (64, [(2048, 52)], True, 16, 8),
         (2048, [(0, 2048)], True, 16, 8), (2048, cs.K3_SHAPES[2048], False, 16, 8),
         (64, cs.K3_SHAPES[64], False, 16, 8), (512, cs.PREFILL_ROWS, False, 16, 8),
         (2048, [(0, 2048)], True, 32, 8), (2048, cs.K3_SHAPES[2048], False, 32, 4)]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_prefill_kernel: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.get("prefill_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    card = cs.card_line()
    print(card, flush=True)

    worst = {"ratio": 0.0, "what": ""}
    check_close = cs.check_close

    def ratio_check(out, ref, what):  # the smoke's check, recording the margin
        atol, rtol = cs.TOL[ref.dtype]
        r = ((out.float() - ref.float()).abs() / (atol + rtol * ref.float().abs())).max().item()
        if r > worst["ratio"]:
            worst.update(ratio=r, what=what)
        return check_close(out, ref, what)

    cs.check_close = ratio_check
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    for cache in CACHES:
        for s, rows in cs.K3_SHAPES.items():
            for hq, hkv in ((16, 8), (32, 8)):
                cs.check_prefill_shape(rng, dev, bf16, False, s, rows, hq=hq, hkv=hkv,
                                       cache=cache, grid=True)
        for s, rows in cs.SINGLE_SHAPES:
            cs.check_prefill_shape(rng, dev, bf16, False, s, rows, cache=cache, single=True,
                                   grid=True)
        for rm in (False, True):
            if rm and cache == "int8":
                continue
            for s, rows in cs.ILV_PREFILL:
                cs.check_ilv_prefill(rng, dev, g, bf16, cache, rm, s, rows)
        for bs in PAGE_SIZES:
            for s, rows in cs.PAGE_ROWS.items():
                nbmax = 4096 // bs
                bt, nb = cs._paged(rng, [a + n for a, n in rows], bs, nbmax)
                shape = (2, nb, cs.HKV, bs, cs.D)
                kc = cs.grid_tensor(g, dev, shape, bf16, cache)
                vc = cs.grid_values(g, dev, shape, bf16, cache)
                q = cs.grid_tensor(g, dev, (len(rows), s, cs.HQ, cs.D), bf16)
                chunk, nsplit = k3.split_plan(len(rows), s, cs.HQ, cs.HKV, nbmax * bs, bs)
                for window in (0, 100):
                    a = (1, cs.i32(bt, dev), cs.i32([a_ for a_, _ in rows], dev),
                         cs.i32([a_ + n if n else 0 for a_, n in rows], dev),
                         cs.grid_scale(cache), window)
                    out = k3.paged_attention_prefill_batched(q, kc, vc, *a)
                    what = f"bs {bs} cache {cache or 'bf16'} S {s} window {window}"
                    cs.check_close(out, k3.paged_attention_prefill_batched_plain(q, kc, vc, *a),
                                   what)
                    cs.check_close(out, k3.paged_attention_prefill_batched_plain(
                        q, kc, vc, *a, chunk), f"{what}, split model of {nsplit}")
        cs.free_device_memory()
    print(f"worst error / bound {worst['ratio']:.4f} ({worst['what']})", flush=True)

    timed = []
    for s, rows, single, hq, hkv in TIMED:
        r = cs.check_prefill_shape(rng, dev, bf16, True, s, rows, hq=hq, hkv=hkv, single=single)
        timed.append({k: r[k] for k in ("shape", "ms", "library_ms", "bound_ms", "bound_by")})
        print(f"{r['shape']}: kernel {r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        cs.free_device_memory()
    print(card)
    print(json.dumps({"worst_ratio": worst["ratio"], "timed": timed, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
