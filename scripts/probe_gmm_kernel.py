#!/usr/bin/env python3
"""Quick check and timing of the grouped expert GEMM (K10) on one GPU.

    python3 scripts/probe_gmm_kernel.py
    python3 scripts/probe_gmm_kernel.py --compare PARENT_DIR

Without ``--compare``: builds the kernels, prints what ptxas says of
``csrc/gmm.cu``, holds every instance ``ops/cuda/gmm.plan`` can pick (the
TMA + wgmma kernel at 256- and 128-row tiles, the 16-row mma.sync kernel,
the f32 FMA kernel) to the plain version within ``chip_smoke.GMM_TOL`` at
every served shape and at edge offsets, then times each served shape with
the wrapper's pick beside each bf16-lhs build forced, ``torch._grouped_mm``
(for an e4m3 rhs after an upcast to bf16) and the bound.

The served shapes: Qwen3-30B-A3B (128 experts, top-8; gate_up K 2048 / N
1536, down K 768 / N 2048) and DeepSeek-V2-Lite (64 experts, top-6;
gate_up K 2048 / N 2816, down K 1408 / N 2048), a 16-token decode step
and a full chunk of each prefill bucket (64, 512, 2,048 tokens), with
bf16 and e4m3 expert stacks: 32 shapes. Each token routes to top-k
distinct experts drawn from a seed, so both trees of ``--compare`` time
the same rows.

With ``--compare PARENT_DIR`` (a checkout of another commit, for example
``git archive`` of the parent unpacked into a directory that .gitignore
lists): times the served shapes with each tree's own wrapper, in four
processes in turns (parent, this tree, this tree, parent), and prints the
better time of each tree per shape and their ratio.

Needs one card and nvcc; imports neither jax nor ``xllm_tpu``. The last
line is one JSON object with the results and the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

MODELS = {"Qwen3-30B-A3B": (128, 8, {"gate_up": (2048, 1536), "down": (768, 2048)}),
          "DeepSeek-V2-Lite": (64, 6, {"gate_up": (2048, 2816), "down": (1408, 2048)})}
TOKENS = (16, 64, 512, 2048)
RHS = ("bf16", "fp8_e4m3")


def _imports(root: Path):
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from xllm_tpu_torch.ops.cuda import _build
    from xllm_tpu_torch.ops.cuda import gmm as k10
    return cs, _build, k10


def routed(g, dev, tokens: int, e: int, topk: int) -> torch.Tensor:
    """Group offsets [e + 1] int32 of tokens x topk rows, each token sent to
    topk distinct experts drawn from ``g``."""
    picks = torch.rand(tokens, e, generator=g, device=dev).argsort(dim=1)[:, :topk]
    counts = torch.bincount(picks.flatten(), minlength=e)
    return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()


def stacks(g, dev, e: int, k: int, n: int, rhs: str) -> torch.Tensor:
    w = (torch.randn(e, k, n, generator=g, device=dev) * 0.02).bfloat16()
    if rhs == "fp8_e4m3":
        from xllm_tpu_torch.ops.quant import quantize_fp8
        w = quantize_fp8(w)[0]
    return w


def shapes(dev):
    """Each served shape's (label, lhs, rhs, offsets, touched experts),
    made from one seed a model and stack kind (the same in every tree)."""
    for model, (e, topk, weights) in MODELS.items():
        for rhs_kind in RHS:
            g = torch.Generator(device=dev).manual_seed(17)
            w = {name: stacks(g, dev, e, k, n, rhs_kind) for name, (k, n) in weights.items()}
            for tokens in TOKENS:
                offs = routed(g, dev, tokens, e, topk)
                m = tokens * topk
                touched = int((offs[1:] > offs[:-1]).sum())
                for name, (k, n) in weights.items():
                    lhs = torch.randn(m, k, generator=g, device=dev).bfloat16()
                    label = f"{model} {tokens} tokens {name} M {m} K {k} N {n} {rhs_kind} rhs"
                    yield label, lhs, w[name], offs, touched
            del w
            torch.cuda.empty_cache()


def time_shapes(cs, k10, dev, detail: bool) -> list[dict]:
    """Each served shape's kernel ms under the wrapper's own pick; with
    ``detail`` also each bf16 instance forced, the library call and the
    bound."""
    out = []
    for label, lhs, rhs, offs, touched in shapes(dev):
        ms, queued = cs.time_ms(lambda i: k10.gmm(lhs, rhs, offs))
        assert queued, f"{label}: the wrapper waited on the device"
        row = {"shape": label, "ms": ms, "host_us": cs.host_us(lambda i: k10.gmm(lhs, rhs, offs))}
        if detail:
            m, k = lhs.shape
            e, _, n = rhs.shape
            row["instance"] = k10.plan(m, k, n, e, lhs.dtype, rhs.dtype,
                                       cs._build.device_sms(dev)).name
            row["ms_by_instance"], _ = cs.gmm_instances(dev, lhs, rhs, offs, label)
            rb = rhs if rhs.dtype == torch.bfloat16 else None
            row["library_ms"] = cs.time_ms(lambda i: torch._grouped_mm(
                lhs, rb if rb is not None else rhs.to(torch.bfloat16), offs=offs[1:]))[0]
            nbytes = m * k * 2 + touched * k * n * rhs.element_size() + m * n * 4
            row["bound_ms"], row["bound_by"] = cs.bound_ms(nbytes, 2.0 * m * k * n)
        out.append(row)
    return out


def check(cs, k10, dev) -> float:
    """Every instance at every served shape (bf16 and f32 lhs) and at edge
    offsets against the plain version -> the worst max-abs error."""
    worst = 0.0
    for label, lhs, rhs, offs, _ in shapes(dev):
        _, err = cs.gmm_instances(dev, lhs, rhs, offs, label)
        worst = max(worst, err)
        lf = lhs.float()
        rf = rhs if rhs.dtype != torch.bfloat16 else rhs.float()
        worst = max(worst, cs.check_gmm_close(k10.gmm(lf, rf, offs), lf, rf, offs,
                                              label + " f32 lhs"))
    g = torch.Generator(device=dev).manual_seed(3)
    w = cs.moe_weights(dev, g, cs.GMM_MODELS["Qwen3-30B-A3B"])
    worst = max(worst, cs.check_gmm_edges(dev, w, g))
    torch.cuda.synchronize()
    return worst


def compare(parent: Path) -> dict:
    """Parent, this tree, this tree, parent, each in its own process."""
    runs = {"parent": [], "this": []}
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time-root",
                              str(root)], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{tag} run failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"{tag} run: {time.perf_counter() - t0:.1f} s", flush=True)
    table = []
    for i, row in enumerate(runs["this"][0]):
        was = min(r[i]["ms"] for r in runs["parent"])
        now = min(r[i]["ms"] for r in runs["this"])
        hw = min(r[i]["host_us"] for r in runs["parent"])
        hn = min(r[i]["host_us"] for r in runs["this"])
        table.append({"shape": row["shape"], "was_ms": was, "ms": now, "speedup": was / now,
                      "was_host_us": hw, "host_us": hn})
        print(f"{row['shape']}: parent {was:.4f} ms, this {now:.4f} ms ({was / now:.2f}x); "
              f"host {hw:.1f} -> {hn:.1f} us a call", flush=True)
    return {"compare": table, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, help="a checkout of another commit")
    ap.add_argument("--time-root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gmm_kernel: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.time_root is not None:  # one timing process of --compare
        cs, _build, k10 = _imports(args.time_root.resolve())
        _build.build_all()
        print(json.dumps(time_shapes(cs, k10, dev, detail=False)))
        return 0
    cs, _build, k10 = _imports(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    if args.compare is not None:
        res = compare(args.compare.resolve())
    else:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        for line in _build.build_log.get("gmm", "").splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "error", "Compiling")):
                print(line.strip(), flush=True)
        worst = check(cs, k10, dev)
        print(f"checks passed: worst max-abs error {worst:.3g} ({cs.GMM_TOL})", flush=True)
        res = {"worst_err": worst, "timed": time_shapes(cs, k10, dev, detail=True)}
        for r in res["timed"]:
            inst = ", ".join(f"{kn} {t:.4f}" for kn, t in r["ms_by_instance"].items())
            print(f"{r['shape']} ({r['instance']}): kernel {r['ms']:.4f} ms ({inst}), library "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"host {r['host_us']:.1f} us", flush=True)
    print(card)
    print(json.dumps(dict(res, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
