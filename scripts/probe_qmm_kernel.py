#!/usr/bin/env python3
"""Quick check and timing of the weight-streaming GEMMs (K5, K6, K7) on one GPU.

    python3 scripts/probe_qmm_kernel.py [--sweep] [--kinds int8,fp8_e4m3,bf16]
    python3 scripts/probe_qmm_kernel.py --compare PARENT_DIR [--kinds ...]

Without ``--compare``: builds the kernels, prints what ptxas says of
``csrc/quant_matmul.cu``, and holds K6 (e4m3 weights) and K7 (bf16) to
their plain versions within ``chip_smoke.QMM_TOL``, and K5 (int8) and its
quantizer to theirs bit for bit, at small shapes under
forced plans (part-filled tiles, a last stage shorter than the stage, 1-5
splits) and at every engine shape under the wrapper's plan, each split
launch also against the split model; stacked launches equal unstacked
ones bit for bit. Then it times the engine shapes (``SHAPES``) beside the
library call and the bound (K5: the whole call, the GEMM launch alone and
the quantizer alone), and with ``--sweep`` each of them under other plans
(other numbers of splits, other row tiles). ``--kinds`` keeps the named
weight kinds only.

With ``--compare PARENT_DIR`` (a checkout of another commit, for example
``git archive`` of the parent unpacked into a directory that .gitignore
lists): times the engine shapes with each tree's own wrappers, in four
processes in turns (parent, this tree, this tree, parent), and prints the
better time of each tree per shape and their ratio, with each wrapper's
host microseconds a call.

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

# (model, projection, K, N, rows, kinds): K7's engine shapes (qwen3-1.7B
# under XLLM_BF16_MM=pallas: decode, the 64 bucket, the 256-row ceiling)
# and its Qwen3-8B yardsticks, K6's (Qwen3-8B fp8 under
# XLLM_QMM_KERNEL=pallas: every pass size)
PROJ_1P7B = [("qkv", 2048, 4096), ("o", 2048, 2048), ("gate_up", 2048, 6144),
             ("down", 6144, 2048)]
PROJ_8B = [("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 12288),
           ("down", 12288, 4096)]
SHAPES = ([("qwen3-1.7B", p, k, n, m, "bf16") for m in (16, 64, 256) for p, k, n in PROJ_1P7B]
          + [("Qwen3-8B", p, k, n, m, "bf16") for m in (16, 2048) for p, k, n in PROJ_8B]
          + [("Qwen3-8B", p, k, n, m, kind) for kind in ("fp8_e4m3", "int8")
             for m in (16, 64, 512, 2048) for p, k, n in PROJ_8B])
KINDS = ("int8", "fp8_e4m3", "bf16")
# K5 under forced plans (M, K, N, tokens a tile, splits): part-filled token
# and column tiles, a last stage shorter than 128, 1-5 splits
S8_FORCED = [(m, k, n, bt, sp) for m, k, n in ((5, 320, 144), (52, 400, 272),
                                                (130, 1024, 256), (300, 2064, 384))
             for bt in (16, 64, 128, 256) for sp in (1, 2, 3, 5) if sp <= -(-k // 128)]
LAYERS = 4  # weight stacks rotated through (more than the 50 MB L2 at 8B)
SWEEP = (1, 2, 3, 4, 6, 8, 16)


def _imports(root: Path):
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from xllm_tpu_torch.ops.cuda import _build
    from xllm_tpu_torch.ops.cuda import quant_matmul as qmm
    return cs, _build, qmm


def weights(g, dev, kind, k, n):
    shape = (LAYERS, k, n)
    if kind == "int8":
        w = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        return w, (torch.rand(LAYERS, n, generator=g, device=dev) + 0.5) * (0.02 / 127.0)
    if kind == "fp8_e4m3":
        from xllm_tpu_torch.ops.quant import to_e4m3
        w = to_e4m3(torch.randn(shape, generator=g, device=dev) * 64.0)
        return w, (torch.rand(LAYERS, n, generator=g, device=dev) + 0.5) * (0.02 / 64.0)
    return (torch.randn(shape, generator=g, device=dev) * 0.02).bfloat16(), None


def wrappers(qmm, kind):
    """-> (stacked wrapper, unstacked wrapper, plain version, kernel name)"""
    if kind == "int8":
        return (qmm.quant_matmul_int8_stacked, qmm.quant_matmul_int8,
                qmm.quant_matmul_int8_plain, qmm.W8A8_NAME)
    if kind == "fp8_e4m3":
        return (qmm.quant_matmul_fp8_stacked, qmm.quant_matmul_fp8, qmm.quant_matmul_fp8_plain,
                qmm.FP8_NAME)
    return (lambda x, w, s, li: qmm.matmul_bf16_stacked(x, w, li),
            lambda x, w, s: qmm.matmul_bf16(x, w),
            lambda x, w, s: qmm.matmul_bf16_plain(x, w), qmm.BF16_NAME)


def time_shapes(cs, qmm, dev, shapes, library: bool) -> list[dict]:
    """Each shape's kernel ms (and host us a call; with ``library`` also the
    library call's ms and the bound)."""
    g = torch.Generator(device=dev).manual_seed(7)
    out = []
    for model, proj, k, n, m, kind in shapes:
        stacked, _, _, _ = wrappers(qmm, kind)
        w, s = weights(g, dev, kind, k, n)
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()

        def scale(i):
            return None if s is None else s[i % LAYERS]

        def call(i):
            return stacked(x, w, s, i % LAYERS)

        ms, queued = cs.time_ms(call)
        assert queued, f"{model} {proj} M {m}: the wrapper waited on the device"
        row = {"shape": f"{model} {proj} M {m} K {k} N {n} {kind}", "ms": ms,
               "host_us": cs.host_us(call)}
        if kind == "int8":  # the GEMM launch alone, and the quantizer alone
            quant = getattr(qmm, "quantize_rows", qmm.quantize_activations)
            xq, sx = quant(x)
            row["launch_ms"] = cs.time_ms(
                lambda i: qmm.launch_prepared(qmm.W8A8_NAME, xq, sx, w, s, i % LAYERS))[0]
            row["quant_ms"] = cs.time_ms(lambda i: quant(x))[0]
        if library:
            if kind == "int8":
                lib = cs.int_mm_yardstick(x, w, s)[0]
            elif kind == "fp8_e4m3":
                def lib(i):
                    wl = w[i % LAYERS].to(torch.bfloat16) * scale(i).bfloat16()
                    return torch.mm(x, wl, out_dtype=torch.float32)
            else:
                def lib(i):
                    return torch.mm(x, w[i % LAYERS], out_dtype=torch.float32)
            row["library_ms"] = cs.time_ms(lib)[0]
            nbytes = m * k * 2 + k * n * w.element_size() + m * n * 4 + (0 if s is None else n * 4)
            row["bound_ms"], row["bound_by"] = cs.bound_ms(
                nbytes + (m * 4 if kind == "int8" else 0), 2.0 * m * k * n,
                cs.PEAK_INT8 if kind == "int8" else cs.PEAK_BF16)
            sms = cs._build.device_sms(dev)
            p = qmm.int8_plan(m, k, n, sms) if kind == "int8" else qmm.plan(m, k, n, kind, sms)
            row["plan"] = f"{p.path} {p.bm}x{p.bn}, {p.splits} splits, {p.units} units"
        out.append(row)
        del w, s, x
        torch.cuda.empty_cache()
    return out


def check_int8(cs, qmm, dev) -> int:
    """K5 and its quantizer, bit for bit: the quantizer against
    ``quantize_activations`` on ``chip_smoke.int8_edge_x`` rows (ties, zero
    rows, signed zeros, the row maximum) in bf16 and f32; the GEMM under
    ``S8_FORCED`` against the plain version and the split
    model; every engine shape under the wrapper's plan, stacked against
    unstacked and against itself. -> the number of comparisons."""
    g = torch.Generator(device=dev).manual_seed(13)
    sms = cs._build.device_sms(dev)
    done = 0
    for m, k, n, bt, sp in S8_FORCED:
        w, s = weights(g, dev, "int8", k, n)
        for xdt in (torch.bfloat16, torch.float32):
            x = cs.int8_edge_x(g, dev, m, k, xdt)
            xq, sx = qmm.quantize_rows(x)
            rq, rs = qmm.quantize_activations(x)
            what = f"K5 M {m} K {k} N {n} tile {bt} splits {sp} x {xdt}"
            assert torch.equal(xq, rq) and cs.same_bytes(sx, rs), f"{what}: quantizer"
            p = qmm.int8_layout(m, k, n, sp, bt, sms)
            out = qmm.launch_prepared(qmm.W8A8_NAME, xq, sx, w, s, 1, p)
            assert torch.equal(out, qmm.quant_matmul_int8_plain(x, w[1], s[1])), what
            assert torch.equal(out, qmm.int8_split_model(x, w[1], s[1], p)), what + " split"
            done += 1
    for model, proj, k, n, m, kd in SHAPES:
        if kd != "int8":
            continue
        w, s = weights(g, dev, "int8", k, n)
        x = cs.int8_edge_x(g, dev, m, k, torch.bfloat16)
        out = qmm.quant_matmul_int8_stacked(x, w, s, 3)
        what = f"K5 {model} {proj} M {m}"
        assert torch.equal(out, qmm.quant_matmul_int8_plain(x, w[3], s[3])), what
        assert torch.equal(out, qmm.quant_matmul_int8(x, w[3], s[3])), f"{what}: stacked"
        assert torch.equal(out, qmm.quant_matmul_int8_stacked(x, w, s, 3)), f"{what}: repeat"
        done += 1
        del w, s
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return done


def check(cs, qmm, dev, kinds) -> float:
    """K6 / K7 against the plain version and the split model -> the worst
    error over its QMM_TOL bound."""
    g = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0

    def close(out, ref, x, w, s, what):
        nonlocal worst
        lim = torch.mm(x.to(torch.bfloat16).float().abs(), w.float().abs())
        if s is not None:
            lim = lim * s.abs()
        lim = lim * (w.shape[0] * 2.0 ** -24) + 1e-6
        r = ((out - ref).abs() / lim).max().item()
        worst = max(worst, r)
        assert r <= 1.0, f"{what}: {r:.3g} x the bound"

    forced = [(m, k, n, bm, sp) for m, k, n in ((5, 256, 64), (52, 320, 144), (64, 1024, 256),
                                                (130, 512, 384), (200, 4096, 128))
              for bm in qmm.WS_ROWS for sp in (1, 2, 3, 5) if sp <= -(-k // 64)]
    forced += [(300, 384, 256, 256, 1), (600, 2048, 512, 256, 3)]
    for kind in [kd for kd in ("bf16", "fp8_e4m3") if kd in kinds]:
        stacked, unstacked, plain, name = wrappers(qmm, kind)
        for m, k, n, bm, sp in forced:
            w, s = weights(g, dev, kind, k, n)
            sl = None if s is None else s[1]
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, generator=g, device=dev).to(xdt)
                p = qmm.layout(m, k, n, sp, bm, cs._build.device_sms(dev))
                xin = x.to(torch.bfloat16).contiguous()
                out = qmm.launch_prepared(name, xin, None, w, s, 1, p)
                what = f"{name} M {m} K {k} N {n} bm {bm} splits {sp} x {xdt}"
                close(out, plain(x, w[1], sl), x, w[1], sl, what)
                close(out, qmm.split_model(x, w[1], sl, p), x, w[1], sl, what + " split model")
        if kind == "fp8_e4m3":  # e4m3 NaN bytes (0x7f, 0xff) upcast to NaN
            w, s = weights(g, dev, kind, 512, 256)
            w.view(torch.uint8)[1, 3, 5] = 0x7F
            w.view(torch.uint8)[1, 300, 130] = 0xFF
            x = torch.randn(16, 512, generator=g, device=dev).bfloat16()
            out, ref = unstacked(x, w[1], s[1]), plain(x, w[1], s[1])
            assert torch.equal(out.isnan(), ref.isnan()) and out[:, 5].isnan().all(), "NaN"
            ok = ~ref.isnan()
            assert ((out - ref).abs()[ok] <= 1e-3 * ref.abs()[ok] + 1e-6).all(), "NaN tile"
        for model, proj, k, n, m, kd in SHAPES:
            if kd != kind:
                continue
            w, s = weights(g, dev, kind, k, n)
            sl = None if s is None else s[2]
            x = torch.randn(m, k, generator=g, device=dev).bfloat16()
            out = stacked(x, w, s, 2)
            what = f"{name} {model} {proj} M {m}"
            close(out, plain(x, w[2], sl), x, w[2], sl, what)
            p = qmm.plan(m, k, n, kind, cs._build.device_sms(dev))
            close(out, qmm.split_model(x, w[2], sl, p), x, w[2], sl, what + " split model")
            assert torch.equal(out, unstacked(x, w[2], sl)), f"{what}: stacked != unstacked"
            assert torch.equal(out, stacked(x, w, s, 2)), f"{what}: not deterministic"
            del w, s
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return worst


def sweep(cs, qmm, dev, shapes, kinds) -> list[dict]:
    """Each shape under other plans: other numbers of splits up to 64
    rows, 64- and 128-row tiles with 1, 2 or 4 splits up to 256, other row
    tiles above (K5: the launch alone)."""
    g = torch.Generator(device=dev).manual_seed(5)
    sms = cs._build.device_sms(dev)
    rows = []
    for kind in [kd for kd in ("bf16", "fp8_e4m3") if kd in kinds]:
        # the fixed cost: one tile, four stages
        _, _, _, name = wrappers(qmm, kind)
        w, s = weights(g, dev, kind, 256, 128)
        x = torch.randn(16, 256, generator=g, device=dev).bfloat16()
        floor = cs.time_ms(lambda i: qmm.launch_prepared(name, x, None, w, s, i % LAYERS))[0]
        rows.append({"shape": f"floor M 16 K 256 N 128 {kind}", "ms": floor})
        print(f"sweep {rows[-1]['shape']}: {floor:.4f} ms", flush=True)
    for model, proj, k, n, m, kind in shapes:
        _, _, _, name = wrappers(qmm, kind)
        w, s = weights(g, dev, kind, k, n)
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        if kind == "int8":
            xin, sx = qmm.quantize_rows(x)
            picked = qmm.int8_plan(m, k, n, sms)
            # (tokens a tile, splits)
            if m <= 64:
                tries = [(picked.bm, sp) for sp in (1, 2, 3, 4, 6, 8)]
            else:
                tries = [(bt, sp) for bt in (128, 256) for sp in (1, 2)]
            tries = sorted(set(tries) | {(picked.bm, picked.splits)})
            tries = [t for t in tries if t[1] <= -(-k // qmm.S8_BK)]
            key = f"{picked.bm}/{picked.splits}"
        else:
            xin, sx = x, None
            picked = qmm.plan(m, k, n, kind, sms)
            # (row tile, splits): more splits up to 256 rows, the other row
            # tiles above
            if m <= 64:
                tries = [(64, sp) for sp in sorted(set(SWEEP) | {picked.splits})]
            elif m <= 256:
                tries = [(bm, sp) for bm in qmm.WS_ROWS[:2] for sp in (1, 2, 4)]
            else:
                tries = [(bm, 1) for bm in qmm.WS_ROWS[1:]]
            tries = sorted(set(tries) | {(picked.bm, picked.splits)})
            tries = [(bm, sp) for bm, sp in tries if sp <= -(-k // 64)]
            key = f"{picked.bm}/{picked.splits}"
        times = {}
        for bm, sp in tries:
            p = (qmm.int8_layout if kind == "int8" else qmm.layout)(m, k, n, sp, bm, sms)
            times[f"{bm}/{sp}"] = cs.time_ms(
                lambda i: qmm.launch_prepared(name, xin, sx, w, s, i % LAYERS, p))[0]
        rows.append({"shape": f"{model} {proj} M {m} {kind}", "picked": key,
                     "ms_by_rows_splits": times})
        best = min(times, key=times.get)
        print(f"sweep {rows[-1]['shape']}: picked {key} "
              f"({times[key]:.4f} ms), best {best} ({times[best]:.4f} ms): "
              + ", ".join(f"{sp}: {t:.4f}" for sp, t in times.items()), flush=True)
        del w, s
        torch.cuda.empty_cache()
    return rows


def compare(parent: Path, kinds: str) -> dict:
    """Parent, this tree, this tree, parent, each in its own process."""
    runs = {"parent": [], "this": []}
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time-root",
                              str(root), "--kinds", kinds], capture_output=True, text=True,
                             timeout=900)
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
        extra = ""
        for key in ("launch_ms", "quant_ms"):  # K5: the GEMM launch and the quantizer alone
            if key in row:
                table[-1]["was_" + key] = min(r[i][key] for r in runs["parent"])
                table[-1][key] = min(r[i][key] for r in runs["this"])
                extra += f"; {key[:-3]} {table[-1]['was_' + key]:.4f} -> {table[-1][key]:.4f}"
        print(f"{row['shape']}: parent {was:.4f} ms, this {now:.4f} ms ({was / now:.2f}x); "
              f"host {hw:.1f} -> {hn:.1f} us a call{extra}", flush=True)
    return {"compare": table, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, help="a checkout of another commit")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma list of weight kinds: " + ", ".join(KINDS))
    ap.add_argument("--time-root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kinds = args.kinds.split(",")
    if not set(kinds) <= set(KINDS):
        raise SystemExit(f"unknown kinds {sorted(set(kinds) - set(KINDS))}")
    shapes = [sh for sh in SHAPES if sh[5] in kinds]
    if not torch.cuda.is_available():
        print("probe_qmm_kernel: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.time_root is not None:  # one timing process of --compare
        cs, _build, qmm = _imports(args.time_root.resolve())
        _build.build_all()
        print(json.dumps(time_shapes(cs, qmm, dev, shapes, library=False)))
        return 0
    cs, _build, qmm = _imports(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    if args.compare is not None:
        res = compare(args.compare.resolve(), args.kinds)
    else:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        for line in _build.build_log.get("quant_matmul", "").splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "error", "Compiling")):
                print(line.strip(), flush=True)
        res = {}
        if "int8" in kinds:
            res["int8_checks"] = check_int8(cs, qmm, dev)
            print(f"K5 checks passed: {res['int8_checks']} shapes bit-equal (quantizer, "
                  "split model)", flush=True)
        worst = check(cs, qmm, dev, kinds)
        print(f"checks passed: worst error {worst:.4f} x its bound ({cs.QMM_TOL})", flush=True)
        res["worst_ratio"] = worst
        if args.sweep:
            res["sweep"] = sweep(cs, qmm, dev, shapes, kinds)
        res["timed"] = time_shapes(cs, qmm, dev, shapes, library=True)
        for r in res["timed"]:
            alone = ("" if "launch_ms" not in r else
                     f" (launch alone {r['launch_ms']:.4f}, quantizer {r['quant_ms']:.4f})")
            print(f"{r['shape']} ({r['plan']}): kernel {r['ms']:.4f} ms{alone}, library "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"host {r['host_us']:.1f} us", flush=True)
    print(card)
    print(json.dumps(dict(res, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
