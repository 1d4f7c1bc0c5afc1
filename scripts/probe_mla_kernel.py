#!/usr/bin/env python3
"""Quick check and timing of the MLA prefill kernel (K11b, K11e:
``csrc/mla_prefill.cu``) or, with ``--kernel decode``, of the MLA decode
kernel (K11a: ``csrc/mla_attention.cu`` ``mla_decode_kernel``) on one GPU.

    python3 scripts/probe_mla_kernel.py [--kernel decode] [--check-only]
    python3 scripts/probe_mla_kernel.py [--kernel decode] --compare PARENT_DIR

``--kernel decode``: prints what ptxas says of ``csrc/mla_attention.cu``
(registers, spills a kernel instance), holds K11a to its plain version at
16 sequences over ``chip_smoke.MLA_DECODE_LENS`` at 16, 20 and 128 heads on
bf16 and fp8 latent caches within ``chip_smoke.MLA_TOL`` (caches
byte-equal, padded rows zeros) and on grid inputs at block_size 16-128
(16 and 20 heads, bf16 and fp8, contexts whose split edges fall inside a
page) within ``chip_smoke.TOL``, then times it at 16, 20 and 128 heads beside
SDPA's math backend over the gathered latent and the byte bound, and times
the row-scatter writers (``csrc/kv_write.cu``: K2, K4, K2b, K4b, K8's and
K9's, K11c, K11d, K11f, K11g) at the smoke's shapes on every cache they
serve, each checked byte-equal first.

Without ``--compare``: builds the kernels, prints what ptxas says of
``csrc/mla_prefill.cu`` (registers, spills), names the SDPA backends that
accept the latent shapes (Dk 640, dv 512), holds the wrappers to their
plain versions at every probed shape within ``chip_smoke.MLA_TOL`` (random
inputs; rows past ntok and padded chunks zeros) and on grid inputs at
block_size 16-128 within ``chip_smoke.TOL`` (16 and 20 heads: P rounded per
page as the TPU walk rounds it), then (unless ``--check-only``) times each
shape beside SDPA's math backend over the gathered latent, the bound
(operations or bytes, from the shape) and the achieved TFLOP/s.

The shapes are DeepSeek-V2-Lite's (16 heads, Dk 640 of which 576 live, dv
512, block_size 64) at the smoke's chunk buckets: K11b over the chunks of
the 2048, 512 and 64 buckets, K11e over one chunk of 2,048 tokens from
q_offset 0 and from 2048, 300 tokens in the 512 bucket and 52 at q_offset
2048 in the 64 bucket; the 512 and 64 buckets also at DeepSeek-V3's 128
heads. Each on a bf16 and an fp8 (e4m3) latent cache, q bf16.

With ``--compare PARENT_DIR`` (a checkout of another commit, for example
``git archive`` of the parent unpacked into a directory that .gitignore
lists): times the shapes with each tree's own wrappers, in four processes
in turns (parent, this tree, this tree, parent), and prints the better time
of each tree per shape and their ratio.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# (label, single chunk (K11e), S, [(q_offset, ntok)], heads)
SHAPES = [
    ("K11b S 2048 (2048 + 700 tokens, one padded)", False, 2048, [(0, 2048), (0, 700), (0, 0)], 16),
    ("K11b S 512 (300, 512, 188 at 512, one padded)", False, 512,
     [(0, 300), (0, 512), (512, 188), (0, 0)], 16),
    ("K11b S 64 (52 at 2048, 40, one padded)", False, 64, [(2048, 52), (0, 40), (0, 0)], 16),
    ("K11e S 2048 from q_offset 0", True, 2048, [(0, 2048)], 16),
    ("K11e S 2048 from q_offset 2048", True, 2048, [(2048, 2048)], 16),
    ("K11e 300 tokens in S 512", True, 512, [(0, 300)], 16),
    ("K11e 52 tokens at q_offset 2048 in S 64", True, 64, [(2048, 52)], 16),
    ("K11b S 512, H 128", False, 512, [(0, 300), (0, 512), (512, 188), (0, 0)], 128),
    ("K11b S 64, H 128", False, 64, [(2048, 52), (0, 40), (0, 0)], 128),
    ("K11e 52 tokens at q_offset 2048 in S 64, H 128", True, 64, [(2048, 52)], 128),
]
CACHES = (None, "fp8_e4m3")


def _imports(root: Path):
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from xllm_tpu_torch.ops.cuda import _build
    from xllm_tpu_torch.ops.cuda import mla_attention as k11
    return cs, _build, k11


def _fns(k11, single: bool):
    """-> (kernel, plain), each f(q, cache, layer, bt, qo, kvl, scale, dv) on
    P-chunk tensors (K11e sees chunk 0 through its one-chunk wrappers)."""
    if not single:
        return k11.mla_prefill_attention_batched, k11.mla_prefill_attention_batched_plain

    def one(fn):
        return lambda q, c, layer, bt, qo, kvl, scale, dv: fn(q[0], c, layer, bt[0], qo[0],
                                                             kvl[0], scale, dv)[None]
    return one(k11.mla_prefill_attention), one(k11.mla_prefill_attention_plain)


def inputs(cs, dev, s: int, rows, h: int, cache):
    """Latent caches of ``cs.LAYERS`` layers, q and tables; block tables as
    wide as the chunks need at 128 heads (the plain version's scores fit)."""
    rng = np.random.default_rng(3)
    nb, btt, qo, _, kvl = cs._chunk_tables(rng, rows, dev)
    if h > 20:
        btt = btt[:, : -(-max(a + n for a, n in rows) // cs.BS)].contiguous()
    g = torch.Generator(device=dev).manual_seed(4)
    c = cs.latent_rand(g, dev, torch.bfloat16, cs.LAYERS, nb, 1, cs.BS, cs.MLA_DK, cache=cache)
    q = cs.latent_rand(g, dev, torch.bfloat16, len(rows), s, h, cs.MLA_DK)
    return dict(q=q, c=c, btt=btt, qo=qo, kvl=kvl)


def check(cs, k11, dev) -> float:
    """Each shape and cache against the plain version within MLA_TOL."""
    worst = 0.0
    for label, single, s, rows, h in SHAPES:
        for cache in CACHES:
            x = inputs(cs, dev, s, rows, h, cache)
            kernel, plain = _fns(k11, single)
            a = (x["q"], x["c"], 5, x["btt"], x["qo"], x["kvl"], cs.MLA_SCALE, cs.MLA_DV)
            out, ref = kernel(*a), plain(*a)
            cs.sync()
            p = len(rows)
            lim = k11.prefill_row_limits(s, h, x["qo"], x["kvl"])
            pv = cs.pv_abs(x["q"].reshape(p, s * h, cs.MLA_DK),
                           k11._gather_latent(x["c"], 5, x["btt"]), lim,
                           cs.MLA_SCALE).reshape(out.shape)
            what = f"{label}, cache {cache or 'bf16'}"
            worst = max(worst, cs.check_mla_close(out, ref, pv, what, rounds=cache is not None))
            for i, (_, n) in enumerate(rows):
                assert not out[i, n:].float().abs().any(), f"{what}: chunk {i} past ntok"
            del out, ref, pv, x
            cs.free_device_memory()
    return worst


def check_grid(cs, k11, dev) -> float:
    """Grid inputs (exact scores) at block_size 16-128, 16 and 20 heads,
    bf16 and fp8 latent caches, K11b and K11e, within TOL."""
    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    for bs in cs.PAGE_SIZES:
        nbmax = 4096 // bs
        for cache in CACHES:
            scale = cs.grid_scale(cache, mla=True)
            for (s, rows), h in [(sr, h) for sr in cs.PAGE_ROWS.items() for h in (16, 20)]:
                bt, nb = cs._paged(rng, [a + n for a, n in rows], bs, nbmax)
                c = cs.mla_grid(g, dev, torch.bfloat16, 2, nb, 1, bs, cs.MLA_DK, cache=cache)
                q = cs.mla_grid(g, dev, torch.bfloat16, len(rows), s, h, cs.MLA_DK)
                btt = cs.i32(bt, dev)
                qo = cs.i32([a for a, _ in rows], dev)
                kvl = cs.i32([a + n if n else 0 for a, n in rows], dev)
                for single in (False, True):
                    kernel, plain = _fns(k11, single)
                    sel = slice(0, 1) if single else slice(None)
                    a = (q[sel], c, 1, btt[sel], qo[sel], kvl[sel], scale, cs.MLA_DV)
                    out, ref = kernel(*a), plain(*a)
                    cs.sync()
                    worst = max(worst, cs.check_close(
                        out, ref, f"grid bs {bs} cache {cache or 'bf16'} S {s} H {h} "
                                  f"{'K11e' if single else 'K11b'}"))
            cs.free_device_memory()
    return worst


def sdpa_backends(cs, dev) -> list[str]:
    """The SDPA backends that take q [1, 16, 64, 640] against one latent
    head of 640 (K) / 512 (V) lanes with a boolean mask."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = torch.randn(1, 16, 64, cs.MLA_DK, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 1, 128, cs.MLA_DK, device=dev, dtype=torch.bfloat16)
    v = k[..., : cs.MLA_DV]
    mask = torch.ones(1, 1, 64, 128, dtype=torch.bool, device=dev)
    ok = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                cs.sdpa(q, k, v, mask, cs.MLA_SCALE)
            torch.cuda.synchronize()
            ok.append(b.name)
        except RuntimeError:
            continue
    return ok


def time_shapes(cs, k11, dev, library: bool = True) -> list[dict]:
    out = []
    for label, single, s, rows, h in SHAPES:
        for cache in CACHES:
            x = inputs(cs, dev, s, rows, h, cache)
            kernel, _ = _fns(k11, single)
            args = lambda i: (x["q"], x["c"], i % cs.LAYERS, x["btt"], x["qo"],  # noqa: E731
                              x["kvl"], cs.MLA_SCALE, cs.MLA_DV)
            ms, queued = cs.time_ms(lambda i: kernel(*args(i)))
            assert queued, f"{label}: the wrapper waited on the device"
            p = len(rows)
            ntok = sum(n for _, n in rows)
            kv_rows = sum(a + n for a, n in rows if n)
            pairs = sum(sum(a + i + 1 for i in range(n)) for a, n in rows)
            el = x["c"].element_size()
            nbytes = (ntok * h * cs.MLA_DK + ntok * h * cs.MLA_DV) * 2 + kv_rows * cs.MLA_DK * el
            flops = 2.0 * pairs * h * (cs.MLA_DK_LIVE + cs.MLA_DV)
            bound, by = cs.bound_ms(nbytes, flops)
            lib = None
            if library:  # SDPA (math) over the gathered latent, an fp8 cache upcast
                lmax = -(-max(a + n for a, n in rows) // cs.BS) * cs.BS
                idx = x["btt"][:, : lmax // cs.BS].long()
                kg = [x["c"][l][idx].reshape(p, 1, lmax, cs.MLA_DK).to(torch.bfloat16)
                      for l in range(cs.LAYERS)]
                vg = [k_[..., : cs.MLA_DV].contiguous() for k_ in kg]
                qpos = x["qo"].long()[:, None] + torch.arange(s, device=dev)[None, :]
                kvi = torch.arange(lmax, device=dev)
                mask = ((kvi[None, None, :] <= qpos[:, :, None])
                        & (kvi[None, None, :] < x["kvl"].long()[:, None, None]))[:, None]
                qt = x["q"].transpose(1, 2)
                lib = cs.time_ms(lambda i: cs.sdpa(qt, kg[i % cs.LAYERS], vg[i % cs.LAYERS],
                                                   mask, cs.MLA_SCALE), iters=5)[0]
                del kg, vg, mask
            out.append(dict(shape=f"{label}, cache {cache or 'bf16'}", ms=ms, library_ms=lib,
                            bound_ms=bound, bound_by=by, tflops=flops / ms / 1e9,
                            gflop=flops / 1e9))
            print(f"{out[-1]['shape']}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                  f"SDPA {lib if lib is None else round(lib, 4)} ms, bound {bound:.4f} ms "
                  f"({by})", flush=True)
            del x
            cs.free_device_memory()
    return out


def compare(parent: Path, kernel: str) -> dict:
    """Parent, this tree, this tree, parent, each in its own process."""
    runs = {"parent": [], "this": []}
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time-root",
                              str(root), "--kernel", kernel], capture_output=True, text=True,
                             timeout=1200)
        if res.returncode != 0:
            raise RuntimeError(f"{tag} run failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"{tag} run: {time.perf_counter() - t0:.1f} s", flush=True)
    table = []
    for i, row in enumerate(runs["this"][0]):
        was = min(r[i]["ms"] for r in runs["parent"])
        now = min(r[i]["ms"] for r in runs["this"])
        table.append({"shape": row["shape"], "was_ms": was, "ms": now, "speedup": was / now,
                      "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                      "tflops": row["gflop"] / now, "peak_share": row["bound_ms"] / now,
                      "ms_runs": [r[i]["ms"] for r in runs["this"]],
                      "was_ms_runs": [r[i]["ms"] for r in runs["parent"]]})
        print(f"{row['shape']}: parent {was:.4f} ms, this {now:.4f} ms ({was / now:.2f}x); "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{row['gflop'] / now:.1f} TFLOP/s", flush=True)
    return {"compare": table, "runs": runs}


# K11a: (label, heads), each at chip_smoke.MLA_DECODE_LENS (B 16)
DECODE_SHAPES = [("K11a B 16, H 16", 16), ("K11a B 16, H 20", 20), ("K11a B 16, H 128", 128)]


def decode_check(cs, k11, dev) -> float:
    """K11a at every DECODE_SHAPES row and cache against the plain version
    within MLA_TOL (chip_smoke.check_mla_decode: caches byte-equal, padded
    rows zeros)."""
    rng = np.random.default_rng(5)
    worst = 0.0
    for label, h in DECODE_SHAPES:
        for cache in CACHES:
            err = cs.check_mla_decode(rng, dev, torch.bfloat16, False, h=h,
                                      cache=cache)["max_abs_err"]
            print(f"{label}, cache {cache or 'bf16'}: max abs err {err:.3g}", flush=True)
            worst = max(worst, err)
            cs.free_device_memory()
    return worst


# grid contexts: seq_len 1, a new token that opens a page, lengths whose
# split edges (64-position units over the cluster) fall inside pages of
# 128, a full table, a padded row
DECODE_GRID_LENS = [1, 65, 129, 700, 1000, 2100, 4095, 4096, 0]


def decode_check_grid(cs, k11, dev) -> float:
    """K11a on grid inputs (exact scores) at block_size 16-128, 16 and 20
    heads, bf16 and fp8 latent caches, within TOL; caches byte-equal."""
    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    lens = DECODE_GRID_LENS
    for bs in cs.PAGE_SIZES:
        nbmax = 4096 // bs
        bt, nb = cs._paged(rng, lens, bs, nbmax)
        btt, sl = cs.i32(bt, dev), cs.i32(lens, dev)
        sm = cs.i32([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                     for i, n in enumerate(lens)], dev)
        for cache in CACHES:
            scale = cs.grid_scale(cache, mla=True)
            c = cs.mla_grid(g, dev, torch.bfloat16, 2, nb, 1, bs, cs.MLA_DK, cache=cache)
            for h in (16, 20):
                q = cs.mla_grid(g, dev, torch.bfloat16, len(lens), h, cs.MLA_DK)
                ln = cs.mla_grid(g, dev, torch.bfloat16, len(lens), cs.MLA_DK)
                ck, cp = c.clone(), c.clone()
                out = k11.mla_decode_attention_write(q, ln, ck, 1, sm, btt, sl, scale, cs.MLA_DV)
                ref = k11.mla_decode_attention_write_plain(q, ln, cp, 1, sm, btt, sl, scale,
                                                           cs.MLA_DV)
                cs.sync()
                what = f"K11a grid bs {bs} cache {cache or 'bf16'} H {h}"
                assert cs.same_bytes(ck, cp), f"{what}: caches differ"
                assert not out[-1].float().abs().any(), f"{what}: padded row not zeros"
                worst = max(worst, cs.check_close(out, ref, what))
            cs.free_device_memory()
    return worst


def writer_time(cs, dev) -> list[dict]:
    """The row-scatter writers at the smoke's timed shapes, bf16 rows:
    chip_smoke's writer checks (caches byte-equal to the plain versions,
    then kernel, plain and index-assignment times)."""
    rng = np.random.default_rng(7)
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    rows = []
    for c in (None, "int8", "fp8_e4m3"):
        rows += [(f"K2 cache {c or 'bf16'}", lambda c=c: cs.check_writer(rng, dev, bf, True, False, cache=c)),
                 (f"K4 cache {c or 'bf16'}", lambda c=c: cs.check_writer(rng, dev, bf, True, True, cache=c)),
                 (f"K2b cache {c or 'bf16'}", lambda c=c: cs.check_single_writer(rng, dev, bf, True, False, cache=c)),
                 (f"K4b cache {c or 'bf16'}", lambda c=c: cs.check_single_writer(rng, dev, bf, True, True, cache=c))]
        for rmw in (False, True):
            s_, chunks = cs.ILV_WRITES[rmw][0]
            rows.append((f"K8 {'rmw' if rmw else 'prefill'} writer cache {c or 'bf16'}",
                         lambda c=c, rmw=rmw, s_=s_, chunks=chunks: cs.check_ilv_writer(
                             rng, dev, g, bf, c, rmw, False, s_, chunks, timed=True)))
    for c in (None, "fp8_e4m3"):
        s_, chunks = cs.ILV_WRITES[False][0]
        rows += [(f"K9 prefill writer cache {c or 'bf16'}",
                  lambda c=c, s_=s_, chunks=chunks: cs.check_ilv_writer(
                      rng, dev, g, bf, c, False, True, s_, chunks, timed=True)),
                 (f"K11c cache {c or 'bf16'}", lambda c=c: cs.check_latent_writer(rng, dev, bf, True, False, cache=c)),
                 (f"K11d cache {c or 'bf16'}", lambda c=c: cs.check_latent_writer(rng, dev, bf, True, True, cache=c)),
                 (f"K11f cache {c or 'bf16'}", lambda c=c: cs.check_single_latent_writer(rng, dev, bf, True, False, cache=c)),
                 (f"K11g cache {c or 'bf16'}", lambda c=c: cs.check_single_latent_writer(rng, dev, bf, True, True, cache=c))]
    out = []
    for label, fn in rows:
        r = fn()
        out.append(dict(shape=label, ms=r["ms"], library_ms=r["library_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"], gflop=0.0))
        print(f"{label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, index assign "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        cs.free_device_memory()
    return out


def decode_time(cs, k11, dev, library: bool = True) -> list[dict]:
    """K11a at DECODE_SHAPES' 16, 20 and 128 heads on each cache
    (chip_smoke.check_mla_decode's timing: kernel, plain, SDPA math), then
    the writers (``writer_time``)."""
    out = []
    rng = np.random.default_rng(6)
    for label, h in DECODE_SHAPES:
        for cache in CACHES:
            r = cs.check_mla_decode(rng, dev, torch.bfloat16, True, h=h, cache=cache)
            lib = r["library_ms"] if library else None
            row = dict(shape=f"{label}, cache {cache or 'bf16'}", ms=r["ms"], library_ms=lib,
                       plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                       gflop=0.0)
            out.append(row)
            print(f"{row['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA "
                  f"{lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
            cs.free_device_memory()
    return out + writer_time(cs, dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("prefill", "decode"), default="prefill",
                    help="the prefill kernel (K11b, K11e) or the decode kernel (K11a)")
    ap.add_argument("--compare", type=Path, help="a checkout of another commit")
    ap.add_argument("--check-only", action="store_true", help="build and check, no timing")
    ap.add_argument("--time-root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mla_kernel: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    decode = args.kernel == "decode"
    if args.time_root is not None:  # one timing process of --compare
        cs, _build, k11 = _imports(args.time_root.resolve())
        _build.build_all()
        timer = decode_time if decode else time_shapes
        print(json.dumps(timer(cs, k11, dev, library=False)))
        return 0
    cs, _build, k11 = _imports(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    if args.compare is not None:
        res = compare(args.compare.resolve(), args.kernel)
    else:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        source = "mla_attention" if decode else "mla_prefill"
        for line in _build.build_log.get(source, "").splitlines():
            if "C7519" in line:  # wgmma fences the compiler placed: one line each
                continue
            if any(w in line for w in ("registers", "spill", "warning", "error", "Compiling",
                                       "serialized")):
                print(line.strip(), flush=True)
        backends = sdpa_backends(cs, dev)
        print(f"SDPA backends that take Dk {cs.MLA_DK} / dv {cs.MLA_DV}: {backends}", flush=True)
        if decode:
            worst = decode_check(cs, k11, dev)
            print(f"checks passed: worst max-abs error {worst:.3g} ({cs.MLA_TOL})", flush=True)
            grid = decode_check_grid(cs, k11, dev)
        else:
            worst = check(cs, k11, dev)
            print(f"checks passed: worst max-abs error {worst:.3g} ({cs.MLA_TOL})", flush=True)
            grid = check_grid(cs, k11, dev)
        print(f"grid checks passed at block_size {cs.PAGE_SIZES}: worst {grid:.3g} "
              f"({cs.tol_text(torch.bfloat16)})", flush=True)
        res = {"worst_err": worst, "grid_err": grid, "sdpa_backends": backends}
        if not args.check_only:
            res["timed"] = (decode_time if decode else time_shapes)(cs, k11, dev)
    print(card)
    print(json.dumps(dict(res, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
