#!/usr/bin/env python3
"""Quick check and timing of the decode-attention kernel (K1, K1b, K8, K9,
K12a: ``csrc/decode_attention.cu``) on one GPU.

    python3 scripts/probe_decode_attention_kernel.py
    python3 scripts/probe_decode_attention_kernel.py --compare PARENT_DIR

Without ``--compare``: builds the kernels, prints what ptxas says of
``csrc/decode_attention.cu``, holds the wrapper to its plain version at
every probed shape (random inputs, ``chip_smoke.QUANT_TOL``'s bound; caches
byte-equal), then times each shape beside one PyTorch call over K / V
gathered contiguous (SDPA), the bound, and the achieved rate (the bytes the
call must move over its time).

The shapes are the served decode steps: 16 sequences, qwen3-1.7B's heads
(Hq 16, Hkv 8) and Qwen3-8B's (Hq 32, Hkv 8: G 4), head_dim 128, block_size
64, bf16 / int8 / fp8 caches; the smoke's context mix (56-2,116 tokens, two
padded rows) in a block table of 4,096 positions, and longer contexts
(1,000-8,100) in one of 8,192; K1 (v9), K1b (v5), K12a (v1), K8 on the
interleaved cache, K9 on interleaved_rm (once with rows that complete
their page).

With ``--compare PARENT_DIR`` (a checkout of another commit, for example
``git archive`` of the parent unpacked into a directory that .gitignore
lists): times the shapes with each tree's own wrapper, in four processes in
turns (parent, this tree, this tree, parent), and prints the better time of
each tree per shape and their ratio.

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
B = 16
D, BS = 128, 64
LAYERS = 8  # cache layers the timing loop rotates over: each call reads cold K / V
SERVED = [56, 316, 716, 2116] * 3 + [56, 316] + [0, 0]
LONG = [1000, 3000, 5000, 8100] * 4
# rows whose new token completes its page (K9 rewrites it canonical)
COMPLETING = [64, 320, 704, 2112] * 3 + [64, 320] + [0, 0]
# (label, kernel, Hq, cache, table width, lens)
SHAPES = [
    ("K1 bf16, qwen3-1.7B, table 4096", "v9", 16, None, 4096, SERVED),
    ("K1 int8, qwen3-1.7B, table 4096", "v9", 16, "int8", 4096, SERVED),
    ("K1 fp8, qwen3-1.7B, table 4096", "v9", 16, "fp8_e4m3", 4096, SERVED),
    ("K1 bf16, qwen3-1.7B, table 8192", "v9", 16, None, 8192, LONG),
    ("K1 fp8, qwen3-1.7B, table 8192", "v9", 16, "fp8_e4m3", 8192, LONG),
    ("K1 bf16, Qwen3-8B G 4, table 4096", "v9", 32, None, 4096, SERVED),
    ("K1 int8, Qwen3-8B G 4, table 4096", "v9", 32, "int8", 4096, SERVED),
    ("K1 fp8, Qwen3-8B G 4, table 4096", "v9", 32, "fp8_e4m3", 4096, SERVED),
    ("K1 bf16, Qwen3-8B G 4, table 8192", "v9", 32, None, 8192, LONG),
    ("K1b (v5) bf16, qwen3-1.7B, table 4096", "v5", 16, None, 4096, SERVED),
    ("K12a (v1) bf16, qwen3-1.7B, table 4096", "v1", 16, None, 4096, SERVED),
    ("K8 bf16, qwen3-1.7B, table 4096", "ilv", 16, None, 4096, SERVED),
    ("K8 int8, Qwen3-8B G 4, table 4096", "ilv", 32, "int8", 4096, SERVED),
    ("K9 bf16, qwen3-1.7B, table 4096", "rm", 16, None, 4096, SERVED),
    ("K9 bf16, pages completed, table 4096", "rm", 16, None, 4096, COMPLETING),
    ("K9 fp8, qwen3-1.7B, table 4096", "rm", 16, "fp8_e4m3", 4096, SERVED),
]


def _imports(root: Path):
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from xllm_tpu_torch.ops.cuda import _build
    from xllm_tpu_torch.ops.cuda import decode_attention as k1
    return cs, _build, k1


def _fns(k1, kernel: str):
    """-> (wrapper, plain, interleaved layout?)."""
    if kernel == "ilv":
        return k1.paged_decode_attention_write_ilv, k1.paged_decode_attention_write_ilv_plain, True
    if kernel == "rm":
        return k1.paged_decode_attention_write_rm, k1.paged_decode_attention_write_rm_plain, True
    v = k1.VARIANTS[kernel]
    return v, v.plain, False


def inputs(cs, dev, hq: int, cache, width: int, lens, hkv: int = 8):
    """Random caches of LAYERS layers, q, new rows and tables of one step."""
    nbmax = width // BS
    rng = np.random.default_rng(7)
    nb = 1 + sum(-(-n // BS) for n in lens) + 8
    free = rng.permutation(np.arange(1, nb)).tolist()
    bt = np.zeros((len(lens), nbmax), np.int32)
    for i, n in enumerate(lens):
        bt[i, : -(-n // BS)] = [free.pop() for _ in range(-(-n // BS))]
    slots = [bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0 for i, n in enumerate(lens)]
    g = torch.Generator(device=dev).manual_seed(1)
    dtype = torch.bfloat16
    q = (torch.randn(len(lens), hq, D, generator=g, device=dev) * cs.q_scale(cache)).to(dtype)
    kn = cs.new_rows(g, dev, (len(lens), hkv, D), dtype, cache)
    vn = cs.new_rows(g, dev, (len(lens), hkv, D), dtype, cache)
    kc = cs.kv_tensor(g, dev, (LAYERS, nb, hkv, BS, D), dtype, cache)
    vc = cs.kv_tensor(g, dev, (LAYERS, nb, hkv, BS, D), dtype, cache)
    return dict(q=q, kn=kn, vn=vn, kc=kc, vc=vc, bt=bt, sm=cs.i32(slots, dev),
                btt=cs.i32(bt, dev), sl=cs.i32(lens, dev), hkv=hkv, lens=lens, cache=cache)


def _call(fn, ilv: bool, x, kc, vc, layer: int):
    scale = D ** -0.5
    if ilv:
        return fn(x["q"], x["kn"], x["vn"], kc, layer, x["sm"], x["btt"], x["sl"], scale)
    return fn(x["q"], x["kn"], x["vn"], kc, vc, layer, x["sm"], x["btt"], x["sl"], scale)


def _caches(x, ilv: bool):
    if ilv:
        kv = torch.stack([x["kc"], x["vc"]], dim=2).contiguous()  # [L, NB, 2, Hkv, bs, D]
        return kv, None
    return x["kc"], x["vc"]


def check(cs, k1, dev) -> float:
    """Each shape's wrapper against its plain version -> the worst error."""
    worst = 0.0
    for label, kernel, hq, cache, width, lens in SHAPES:
        x = inputs(cs, dev, hq, cache, width, lens)
        fn, plain, ilv = _fns(k1, kernel)
        kk, vk = (t.clone() if t is not None else None for t in _caches(x, ilv))
        kp, vp = (t.clone() if t is not None else None for t in _caches(x, ilv))
        out = _call(fn, ilv, x, kk, vk, 3)
        ref = _call(plain, ilv, x, kp, vp, 3)
        # sum_j p_j |v_j|: the plain version's f32 softmax over |V|, on the
        # caches as they were before the call
        k0, v0 = _caches(x, ilv)
        xa = dict(x, q=x["q"].float(), kn=x["kn"].float(), vn=x["vn"].float().abs())
        if ilv:
            ka = k0.float()
            ka[:, :, 1] = ka[:, :, 1].abs()
            if kernel == "rm":  # tail pages are token-major: K heads, then V heads
                for i, n in enumerate(lens):
                    if n:
                        blk = int(x["bt"][i, (n - 1) // BS])
                        pg = k0[:, blk].float().reshape(LAYERS, BS, 2 * x["hkv"], D)
                        pg[:, :, x["hkv"]:] = pg[:, :, x["hkv"]:].abs()
                        ka[:, blk] = pg.reshape(ka[:, blk].shape)
            pv = _call(plain, ilv, xa, ka, None, 3)
        else:
            pv = _call(plain, ilv, xa, k0.float(), v0.float().abs(), 3)
        cs.sync()
        worst = max(worst, cs.check_quant_close(out, ref, pv, label))
        assert cs.same_bytes(kk, kp) and (vk is None or cs.same_bytes(vk, vp)), f"{label}: caches"
        pad = torch.tensor([n == 0 for n in lens], device=dev)
        assert not out[pad].float().abs().any(), f"{label}: padded rows must be zeros"
    return worst


def time_shapes(cs, k1, dev) -> list[dict]:
    rows = []
    for label, kernel, hq, cache, width, lens in SHAPES:
        x = inputs(cs, dev, hq, cache, width, lens)
        fn, _, ilv = _fns(k1, kernel)
        kc, vc = _caches(x, ilv)
        ms, queued = cs.time_ms(lambda i: _call(fn, ilv, x, kc, vc, i % LAYERS))
        assert queued, f"{label}: the wrapper waited on the device"
        host = cs.host_us(lambda i: _call(fn, ilv, x, kc, vc, i % LAYERS))
        hkv, b = x["hkv"], len(lens)
        # SDPA over K / V gathered contiguous (a 1-byte cache upcast to bf16)
        lmax = -(-max(lens) // BS) * BS
        idx = x["btt"][:, : lmax // BS].long()
        kg = [x["kc"][l][idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, lmax, D).to(torch.bfloat16)
              for l in range(LAYERS)]
        vg = [x["vc"][l][idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, lmax, D).to(torch.bfloat16)
              for l in range(LAYERS)]
        mask = (torch.arange(lmax, device=dev)[None, :] < x["sl"][:, None].long())[:, None, None]
        q4 = x["q"][:, :, None, :]
        lib, _ = cs.time_ms(lambda i: cs.sdpa(q4, kg[i % LAYERS], vg[i % LAYERS], mask,
                                              D ** -0.5))
        del kg, vg
        c_el = x["kc"].element_size()
        ntok = sum(lens)
        nbytes = (2 * b * hq * D * 2 + 2 * b * hkv * D * (x["kn"].element_size() + c_el)
                  + 2 * ntok * hkv * D * c_el)
        if kernel == "rm":  # a completed page written whole
            nbytes += sum(1 for n in lens if n and n % BS == 0) * 2 * hkv * BS * D * c_el
        bound, by = cs.bound_ms(nbytes, 4.0 * ntok * hq * D)
        rows.append(dict(shape=label, ms=ms, library_ms=lib, bound_ms=bound, bound_by=by,
                         host_us=host, gbps=nbytes / ms / 1e6, mbytes=nbytes / 1e6))
    return rows


def _plan_knobs(k1, bps: int, tiles: int) -> None:
    k1._BLOCKS_PER_SM, k1._SPLIT_TILES = bps, tiles


def sweep(cs, k1, dev, settings) -> list[dict]:
    """Each shape timed at each (blocks an SM the cluster plan aims at,
    least tiles of a split) of ``settings``."""
    rows = []
    keep = (k1._BLOCKS_PER_SM, k1._SPLIT_TILES)
    for label, kernel, hq, cache, width, lens in SHAPES:
        x = inputs(cs, dev, hq, cache, width, lens)
        fn, _, ilv = _fns(k1, kernel)
        kc, vc = _caches(x, ilv)
        times = {}
        for bps, tiles in settings:
            _plan_knobs(k1, bps, tiles)
            times[f"{bps}:{tiles}"] = cs.time_ms(lambda i: _call(fn, ilv, x, kc, vc,
                                                                i % LAYERS))[0]
        _plan_knobs(k1, *keep)
        rows.append({"shape": label, "ms_by_bps_tiles": times})
        print(f"{label}: " + ", ".join(f"{k} {t:.4f}" for k, t in times.items()), flush=True)
    return rows


SCAN_TILES = (1, 2, 4, 6, 8, 12, 16)


def scan(cs, k1, dev) -> list[dict]:
    """K1 bf16 at one context length for every row, in a block table as
    wide as the engine's runner buckets it (a power of two of pages, at
    least 4), by the least tiles of a split beyond a block an SM
    (``_SPLIT_TILES``): one, 4 and 16 sequences of qwen3-1.7B's heads (Hq
    16, Hkv 8) and 16 of Qwen3-30B-A3B's (Hq 32, Hkv 4); the engine's
    uniform decode steps."""
    rows = []
    fn, _, _ = _fns(k1, "v9")
    keep = k1._SPLIT_TILES
    for b, hq, hkv in ((1, 16, 8), (4, 16, 8), (16, 16, 8), (16, 32, 4)):
        for n in (300, 552, 1024, 2112, 4096):
            pages = -(-n // BS)
            width = BS * max(4, 1 << (pages - 1).bit_length())
            x = inputs(cs, dev, hq, None, width, [n] * b, hkv)
            times, clusters = {}, {}
            for tiles in SCAN_TILES:
                k1._SPLIT_TILES = tiles
                clusters[tiles] = k1.plan(width // BS, BS, hq // hkv, D, torch.bfloat16,
                                          heads=b * hkv, sms=cs._build.device_sms(dev)).cluster
                times[tiles] = cs.time_ms(lambda i: _call(fn, False, x, x["kc"], x["vc"],
                                                          i % LAYERS))[0]
            k1._SPLIT_TILES = keep
            rows.append({"batch": b, "hq": hq, "hkv": hkv, "seq_len": n, "table": width,
                         "ms_by_split_tiles": times, "cluster_by_split_tiles": clusters})
            print(f"scan B {b} Hq {hq} Hkv {hkv} seq_len {n} table {width}: " + ", ".join(
                f"tiles {t} (cluster {clusters[t]}) {v:.4f}" for t, v in times.items()),
                flush=True)
    return rows


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
        lib = min(r[i]["library_ms"] for r in runs["this"] + runs["parent"])
        table.append({"shape": row["shape"], "was_ms": was, "ms": now, "speedup": was / now,
                      "library_ms": lib, "bound_ms": row["bound_ms"],
                      "gbps": row["mbytes"] / now, "was_gbps": row["mbytes"] / was})
        print(f"{row['shape']}: parent {was:.4f} ms, this {now:.4f} ms ({was / now:.2f}x); "
              f"SDPA {lib:.4f} ms, bound {row['bound_ms']:.4f} ms; "
              f"{row['mbytes'] / now:.0f} GB/s (was {row['mbytes'] / was:.0f})", flush=True)
    return {"compare": table, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, help="a checkout of another commit")
    ap.add_argument("--time-root", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--scan", action="store_true",
                    help="time K1 at one context length a row, B 1 and 16, by the least "
                         "tiles of a split")
    ap.add_argument("--sweep", default="",
                    help="comma list of BLOCKS_PER_SM:SPLIT_TILES plan settings, each timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_decode_attention_kernel: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.time_root is not None:  # one timing process of --compare
        cs, _build, k1 = _imports(args.time_root.resolve())
        _build.build_all()
        print(json.dumps(time_shapes(cs, k1, dev)))
        return 0
    cs, _build, k1 = _imports(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    if args.compare is not None:
        res = compare(args.compare.resolve())
    else:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        for line in _build.build_log.get("decode_attention", "").splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "error", "Compiling")):
                print(line.strip(), flush=True)
        worst = check(cs, k1, dev)
        print(f"checks passed: worst max-abs error {worst:.3g} ({cs.QUANT_TOL})", flush=True)
        res = {"worst_err": worst, "timed": time_shapes(cs, k1, dev)}
        if args.scan:
            res["scan"] = scan(cs, k1, dev)
        if args.sweep:
            res["sweep"] = sweep(cs, k1, dev, [tuple(int(u) for u in v.split(":"))
                                               for v in args.sweep.split(",")])
        for r in res["timed"]:
            print(f"{r['shape']}: kernel {r['ms']:.4f} ms ({r['gbps']:.0f} GB/s of "
                  f"{r['mbytes']:.1f} MB), SDPA {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), host {r['host_us']:.1f} us",
                  flush=True)
    print(card)
    print(json.dumps(dict(res, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
