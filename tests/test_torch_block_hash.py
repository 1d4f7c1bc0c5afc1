"""The prefix cache's block hash (``framework/block_manager.hash_block``).

The port keys its blocks by xxhash64 with seed 17 over the JAX package's
bytes (the parent hash, then the token ids, then ``extra``), so a global
KV store shared between a JAX node and a CUDA node hits across them. The
digest comes from the ``xxhash`` package where it imports, else from the
standard-library XXH64 (``utils/xxh64.py``); both are held to
``xxhash.xxh64(seed=17).intdigest()`` and to the JAX package's
``hash_block`` on random blocks, with and without ``extra``, the chain
included; the choice made at import without ``xxhash`` is checked in a
subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import xxhash

from xllm_tpu.framework import block_manager as jbm
from xllm_tpu_torch.framework import block_manager as bm
from xllm_tpu_torch.utils.xxh64 import xxh64
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
IMPLS = {"xxhash": bm._xxh64, "stdlib": bm._xxh64_stdlib}


def _blocks(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    for size in (1, 3, 16, 64, 128, 7)[:n]:
        yield (int(rng.integers(0, 2**64, dtype=np.uint64)),
               rng.integers(-2**31, 2**31, size=size).tolist())


def _reference(parent: int, ids: list[int], extra: bytes) -> int:
    h = xxhash.xxh64(seed=17)
    h.update(parent.to_bytes(8, "little"))
    h.update(b"".join(t.to_bytes(4, "little", signed=True) for t in ids))
    h.update(extra)
    return h.intdigest()


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("extra", [b"", b"lora:7", bytes(range(41))], ids=["none", "lora", "41B"])
def test_hash_block_is_xxh64_seed_17(impl, extra, monkeypatch):
    assert bm.XXH64_IMPL == "xxhash"  # this environment has the package
    monkeypatch.setattr(bm, "_xxh64", IMPLS[impl])
    chain, jchain = 0, 0  # each block's parent is the previous digest
    for i, (p, ids) in enumerate(_blocks(len(extra))):
        got = bm.hash_block(p, ids, extra)
        assert got == _reference(p, ids, extra) == jbm.hash_block(p, ids, extra), (i, len(ids))
        chain, jchain = bm.hash_block(chain, ids, extra), jbm.hash_block(jchain, ids, extra)
        assert chain == jchain, i


def test_xxh64_stdlib_every_tail_length():
    """Lengths 0-100 and a few long ones cover the 32-byte stripes and
    each of the 8-, 4- and 1-byte tails, seeds 0, 17 and 2^64 - 1."""
    rng = np.random.default_rng(3)
    for n in list(range(101)) + [255, 256, 1031, 4096]:
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        for seed in (0, 17, 2**64 - 1):
            assert xxh64(data, seed) == xxhash.xxh64(data, seed=seed).intdigest(), (n, seed)


_WITHOUT_XXHASH = r"""
import json, sys
sys.modules["xxhash"] = None  # the import fails as on a machine without it
from xllm_tpu_torch.framework import block_manager as bm
cases = json.loads(sys.argv[1])
print(json.dumps({"impl": bm.XXH64_IMPL,
                  "digests": [bm.hash_block(p, ids, bytes(e)) for p, ids, e in cases]}))
"""


def test_import_without_xxhash_picks_stdlib():
    cases = [(p, ids, list(e)) for (p, ids), e in zip(_blocks(9), (b"", b"x" * 9) * 3)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _WITHOUT_XXHASH, json.dumps(cases)],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["impl"] == "stdlib"
    assert out["digests"] == [_reference(p, ids, bytes(e)) for p, ids, e in cases]
