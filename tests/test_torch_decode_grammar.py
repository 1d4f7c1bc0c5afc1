"""The decode-kernel grammar (``XLLM_DECODE_KERNEL``) of the port against the
JAX package's, on the CPU:

- ``ops/attention.resolve_decode_kernel`` resolves every name as the JAX
  dispatch (``xllm_tpu/ops/attention.py:decode_attention_write``) does, to
  the counterpart of the TPU function and tile it picks, and raises where it
  raises (its Pallas entry points replaced by recorders);
- each TPU decode function's plain version (K1b, K12a-g; the tile
  instances of K1, K8 and K9) equals that Pallas kernel in interpret mode
  on inputs whose scores are exact in f32 (``test_torch_p_rounding.py``),
  caches byte-equal: within 1e-5 + 2^-7 |ref| for bf16, 1e-4 for int8 /
  fp8 / f32;
- a tiny f32 qwen3 gives the JAX engine's greedy tokens under each name,
  the JAX engine running the named kernel in interpret mode.

The variants differ in the rounding tile G (pages) and where the new token
joins the softmax (``open``, ``last``, ``cache``): the table of
``ops/cuda/decode_attention.py``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu.ops.attention as jattention
import xllm_tpu.ops.pallas.decode_attention as jdecode
import xllm_tpu.ops.pallas.legacy.decode_attention as jlegacy
import xllm_tpu_torch.config as tcfg
from test_torch_mla import _fake_cuda
from test_torch_p_rounding import (
    ATOL,
    BF16_RTOL,
    QUANT_ATOL,
    D,
    _assert_within,
    _cache,
    _grid,
    _pair,
    _t,
    _tables,
)
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.ops import attention as tattention
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import decode_attention as tdecode
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

# the TPU function of each family (JAX's own module attribute names)
TPU_FN = {
    "v9": (jdecode, "paged_decode_attention_write_v9_tpu"),
    "v5": (jdecode, "paged_decode_attention_write_v5_tpu"),
    "v11": (jdecode, "paged_decode_attention_write_v11_tpu"),
    "v12": (jdecode, "paged_decode_attention_write_v12_tpu"),
    "v1": (jlegacy, "paged_decode_attention_write_tpu"),
    "v3": (jlegacy, "paged_decode_attention_write_v3_tpu"),
    "v4": (jlegacy, "paged_decode_attention_write_v4_tpu"),
    "v6": (jlegacy, "paged_decode_attention_write_v6_tpu"),
    "v7": (jlegacy, "paged_decode_attention_write_v7_tpu"),
    "v8": (jlegacy, "paged_decode_attention_write_v8_tpu"),
    "v10": (jlegacy, "paged_decode_attention_write_v10_tpu"),
}


def _tpu_name(fn) -> str:
    """The TPU function a port wrapper replaces."""
    if fn is tdecode.paged_decode_attention_write_ilv:
        return TPU_FN["v11"][1]
    if fn is tdecode.paged_decode_attention_write_rm:
        return TPU_FN["v12"][1]
    return fn.tpu_kernel.split()[-1]


# ---------------------------------------------------------------------------
# the grammar: names -> (TPU function, tile), as JAX resolves them
# ---------------------------------------------------------------------------
SPLIT_NAMES = ["v9t4", "v9", "v9t2", "v9t3", "v9t4n6", "v9t4p", "v9p", "v9t2n3p", "v8",
               "v8c2", "v8c4", "v8x", "v10", "v10t2", "v10x", "v7", "v6", "v5", "v4", "v1",
               "v3", "v2", "v11t4", "v11t4p", "v12t2", "foo", "", "v7x", "v5t2", "v1t2",
               # raise
               "v9x", "v9t", "v9tx", "v9t2n", "v9t2nx", "v8c", "v8cx", "v10t", "v10tx"]
ILV_NAMES = ["v11", "v11t2", "v11t2n4", "v9t2", "v12t2", "v5", "v11p", "v11t4p", "v11x",
             "v11t"]
RM_NAMES = ["v12", "v12t2", "v12t3n2", "v11t2", "v5", "v12t4p", "v12x", "v12tx"]
CASES = ([("split", n, w) for n in SPLIT_NAMES for w in (0, 37)]
         + [(layout, n, 0) for layout, names in (("interleaved", ILV_NAMES),
                                                 ("interleaved_rm", RM_NAMES))
            for n in names])


@pytest.fixture
def jax_picks(monkeypatch):
    """JAX's dispatch with its Pallas entry points replaced by recorders ->
    calls [(TPU function, tile or chunk)]."""
    monkeypatch.setattr(jattention, "_use_pallas", lambda *a, **k: True)
    picks = []
    for mod, name in TPU_FN.values():
        def record(q, k_new, v_new, k_all, *rest, _name=name, **kw):
            picks.append((_name, kw.get("tile", kw.get("chunk"))))
            if k_all.ndim == 6:
                return q, k_all
            return q, k_all, rest[0]

        monkeypatch.setattr(mod, name, record)
    return picks


def _jax_dispatch(layout: str, window: int):
    q = jnp.zeros((1, 2, 128), jnp.float32)
    new = jnp.zeros((1, 1, 128), jnp.float32)
    idx = jnp.zeros((1,), jnp.int32)
    bt = jnp.zeros((1, 2), jnp.int32)
    if layout == "split":
        cache = jnp.zeros((1, 2, 1, 16, 128), jnp.float32)
        return jattention.decode_attention_write(q, new, new, cache, cache, jnp.int32(0), idx,
                                                 bt, idx + 1, 0.1, window=window)
    cache = jnp.zeros((1, 2, 2, 1, 16, 128), jnp.float32)
    return jattention.decode_attention_write(q, new, new, cache, jnp.zeros(1), jnp.int32(0),
                                             idx, bt, idx + 1, 0.1, window=window,
                                             rowmajor_tail=layout == "interleaved_rm")


@pytest.mark.parametrize("layout,kver,window", CASES)
def test_resolution_matches_jax_dispatch(layout, kver, window, jax_picks, monkeypatch):
    monkeypatch.setenv("XLLM_DECODE_KERNEL", kver)
    try:
        _jax_dispatch(layout, window)
    except Exception as e:  # noqa: BLE001 - the port must raise the same type
        with pytest.raises(type(e)):
            tattention.resolve_decode_kernel(kver, layout, window)
        return
    assert len(jax_picks) == 1
    fn, tile = tattention.resolve_decode_kernel(kver, layout, window)
    assert (_tpu_name(fn), tile) == jax_picks[0]


def test_default_names_and_cache():
    """Unset, each layout runs JAX's default; a name is parsed once."""
    assert tattention.DEFAULT_DECODE_KERNEL == {
        "split": "v9t4", "interleaved": "v11t4", "interleaved_rm": "v12t4"}
    tattention._resolve.cache_clear()
    for _ in range(3):
        tattention.resolve_decode_kernel("v8c2", "split", 0)
    info = tattention._resolve.cache_info()
    assert (info.misses, info.hits) == (1, 2)


def test_fixed_variants_refuse_other_tiles_and_v1_a_window():
    q = torch.zeros(1, 2, 128)
    cache = torch.zeros(1, 2, 1, 16, 128)
    i = torch.zeros(1, dtype=torch.int32)
    args = (q, q[:, :1], q[:, :1], cache, cache.clone(), 0, i, i[None], i + 1, 0.1)
    with pytest.raises(ValueError, match="takes no window"):
        tdecode.VARIANTS["v1"].plain(*args, 37)
    with pytest.raises(ValueError, match="after 2 pages"):
        tdecode.VARIANTS["v7"](*args, 0, 4)
    with pytest.raises(ValueError, match="tile of 0 pages"):
        tdecode.VARIANTS["v8"](*args, 0, 0)


@pytest.mark.parametrize("kver", ["v5", "v1", "v3", "v4", "v6", "v7", "v8c2", "v10t2", "v9t3"])
def test_cuda_tensor_with_failed_build_raises(kver, monkeypatch):
    """A CUDA tensor goes to the kernel: a failed build raises before any
    launch is counted, and no plain version runs."""
    def failed_build(stem):
        raise RuntimeError(f"CUDA kernel build failed: csrc/{stem}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    monkeypatch.setattr(tdecode, "_lib", None)
    monkeypatch.setattr(tdecode, "_split_plain", no_plain)
    before = dict(_build.launch_counts)
    fn, tile = tattention.resolve_decode_kernel(kver, "split", 0)
    f = _fake_cuda
    q = f(torch.zeros(1, 2, 128, dtype=torch.bfloat16))
    new = f(torch.zeros(1, 1, 128, dtype=torch.bfloat16))
    cache = f(torch.zeros(1, 2, 1, 16, 128, dtype=torch.bfloat16))
    i = f(torch.zeros(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="build failed"):
        fn(q, new, new, cache, f(torch.zeros(1, 2, 1, 16, 128, dtype=torch.bfloat16)), 0, i,
           f(torch.zeros(1, 2, dtype=torch.int32)), f(torch.ones(1, dtype=torch.int32)), 0.1,
           0, tile)
    assert _build.launch_counts == before


# ---------------------------------------------------------------------------
# each plain version against its Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
def _inputs(kind: str, bs: int, seed: int = 11, hkv: int = 2):
    """test_torch_p_rounding's exact-score grid inputs, with seq_len 1, a
    padded row and a new token that opens a page among the rows."""
    rng = np.random.default_rng(seed)
    if kind in ("bf16", "f32"):
        hq, lens = 4 * hkv, [30, 1, 45, 60, 17, 0, 75, 100, 120]
    else:
        hq = 2 * hkv
        lens = [2 * bs + 5, 1, 5 * bs + 1, 9 * bs + bs // 2, 0, 3 * bs]
    nbmax = max(-(-n // bs) for n in lens) + 1
    bt, nb = _tables(lens, bs, nbmax)
    if kind == "f32":
        kc, kt = _pair(_grid(rng, (2, nb, hkv, bs, D), 2.0 ** -3, 3.0), "float32")
        vc, vt = _pair(rng.standard_normal((2, nb, hkv, bs, D)).astype(np.float32), "float32")
    else:
        kc, kt = _cache(rng, kind, (2, nb, hkv, bs, D))
        vc, vt = _cache(rng, kind, (2, nb, hkv, bs, D))
    b = len(lens)
    if kind in ("bf16", "f32"):
        dt = "bfloat16" if kind == "bf16" else "float32"
        jq, tq = _pair(_grid(rng, (b, hq, D), 2.0 ** -3, 3.0), dt)
        jkn, tkn = _pair(_grid(rng, (b, hkv, D), 2.0 ** -3, 3.0), dt)
        jvn, tvn = _pair(rng.standard_normal((b, hkv, D)).astype(np.float32), dt)
    else:
        jq, tq = _pair(_grid(rng, (b, hq, D), 2.0 ** -6, 0.25), "float32")
        new = rng.integers(-16, 17, (2, b, hkv, D))
        if kind == "int8":
            (jkn, jvn), (tkn, tvn) = zip(*[(jnp.asarray(x, jnp.int8),
                                            torch.from_numpy(x.astype(np.int8))) for x in new])
        else:
            (jkn, jvn), (tkn, tvn) = zip(*[_pair(x.astype(np.float32), "float32") for x in new])
    sl = np.asarray(lens, np.int32)
    sm = np.asarray([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                     for i, n in enumerate(lens)], np.int32)
    return (jq, jkn, jvn, kc, vc, jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl)), \
        (tq, tkn, tvn, kt, vt, _t(sm), _t(bt), _t(sl))


def _bits(x) -> np.ndarray:
    a = np.asarray(x.view(torch.uint8) if isinstance(x, torch.Tensor) and x.element_size() == 1
                   else x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))
    return a


def _assert_close(kind, got, want):
    want = np.asarray(want.astype(jnp.float32))
    if kind == "bf16":
        _assert_within(got.float().numpy(), want, ATOL, BF16_RTOL)
    else:
        _assert_within(got.float().numpy(), want, QUANT_ATOL, 0.0)


def _assert_same_bytes(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    if got.element_size() == 1:
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), w.view(np.uint8))
    else:
        np.testing.assert_array_equal(got.float().numpy(), w.astype(np.float32))


# (XLLM_DECODE_KERNEL name, cache kind, block_size, window): bf16 and int8
# for every variant, fp8 / f32 / bs 64 for v1, v3 and v5, a window of 37
# for v3, v4, v5, v7 and v10, the tile instances
SPLIT_CASES = (
    [(n, k, 16, 0) for n in ("v5", "v1", "v3", "v4", "v6", "v7", "v8", "v10")
     for k in ("bf16",)]
    + [(n, "int8", 16, 0) for n in ("v5", "v1", "v3", "v4", "v6", "v7", "v8c2", "v10t2")]
    + [(n, k, bs, 0) for n in ("v1", "v3", "v5")
       for k, bs in (("fp8_e4m3", 16), ("f32", 16), ("int8", 64))]
    + [(n, "bf16", 16, 37) for n in ("v3", "v4", "v5", "v7", "v10")]
    + [("v9t3", "bf16", 16, 0), ("v9t2", "int8", 16, 0)]
)


@pytest.mark.parametrize("kver,kind,bs,window", SPLIT_CASES)
def test_plain_matches_pallas(kver, kind, bs, window):
    fn, tile = tattention.resolve_decode_kernel(kver, "split", window)
    family = next(f for f, (_, name) in TPU_FN.items() if name == _tpu_name(fn))
    mod, name = TPU_FN[family]
    (jq, jkn, jvn, kc, vc, sm, bt, sl), (tq, tkn, tvn, kt, vt, *idx) = _inputs(kind, bs)
    kw = {} if family == "v1" else {"window": window}
    if tile is not None:
        kw["chunk" if family == "v8" else "tile"] = tile
    scale = D ** -0.5
    want, wk, wv = getattr(mod, name)(jq, jkn, jvn, kc, vc, jnp.int32(1), sm, bt, sl, scale,
                                      interpret=True, **kw)
    got = fn.plain(tq, tkn, tvn, kt, vt, 1, *idx, scale, window, tile)
    _assert_close(kind, got, want)
    _assert_same_bytes(kt, wk)
    _assert_same_bytes(vt, wv)


@pytest.mark.parametrize("layout", ["interleaved", "interleaved_rm"])
def test_interleaved_tile_instances_match_pallas(layout):
    """v11t2 (K8) and v12t2 (K9, whose tail page is a tile of its own after
    tiles of 2 full pages; Hkv 8, as its row-major tails need) on a bf16
    cache."""
    kver = "v11t2" if layout == "interleaved" else "v12t2"
    fn, tile = tattention.resolve_decode_kernel(kver, layout, 0)
    assert tile == 2
    (jq, jkn, jvn, kc, vc, sm, bt, sl), (tq, tkn, tvn, kt, vt, *idx) = _inputs("bf16", 16,
                                                                               hkv=8)
    jkv = jnp.stack([kc, vc], axis=2)
    tkv = torch.stack([kt, vt], dim=2).contiguous()
    mod, name = TPU_FN["v11" if layout == "interleaved" else "v12"]
    want, wkv = getattr(mod, name)(jq, jkn, jvn, jkv, jnp.int32(1), sm, bt, sl, D ** -0.5,
                                   interpret=True, tile=tile)
    plain = (tdecode.paged_decode_attention_write_ilv_plain if layout == "interleaved"
             else tdecode.paged_decode_attention_write_rm_plain)
    got = plain(tq, tkn, tvn, tkv, 1, *idx, D ** -0.5, 0, tile)
    _assert_close("bf16", got, want)
    _assert_same_bytes(tkv, wkv)


# ---------------------------------------------------------------------------
# greedy tokens under each name
# ---------------------------------------------------------------------------
def _config(c):
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=64,
            intermediate_size=64, num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, head_dim=128, qk_norm=True,
            max_position_embeddings=128, eos_token_ids=[13]),
        cache=c.CacheConfig(block_size=16, num_blocks=32),
        scheduler=c.SchedulerConfig(max_seqs_per_batch=2, max_tokens_per_chunk_for_prefill=32,
                                    max_model_len=128, decode_batch_buckets=[2],
                                    prefill_token_buckets=[32]),
    )


PROMPTS = [[3, 5, 7, 9, 11], list(range(1, 30))]


@pytest.mark.parametrize("kver", ["v5", "v1", "v3", "v4", "v6", "v7", "v8c2", "v10t2",
                                  "v9t2"])
def test_greedy_tokens_match_jax_under_each_name(kver, monkeypatch):
    """A tiny f32 qwen3 (head_dim 128) on the split layout: the port's engine
    under ``XLLM_DECODE_KERNEL=kver`` (the named variant's plain version)
    gives the JAX engine's greedy tokens, the JAX engine running the named
    Pallas kernel in interpret mode (its prefill through its portable
    path)."""
    monkeypatch.setenv("XLLM_DECODE_KERNEL", kver)
    traced = []
    # the JAX engine's decode through the Pallas kernel; its prefill stays on
    # the portable path (the same function as the port's K3 at f32, up to
    # the order of sums)
    monkeypatch.setattr(jattention, "_use_pallas", lambda *a, **k: (
        sys._getframe(1).f_code.co_name == "decode_attention_write"))
    for mod, name in TPU_FN.values():
        def interpreted(*a, _fn=getattr(mod, name), _name=name, **k):
            traced.append(_name)
            return _fn(*a, interpret=True, **k)

        monkeypatch.setattr(mod, name, interpreted)
    tree = random_param_tree(_config(tcfg).model, seed=5)
    jc = _config(jcfg)
    jr = JRunner(jc)
    jr.load_model(params=jax.tree.map(jnp.asarray, tree))
    jeng = JEngine(jc, runner=jr)
    sp = dict(temperature=0.0, max_tokens=4, ignore_eos=True)
    jid = [jeng.add_request(prompt_token_ids=p, sampling_params=JSP(**sp)).request_id
           for p in PROMPTS]
    jout = {ro.request_id: ro.outputs[0].token_ids for ro in jeng.generate_all(timeout_s=600)}

    fn, _ = tattention.resolve_decode_kernel(kver, "split", 0)
    seen = []
    orig_call = tdecode.Variant.__call__

    def spy(self, *a, **k):
        seen.append(self.name)
        return orig_call(self, *a, **k)

    monkeypatch.setattr(tdecode.Variant, "__call__", spy)
    tc = _config(tcfg)
    tr = TRunner(tc, device="cpu")
    tr.load_model(params=tree)
    teng = TEngine(tc, runner=tr)
    tid = [teng.add_request(prompt_token_ids=p, sampling_params=TSP(**sp)).request_id
           for p in PROMPTS]
    tout = {ro.request_id: ro.outputs[0].token_ids for ro in teng.generate_all()}
    assert [tout[i] for i in tid] == [jout[i] for i in jid]
    assert set(seen) == {fn.name} and set(traced) == {_tpu_name(fn)}
