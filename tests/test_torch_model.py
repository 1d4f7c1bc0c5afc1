"""The port's ``DenseDecoderModel`` vs the JAX one, with the same weights.

A tiny f32 qwen3 (the widths of ``tests/test_engine.py``) is initialised
by the JAX model, carried across with ``xllm_tpu_torch.weights``, and both
models run the same batched prefill chunks (a fresh prompt, a short one
with bucket padding, the second chunk of a chunked prompt, a padded row)
and then a decode step. Both compute in f32 at full matmul precision:
logits agree to 1e-4 (two layers of summation-order differences), caches
to 1e-5 on every slot below each sequence's length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.config import ModelConfig as JModelConfig
from xllm_tpu.models.decoder import DenseDecoderModel as JModel
from xllm_tpu.runtime import forward_params as jfp
from xllm_tpu_torch.config import ModelConfig as TModelConfig
from xllm_tpu_torch.models.decoder import DenseDecoderModel as TModel
from xllm_tpu_torch.runtime import forward_params as tfp
from xllm_tpu_torch.weights import load_param_tree
from torch_threads import one_torch_thread  # noqa: F401

BS, NB, NBMAX = 4, 32, 8
MODEL_KW = dict(
    model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=64,
    intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, qk_norm=True,
    max_position_embeddings=128, eos_token_ids=[0],
)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _prefill_arrays(rng, rows, s, bt, extra_rows=0):
    """rows: (table row, q_offset, ntok, tokens) -> numpy prefill input."""
    p = len(rows) + extra_rows
    a = dict(
        token_ids=np.zeros((p, s), np.int32),
        positions=np.zeros((p, s), np.int32),
        slot_mapping=np.zeros((p, s), np.int32),
        block_tables=np.zeros((p, NBMAX), np.int32),
        kv_lens=np.zeros(p, np.int32),
        q_offsets=np.zeros(p, np.int32),
        logits_idx=np.zeros(p, np.int32),
        sample_slots=np.zeros(p, np.int32),
        hist_slots=np.zeros(p, np.int32),
    )
    for i, (r, qo, n, toks) in enumerate(rows):
        a["token_ids"][i, :n] = toks
        pos = qo + np.arange(s)
        a["positions"][i] = np.minimum(pos, qo + n - 1)
        a["slot_mapping"][i, :n] = bt[r, pos[:n] // BS] * BS + pos[:n] % BS
        a["block_tables"][i] = bt[r]
        a["kv_lens"][i] = qo + n
        a["q_offsets"][i] = qo
        a["logits_idx"][i] = n - 1
    return a


def _both(cls_j, cls_t, arrays):
    return (cls_j(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            cls_t(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _assert_caches(kt, kj, owned):
    kt, kj = kt.numpy(), np.asarray(kj)
    for blk, off in owned:
        np.testing.assert_allclose(kt[:, blk, :, off], kj[:, blk, :, off], rtol=1e-5, atol=1e-5)


def test_prefill_then_decode_matches_jax():
    jm = JModel(JModelConfig(**MODEL_KW))
    params = jm.init_params(jax.random.key(0))
    tm = TModel(TModelConfig(**MODEL_KW), device="cpu")
    load_param_tree(tm, jax.tree.map(np.asarray, params))

    rng = np.random.default_rng(0)
    lens = {0: 8, 1: 5, 2: 10}  # prompt lengths; sequence 2 is chunked 4 + 6
    prompts = {r: rng.integers(1, 97, n).astype(np.int32) for r, n in lens.items()}
    bt = np.zeros((3, NBMAX), np.int32)
    nxt = 1
    for r in range(3):
        for j in range(4):  # room for the decode token
            bt[r, j] = nxt
            nxt += 1

    kj, vj = jm.new_kv_cache(NB, BS)
    kt, vt = tm.new_kv_cache(NB, BS)

    def prefill(arrays):
        ij, it = _both(jfp.BatchedPrefillInput, tfp.BatchedPrefillInput, arrays)
        hj, kj2, vj2 = jm.prefill_batched(params, kj, vj, ij)
        ht, _, _ = tm.prefill_batched(kt, vt, it)
        lj = np.asarray(jm.compute_logits(params, hj[:, 0]))
        lt = tm.compute_logits(ht[:, 0]).numpy()
        return lj, lt, kj2, vj2

    # pass 1: S=8 bucket; fresh, short (bucket padding), first chunk, padded
    a1 = _prefill_arrays(rng, [(0, 0, 8, prompts[0]), (1, 0, 5, prompts[1]),
                               (2, 0, 4, prompts[2][:4])], 8, bt, extra_rows=1)
    lj, lt, kj, vj = prefill(a1)
    np.testing.assert_allclose(lt[:3], lj[:3], rtol=1e-4, atol=1e-4)
    # pass 2: the second chunk of sequence 2 at q_offset 4 over page 1
    a2 = _prefill_arrays(rng, [(2, 4, 6, prompts[2][4:])], 8, bt, extra_rows=1)
    lj, lt, kj, vj = prefill(a2)
    np.testing.assert_allclose(lt[:1], lj[:1], rtol=1e-4, atol=1e-4)
    owned = [(int(bt[r, p // BS]), p % BS) for r, n in lens.items() for p in range(n)]
    _assert_caches(kt, kj, owned)
    _assert_caches(vt, vj, owned)

    # one decode step: three live rows and a padded one
    toks = np.asarray([11, 22, 33, 0], np.int32)
    seq_lens = np.asarray([9, 6, 11, 0], np.int32)
    pos = np.maximum(seq_lens - 1, 0)
    dec = dict(
        slot_ids=np.asarray([0, 1, 2, 9], np.int32),
        positions=pos.astype(np.int32),
        slot_mapping=np.asarray(
            [bt[i, pos[i] // BS] * BS + pos[i] % BS if seq_lens[i] else 0 for i in range(4)],
            np.int32),
        block_tables=np.concatenate([bt, np.zeros((1, NBMAX), np.int32)]),
        seq_lens=seq_lens,
    )
    ij, it = _both(jfp.DecodeInput, tfp.DecodeInput, dec)
    hj, kj, vj = jm.decode(params, kj, vj, ij, jnp.asarray(toks))
    ht, _, _ = tm.decode(kt, vt, it, torch.from_numpy(toks))
    np.testing.assert_allclose(
        tm.compute_logits(ht).numpy()[:3],
        np.asarray(jm.compute_logits(params, hj))[:3], rtol=1e-4, atol=1e-4)
    owned = [(int(bt[r, p // BS]), p % BS) for r in range(3) for p in range(seq_lens[r])]
    _assert_caches(kt, kj, owned)
    _assert_caches(vt, vj, owned)


def _bf16_layer(model_type, bias):
    """One bf16 layer of each package with the same weights, and a bf16
    input [64, 256] given to both."""
    kw = dict(model_type=model_type, dtype="bfloat16", vocab_size=97,
              hidden_size=256, intermediate_size=512, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              qk_norm=not bias, attention_bias=bias, max_position_embeddings=128)
    jm = JModel(JModelConfig(**kw))
    tm = TModel(TModelConfig(**kw), device="cpu")
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(1)))
    if bias:  # the JAX init gives zeros, which would hide the rounding
        b = params["layers"]["qkv_proj_b"]
        params["layers"]["qkv_proj_b"] = (rng.standard_normal(b.shape) * 0.5).astype(b.dtype)
    load_param_tree(tm, params)
    lpj = {k: jnp.asarray(v[0]) for k, v in params["layers"].items()}
    xj = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    return jm, tm, lpj, xj, xt


def _assert_rounds_like(got: torch.Tensor, want: jnp.ndarray) -> None:
    """bf16 results that round at the same places as the JAX package agree
    bit for bit, except where the f32 summation order moves a value across
    a rounding boundary: by at most one bf16 ulp (at most 2^-7 |x|: 8
    significand bits; 1e-5 absolute for outputs near 0, which come from
    cancellation), in at most 1% of the elements. Rounding an f32 intermediate to bf16 one step early
    changes over half of them."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    what = f"max abs err {diff.max():.3g}, {(diff > 0).mean():.2%} of elements differ"
    assert (diff <= 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-5).all(), what
    assert (diff > 0).mean() <= 0.01, what


def test_bf16_mlp_rounds_once_like_jax():
    """gate and up stay in f32 through SiLU x up (JAX ``_linear`` returns
    f32); the activation is rounded once, before the down projection."""
    jm, tm, lpj, xj, xt = _bf16_layer("qwen3", bias=False)
    _assert_rounds_like(tm._mlp(tm.layers[0], xt), jm._mlp(lpj, xj))


def test_bf16_qkv_bias_joins_f32_product():
    """qwen2: the qkv bias is added to the f32 product and the sum is
    rounded once (JAX ``_attn_qkv``), not added to a bf16-rounded product."""
    jm, tm, lpj, xj, xt = _bf16_layer("qwen2", bias=True)
    pos = np.arange(64, dtype=np.int32)
    inv = jnp.asarray(tm.inv_freq.numpy())
    want = jm._attn_qkv(lpj, xj, jnp.asarray(pos), inv)
    got = tm._attn_qkv(tm.layers[0], xt, torch.from_numpy(pos))
    for g, w in zip(got, want):
        _assert_rounds_like(g, w)
