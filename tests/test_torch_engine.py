"""Greedy serving parity: ``xllm_tpu_torch`` on the CPU vs ``xllm_tpu``.

Both engines get the same f32 weights (``weights.random_param_tree``) and
the same requests on the tiny qwen3 config of ``tests/test_engine.py``:
more requests than ``max_seqs_per_batch``, prompts longer than the prefill
chunk budget (chunked prefill), penalized greedy rows (the token-history
ring) and EOS stopping (token 13 ends a row here). Greedy output must
be token-identical, and both engines must give every KV block back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.llm import LLM
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401


def tiny_config(c):
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, qk_norm=True,
            max_position_embeddings=128, eos_token_ids=[13],
        ),
        cache=c.CacheConfig(block_size=4, num_blocks=64),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=8, max_tokens_per_chunk_for_prefill=16,
            max_model_len=128, decode_batch_buckets=[2, 4, 8],
            prefill_token_buckets=[4, 8, 16],
        ),
    )


def _requests():
    rng = np.random.default_rng(0)
    lens = (5, 13, 3, 29, 40, 7, 2, 17, 9, 11, 33, 4)  # 12 > batch of 8
    prompts = [rng.integers(1, 97, n).tolist() for n in lens]
    params = []
    for i in range(len(lens)):
        kw = dict(temperature=0.0, max_tokens=10, ignore_eos=i % 3 != 0)
        if i % 4 == 1:
            kw.update(repetition_penalty=1.3, frequency_penalty=0.2,
                      presence_penalty=0.1)
        params.append(kw)
    return prompts, params


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_greedy_generate_matches_jax():
    prompts, params = _requests()
    tree = random_param_tree(tiny_config(tcfg).model, seed=3)

    jc = tiny_config(jcfg)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    je = JEngine(jc, runner=runner)
    ids = [je.add_request(prompt_token_ids=p, sampling_params=JSP(**kw)).request_id
           for p, kw in zip(prompts, params)]
    outs = {ro.request_id: ro.outputs[0] for ro in je.generate_all(timeout_s=600)}
    want = [(outs[i].token_ids, outs[i].finish_reason) for i in ids]
    assert je.block_manager.num_used_blocks == 0
    assert {"stop", "length"} == {r for _, r in want}

    llm = LLM(config=tiny_config(tcfg), device="cpu")
    llm.engine.runner.load_model(params=tree)
    got = [(ro.outputs[0].token_ids, ro.outputs[0].finish_reason)
           for ro in llm.generate(prompt_token_ids=prompts,
                                  sampling_params=[TSP(**kw) for kw in params])]
    assert got == want
    assert llm.engine.block_manager.num_used_blocks == 0
