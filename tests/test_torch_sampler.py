"""The port's sampler vs ``xllm_tpu.runtime.sampler.sample`` on the CPU.

Greedy and penalized greedy rows must pick the same tokens exactly.
Stochastic rows differ only by their random numbers, so both sides get the
same Gumbel noise from numpy: the port takes it as an argument, the JAX
sampler through a monkeypatched ``jax.random.gumbel`` (the JAX package
itself is unchanged). Seeded rows are checked for reproducibility within
the port, since the two packages' generators differ by design. Logprobs
agree to 1e-5 (f32 logsumexp in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.runtime import forward_params as jfp
from xllm_tpu.runtime import sampler as jsampler
from xllm_tpu_torch.runtime import forward_params as tfp
from xllm_tpu_torch.runtime import sampler as tsampler
from torch_threads import one_torch_thread  # noqa: F401

N, V, T, K = 6, 500, 32, 64


def _inputs(rng, temperature, **over):
    a = dict(
        temperature=np.asarray(temperature, np.float32),
        top_k=np.zeros(N, np.int32),
        top_p=np.ones(N, np.float32),
        repetition_penalty=np.ones(N, np.float32),
        frequency_penalty=np.zeros(N, np.float32),
        presence_penalty=np.zeros(N, np.float32),
        hist_len=np.zeros(N, np.int32),
    )
    a.update({k: np.asarray(v, a[k].dtype) for k, v in over.items()})
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    # the history holds some of each row's best candidates
    top = np.argsort(-logits, axis=1)
    hist = np.concatenate([top[:, :T // 2], rng.integers(0, V, (N, T // 2))], axis=1)
    return a, logits, hist.astype(np.int32)


def _run_both(a, logits, hist, noise=None, num_top=0, use_hist=True):
    si_j = jfp.SamplingInput(key=jax.random.key(0),
                             **{k: jnp.asarray(v) for k, v in a.items()})
    si_t = tfp.SamplingInput(key=torch.Generator().manual_seed(0),
                             **{k: torch.from_numpy(v) for k, v in a.items()})
    hj = jnp.asarray(hist) if use_hist else None
    ht = torch.from_numpy(hist) if use_hist else None
    out_j = jsampler.sample(jnp.asarray(logits), si_j, hj, num_top)
    out_t = tsampler.sample(torch.from_numpy(logits), si_t, ht, num_top,
                            gumbel=None if noise is None else torch.from_numpy(noise))
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]


@pytest.mark.parametrize("use_hist", [False, True])
def test_greedy_matches(use_hist):
    rng = np.random.default_rng(0)
    over = {}
    if use_hist:
        over = dict(repetition_penalty=[1.0, 1.5, 1.2, 2.0, 1.0, 1.3],
                    frequency_penalty=[0.0, 0.0, 0.5, 0.3, 1.0, 0.0],
                    presence_penalty=[0.0, 0.2, 0.0, 0.5, 0.0, 1.5],
                    hist_len=[T, T, T // 2, T, 5, T])
    a, logits, hist = _inputs(rng, np.zeros(N), **over)
    oj, ot = _run_both(a, logits, hist, num_top=5, use_hist=use_hist)
    np.testing.assert_array_equal(ot[0], oj[0])  # tokens
    np.testing.assert_allclose(ot[1], oj[1], rtol=1e-5, atol=1e-5)  # logprobs
    np.testing.assert_array_equal(ot[2], oj[2])  # top ids
    np.testing.assert_allclose(ot[3], oj[3], rtol=1e-5, atol=1e-5)
    if use_hist:  # the penalties changed some choices
        assert (ot[0] != logits.argmax(axis=1)).any()


def test_stochastic_rows_match_with_shared_noise(monkeypatch):
    rng = np.random.default_rng(1)
    a, logits, hist = _inputs(
        rng, [0.7, 1.0, 1.3, 0.0, 0.5, 1.0],
        top_k=[0, 5, 20, 0, 0, 3], top_p=[1.0, 1.0, 0.9, 1.0, 0.5, 0.8],
        repetition_penalty=[1.0, 1.2, 1.0, 1.0, 1.4, 1.0], hist_len=[T] * N,
    )
    hits = 0
    for trial in range(8):
        noise = rng.gumbel(size=(N, K)).astype(np.float32)
        monkeypatch.setattr(
            jax.random, "gumbel",
            lambda key, shape, dtype=jnp.float32, _n=noise: jnp.asarray(_n, dtype),
        )
        oj, ot = _run_both(a, logits, hist, noise=noise)
        np.testing.assert_array_equal(ot[0], oj[0])
        np.testing.assert_allclose(ot[1], oj[1], rtol=1e-5, atol=1e-5)
        hits += int((ot[0] != logits.argmax(axis=1)).sum())
    assert hits > 0  # the noise did move some rows off the argmax


def test_seeded_rows_reproduce_in_any_batch():
    seeds = [7, -1, 7, 11]
    steps = [3, 0, 3, 3]
    a = tsampler.gumbel_noise(4, K, torch.Generator().manual_seed(0), "cpu", seeds, steps)
    b = tsampler.gumbel_noise(4, K, torch.Generator().manual_seed(1), "cpu",
                              seeds[::-1], steps[::-1])
    torch.testing.assert_close(a[0], b[1])  # seed 7, step 3 wherever it sits
    torch.testing.assert_close(a[0], a[2])
    assert not torch.equal(a[0], a[3])  # another seed
    c = tsampler.gumbel_noise(1, K, torch.Generator(), "cpu", [7], [4])
    assert not torch.equal(a[0], c[0])  # another step
