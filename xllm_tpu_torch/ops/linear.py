"""bf16 x bf16 -> f32 projection: the counterpart of the JAX package's
``jnp.dot(x, w, preferred_element_type=jnp.float32)`` (``_linear`` in
``xllm_tpu/models/decoder.py``, the router product in ``ops/moe.py``).

On the card it is cuBLAS's product with an f32 output: both operands stay
in the model dtype in device memory, the products accumulate in f32 and
the result is not rounded. Upcasting the weight per call instead would
double the bytes of a decode step that is bound by weight bytes. On the
CPU, where PyTorch has no such kernel, both operands are upcast: a product
of two bf16 values is exact in f32, so the result is the same function.
"""

from __future__ import annotations

import torch


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[T, K] @ [K, N] -> [T, N] f32, without rounding the product to the
    operands' dtype."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.mm(x, w)
    if x.device.type == "cuda":
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.mm(x.float(), w.float())


def bmm_round_once(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, T, K] @ [N, K, M] -> [N, T, M] in a's dtype, rounded once from
    f32 sums: the JAX ``einsum(..., preferred_element_type=f32).astype``
    of MLA's per-head absorption products. cuBLAS accumulates a bf16 batched
    product in f32 and rounds once; on the CPU the operands are upcast, so
    both devices compute the same function."""
    if a.dtype == torch.float32 or a.device.type == "cuda":
        return torch.bmm(a, b)
    return torch.bmm(a.float(), b.float()).to(a.dtype)
