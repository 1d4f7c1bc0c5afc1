"""Gated DeltaNet (qwen3-next linear attention): the recurrence and its
causal conv.

Counterpart of ``xllm_tpu/ops/gdn.py``. The JAX package has no Pallas
kernel here: its ``lax.scan`` over the token axis carries the short-conv
tail (the last K-1 pre-activation channel vectors) and the recurrent state
S [Hv, Dk, Dv] together, and is vmapped over the rows of a batched
prefill. The port keeps the arithmetic and its order and loops over the
tokens in Python with the rows batched: one token step is a handful of
small batched ops on every row at once. It stays plain PyTorch until a
measurement on the card asks for a kernel (PERF.md section 5 times it).

- the per-token ``valid`` mask freezes both carries on padded tail
  tokens, so bucket padding never corrupts a sequence's state;
- the state is carried in f32 (exp-decay plus rank-1 updates), and so are
  the conv tail and the outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FLA-convention l2 normalization: x * rsqrt(sum(x^2) + eps), in f32."""
    x = x.float()
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def gdn_scan(
    x_qkv: torch.Tensor,  # [P, T, conv_dim] pre-conv concat(q|k|v) channels
    g: torch.Tensor,  # [P, T, Hv] f32 log-decay
    beta: torch.Tensor,  # [P, T, Hv] f32 write strength
    valid: torch.Tensor,  # [P, T] bool
    conv_w: torch.Tensor,  # [conv_dim, K] depthwise kernel
    conv_tail0: torch.Tensor,  # [P, conv_dim, K-1] carry-in
    state0: torch.Tensor,  # [P, Hv, Dk, Dv] f32 carry-in
    *,
    num_k_heads: int,
    num_v_heads: int,
    head_k_dim: int,
    head_v_dim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (out [P, T, Hv, Dv] f32, conv_tail [P, conv_dim, K-1] f32, state
    [P, Hv, Dk, Dv] f32): the JAX ``gdn_scan`` of each of the P rows (its
    vmap).

    Fused causal depthwise conv (kernel K, silu) + delta-rule recurrence
    (HF torch_recurrent_gated_delta_rule semantics, with the qk l2-norm and
    the 1/sqrt(Dk) query scale). Only the state carry is sequential: each
    token's conv window (the last K-1 inputs of valid tokens before it, the
    carried-in tail first, then its own input) is gathered for every token
    at once, and so are the conv, the l2-norms and the decays; the loop
    over the tokens runs the rank-1 updates of all P rows together."""
    hk, hv = num_k_heads, num_v_heads
    dk, dv = head_k_dim, head_v_dim
    key_dim = hk * dk
    r = hv // hk
    p, t, cd = x_qkv.shape
    kk = conv_w.shape[1]
    dev = x_qkv.device
    valid = valid.bool()
    # the channel history [tail0 | x_0 .. x_{T-1}] and, per token, the
    # positions in it of its window: the K-1 inputs before it in the
    # sequence (tail0, then the valid tokens in order), then its own
    hist = torch.cat([conv_tail0.float(), x_qkv.float().transpose(1, 2)], dim=2)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)  # valid first

    def src(seq_idx):  # sequence index -> column of hist
        tok = order.gather(1, (seq_idx - (kk - 1)).clamp(min=0).reshape(p, -1))
        return torch.where(seq_idx < kk - 1, seq_idx, tok.reshape(seq_idx.shape) + kk - 1)

    before = torch.cumsum(valid.int(), dim=1) - valid.int()  # valid tokens before t
    lanes = torch.arange(kk - 1, device=dev)
    cols = torch.cat([src(before[:, :, None] + lanes),
                      (torch.arange(t, device=dev) + kk - 1).expand(p, t)[:, :, None]],
                     dim=2)  # [P, T, K]
    w = conv_w.float()
    conv = 0.0  # sum over the window's K inputs, in order
    for j in range(kk):
        conv = conv + hist.gather(2, cols[:, None, :, j].expand(p, cd, t)) * w[:, j, None]
    conv = conv * torch.sigmoid(conv)  # silu
    conv = conv.transpose(1, 2)  # [P, T, cd]
    q = conv[..., :key_dim].reshape(p, t, hk, dk)
    k = conv[..., key_dim:2 * key_dim].reshape(p, t, hk, dk)
    v = conv[..., 2 * key_dim:].reshape(p, t, hv, dv)
    q = l2norm(q) * (dk ** -0.5)
    k = l2norm(k)
    if r > 1:
        q = torch.repeat_interleave(q, r, dim=2)  # [P, T, Hv, Dk]
        k = torch.repeat_interleave(k, r, dim=2)
    decay = torch.exp(g.float())[..., None, None]  # [P, T, Hv, 1, 1]
    beta = beta.float()[..., None]  # [P, T, Hv, 1]
    q, k = q[..., None, :], k[..., None, :]  # [P, T, Hv, 1, Dk]
    ok = valid[:, :, None, None, None]
    s = state0.float()
    outs = []
    for i in range(t):
        s2 = s * decay[:, i]
        kv_mem = torch.matmul(k[:, i], s2)[..., 0, :]  # [P, Hv, Dv]
        delta = (v[:, i] - kv_mem) * beta[:, i]
        s2 = s2 + k[:, i].transpose(-1, -2) * delta[..., None, :]
        outs.append(torch.matmul(q[:, i], s2)[..., 0, :])
        s = torch.where(ok[:, i], s2, s)
    out = torch.stack(outs, dim=1) if outs else x_qkv.new_zeros(p, 0, hv, dv).float()
    # the carried-out tail: the last K-1 inputs of the sequence
    n = valid.int().sum(dim=1)
    tail = hist.gather(2, src(n[:, None] + lanes)[:, None, :].expand(p, cd, kk - 1))
    return out, tail, s


def gdn_gate_params(
    a: torch.Tensor,  # [..., Hv] raw a
    b: torch.Tensor,  # [..., Hv] raw b
    A_log: torch.Tensor,  # [Hv]
    dt_bias: torch.Tensor,  # [Hv]
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (g log-decay f32, beta f32), each of a's shape."""
    g = -torch.exp(A_log.float()) * F.softplus(a.float() + dt_bias.float())
    beta = torch.sigmoid(b.float())
    return g, beta


def gated_rms_norm(
    x: torch.Tensor,  # [..., Dv] f32
    z: torch.Tensor,  # [..., Dv] gate
    w: torch.Tensor,  # [Dv]
    eps: float,
) -> torch.Tensor:
    """Qwen3NextRMSNormGated: plain-weight RMS norm, then * silu(z), in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    n = xf * torch.rsqrt(var + eps) * w.float()
    zf = z.float()
    return n * (zf * torch.sigmoid(zf))
