"""Rotary position embeddings (counterpart of ``xllm_tpu/ops/rope.py``).

HF "rotate-half" convention used by the llama/qwen families, computed on the
fly from positions, and the two partial variants (only the first
``rotary_dim`` dims rotate): rotate-half on the rotary slice (glm4-moe) and
interleaved even/odd pairs (glm4, minimax-m2). ``apply_rope_interleaved``
rotates every dim in complex pairs: the DeepSeek MLA convention on the
``qk_rope_head_dim`` dims.
"""

from __future__ import annotations

import math

import torch


def rope_inv_freq(
    head_dim: int, theta: float, rope_scaling: dict | None = None
) -> torch.Tensor:
    """-> [head_dim / 2] f32 inverse frequencies (CPU tensor)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    )
    if rope_scaling:
        rtype = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
        if rtype == "linear":
            inv_freq = inv_freq / rope_scaling["factor"]
        elif rtype == "llama3":
            # llama3.1-style NTK-by-parts (HF modeling_rope_utils)
            factor = rope_scaling["factor"]
            low_factor = rope_scaling["low_freq_factor"]
            high_factor = rope_scaling["high_freq_factor"]
            old_len = rope_scaling["original_max_position_embeddings"]
            wavelen = 2 * math.pi / inv_freq
            low_wavelen = old_len / low_factor
            high_wavelen = old_len / high_factor
            smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
            smooth = torch.clamp(smooth, 0.0, 1.0)
            smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
            out = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
            is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
            inv_freq = torch.where(is_medium, smoothed, out)
        elif rtype == "yarn":
            # YaRN NTK-by-parts: interpolation (long wavelengths) blends
            # with extrapolation (short) over a linear ramp between the
            # beta_fast/beta_slow correction dims
            factor = rope_scaling["factor"]
            dim = head_dim
            beta_fast = rope_scaling.get("beta_fast", 32.0)
            beta_slow = rope_scaling.get("beta_slow", 1.0)
            old_len = rope_scaling["original_max_position_embeddings"]

            def corr_dim(num_rot):
                return (
                    dim
                    * math.log(old_len / (num_rot * 2 * math.pi))
                    / (2 * math.log(theta))
                )

            low = max(math.floor(corr_dim(beta_fast)), 0)
            high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
            if low == high:
                high += 0.001
            ramp = torch.clamp(
                (torch.arange(dim // 2, dtype=torch.float32) - low)
                / (high - low),
                0.0,
                1.0,
            )
            extrap = 1.0 - ramp
            inv_freq = (inv_freq / factor) * (1 - extrap) + inv_freq * extrap
        # "default" falls through
    return inv_freq


def rope_mscale(rope_scaling: dict | None) -> float:
    """YaRN attention-magnitude correction, applied at the softmax scale
    as ``rope_mscale(...) ** 2`` (see the JAX module for the derivation)."""
    if not rope_scaling:
        return 1.0
    rtype = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
    if rtype != "yarn":
        return 1.0
    factor = rope_scaling["factor"]

    def get_mscale(scale, mscale=1.0):
        if scale <= 1.0:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    if "mscale" in rope_scaling:
        return get_mscale(factor, rope_scaling["mscale"])
    af = rope_scaling.get("attention_factor")
    if af is not None:
        return float(af)
    return get_mscale(factor)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [T, Hkv, D]
    positions: torch.Tensor,  # [T] int
    inv_freq: torch.Tensor,  # [D/2] f32, on q's device
) -> tuple[torch.Tensor, torch.Tensor]:
    angles = positions[:, None].float() * inv_freq[None, :]  # [T, D/2]
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    cos2 = torch.cat([cos, cos], dim=-1)[:, None, :]  # [T, 1, D]
    sin2 = torch.cat([sin, sin], dim=-1)[:, None, :]
    qf = q.float()
    kf = k.float()
    q_out = qf * cos2 + _rotate_half(qf) * sin2
    k_out = kf * cos2 + _rotate_half(kf) * sin2
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _angles(positions, inv_freq):
    angles = positions[:, None].float() * inv_freq[None, :]  # [T, rd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope_partial(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [T, Hkv, D]
    positions: torch.Tensor,  # [T] int
    inv_freq: torch.Tensor,  # [rotary_dim / 2] f32
    rotary_dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half rope on the first ``rotary_dim`` dims; the tail passes
    through (HF glm4_moe)."""
    cos, sin = _angles(positions, inv_freq)
    cos2 = torch.cat([cos, cos], dim=-1)[:, None, :]  # [T, 1, rd]
    sin2 = torch.cat([sin, sin], dim=-1)[:, None, :]

    def rot(x):
        xf = x.float()
        xr, rest = xf[..., :rotary_dim], xf[..., rotary_dim:]
        out = xr * cos2 + _rotate_half(xr) * sin2
        return torch.cat([out, rest], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def apply_rope_partial_interleaved_cos(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [T, Hkv, D]
    positions: torch.Tensor,  # [T] int
    inv_freq: torch.Tensor,  # [rotary_dim / 2] f32
    rotary_dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GLM4 convention: the first ``rotary_dim`` dims rotate in interleaved
    (even, odd) pairs, i.e. complex-pair rotation on the rotary slice; the
    tail passes through."""
    cos, sin = _angles(positions, inv_freq)
    cos, sin = cos[:, None, :], sin[:, None, :]  # [T, 1, rd/2]

    def rot(x):
        xf = x.float()
        xr, rest = xf[..., :rotary_dim], xf[..., rotary_dim:]
        pairs = xr.reshape(*xr.shape[:-1], -1, 2)
        xre, xim = pairs[..., 0], pairs[..., 1]
        out = torch.stack([xre * cos - xim * sin, xre * sin + xim * cos], dim=-1)
        return torch.cat([out.reshape(xr.shape), rest], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def apply_rope_interleaved(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [T, Hkv, D]
    positions: torch.Tensor,  # [T] int
    inv_freq: torch.Tensor,  # [D / 2] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved (complex-pair) convention: pairs (x[2i], x[2i+1]), as
    DeepSeek v2/v3 MLA rotates its rope dims (HF ``apply_rotary_emb``
    through ``view_as_complex``); not the llama rotate-half convention."""
    return apply_rope_partial_interleaved_cos(q, k, positions, inv_freq, q.shape[-1])
