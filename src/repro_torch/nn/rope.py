"""Rotary position embeddings (port of `repro.nn.rope`).

The halves convention of the JAX package: channel i pairs with channel
i + head_dim/2 (not interleaved pairs). All math in float32.
"""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, base: float = 10000.0, device=None):
    """Inverse frequencies 1 / base ** (2i / head_dim), (head_dim // 2,)
    float32; head_dim must be even."""
    if head_dim % 2:
        raise ValueError("RoPE head_dim must be even")
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (base ** exponent)


def apply_rope(x, positions, inv_freq):
    """Rotate pairs of channels. x: (..., seq, heads, head_dim);
    positions: (..., seq) integers. The result takes x's dtype."""
    angles = positions[..., :, None].float() * inv_freq    # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
