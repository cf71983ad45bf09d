"""Uplink quantization (paper Section IV: 16 bits per parameter).

Uniform stochastic quantization with a per-tensor scale, ported from
`repro.core.quantize`. Randomness enters as tensors: one device's
stochastic-rounding uniforms are ONE (N,) draw over its whole flattened
payload (N parameters, `repro_torch.tree` leaf order), sliced per leaf —
the layout of the JAX package's draw. Given the same uniforms and the
same parameters, the integers match the JAX package bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _quantize_leaf(x, rnd, amax, levels):
    """One leaf's uniform stochastic quantization: (q_int32, scale).

    All math runs in float32 regardless of the leaf dtype: in bf16 the
    clip bound `levels` = 32767 is not representable (it rounds to
    32768). `amax` broadcasts against `x`, so a stacked leaf with a
    (K, 1, ...) amax quantizes every device with its own scale."""
    scale = torch.clamp(amax.float(), min=1e-12) / levels
    scaled = x.float() / scale
    low = torch.floor(scaled)
    q = low + (rnd < scaled - low)
    return torch.clamp(q, -levels - 1, levels).to(torch.int32), scale


def _levels(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def quantize_tree(uniforms, tree, bits: int = 16):
    """Returns (quantized_int_tree, scales_tree); `uniforms` is (N,)."""
    levels = _levels(bits)
    leaves = tree_leaves(tree)
    if uniforms.shape != (sum(x.numel() for x in leaves),):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)} do "
                         f"not cover the tree's parameters")
    q_leaves, scales, off = [], [], 0
    for x in leaves:
        rnd = uniforms[off:off + x.numel()].reshape(x.shape)
        off += x.numel()
        q, scale = _quantize_leaf(x, rnd, x.abs().max(), levels)
        q_leaves.append(q)
        scales.append(scale)
    return tree_unflatten(tree, q_leaves), tree_unflatten(tree, scales)


def dequantize_tree(q_tree, scales_tree):
    return tree_map(lambda q, s: q.float() * s, q_tree, scales_tree)


def roundtrip(uniforms, tree, bits: int = 16):
    """Quantize-dequantize (what the server receives on the uplink)."""
    if bits >= 32:
        return tree
    q, s = quantize_tree(uniforms, tree, bits)
    return tree_map(lambda d, x: d.to(x.dtype), dequantize_tree(q, s), tree)


def roundtrip_stacked(uniforms, stacked_tree, bits: int = 16):
    """Per-device quantize-dequantize of a tree with leading axis K
    (Step 3: every device quantizes its OWN upload with its own stream).

    uniforms: (K, N) — row k is device k's draw. All K devices are
    quantized together, leaf by leaf, each with its own per-leaf scale.
    """
    if bits >= 32:
        return stacked_tree
    levels = _levels(bits)
    leaves = tree_leaves(stacked_tree)
    k = leaves[0].shape[0]
    n = sum(x[0].numel() for x in leaves)
    if uniforms.shape != (k, n):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)} do "
                         f"not match the stacked payload ({k}, {n})")
    out, off = [], 0
    for x in leaves:
        size = x[0].numel()
        rnd = uniforms[:, off:off + size].reshape(x.shape)
        off += size
        amax = x.reshape(k, -1).abs().amax(dim=1)
        q, scale = _quantize_leaf(
            x, rnd, amax.reshape((k,) + (1,) * (x.ndim - 1)), levels)
        out.append((q.float() * scale).to(x.dtype))
    return tree_unflatten(stacked_tree, out)


def tree_bits(tree, bits: int = 16) -> int:
    """Total uplink payload in bits for a parameter tree."""
    return bits * sum(x.numel() for x in tree_leaves(tree))
