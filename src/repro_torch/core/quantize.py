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
    # low + (rnd < scaled - low), updated in place: a stacked leaf's
    # float32 temporaries are multi-GB at granite-3-2b's widths
    q = low.add_(rnd < scaled.sub_(low))
    del scaled
    return q.clamp_(-levels - 1, levels).to(torch.int32), scale


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


def roundtrip_tp(uniforms, tree, bits: int = 16, *, tp_axis=None,
                 tp: int = 1, shard_dims=None):
    """`roundtrip` of a TENSOR-PARALLEL shard of the upload payload.

    On a model group's rank the tree holds only its Megatron shards, but
    the paper's worker quantizes the WHOLE model with one draw. This
    rebuilds exactly that: `uniforms` is the worker's whole (N,) row
    over the GLOBAL payload in leaf order (the row `roundtrip` takes at
    tp=1), from which each rank cuts its shard's positions; each
    tensor's scale comes from the GLOBAL abs-max, an all-reduce MAX over
    the model group. tp=2 therefore quantizes bit for bit like tp=1
    given the same values.

    shard_dims: per-leaf shard dim (negative) or None, in `tree_leaves`
    order, from `sharding.rules.tp_tree_dims` on the GLOBAL payload.
    Replicated leaves take their slice of the row whole.

    As in the JAX package, every rank holds the global row of uniforms
    (and a global-shaped view of each leaf's): the quantizer's memory
    does not shrink with tp, only the state and the Algorithm-2
    all-gather do."""
    if bits >= 32:
        return tree
    if tp_axis is None or tp <= 1:
        return roundtrip(uniforms, tree, bits)
    from repro_torch.launch import mesh
    group = mesh.axis_group(tp_axis)
    rank = torch.distributed.get_rank(group)
    levels = _levels(bits)
    leaves = tree_leaves(tree)
    if shard_dims is None or len(shard_dims) != len(leaves):
        raise ValueError("roundtrip_tp needs one shard dim (or None) a "
                         "leaf")
    gshapes = []
    for x, d in zip(leaves, shard_dims):
        shape = list(x.shape)
        if d is not None:
            shape[d] *= tp
        gshapes.append(shape)
    gsizes = [int(torch.Size(shape).numel()) for shape in gshapes]
    if uniforms.shape != (sum(gsizes),):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)} do "
                         f"not cover the global payload ({sum(gsizes)})")
    out, off = [], 0
    for x, d, gshape, gsize in zip(leaves, shard_dims, gshapes, gsizes):
        rnd = uniforms[off:off + gsize].reshape(gshape)
        off += gsize
        amax = x.abs().max()
        if d is not None:
            rnd = rnd.narrow(d, rank * x.shape[d], x.shape[d])
            amax = mesh.all_reduce_max(amax, group)
        q, scale = _quantize_leaf(x, rnd, amax, levels)
        out.append((q.float() * scale).to(x.dtype))
    return tree_unflatten(tree, out)


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
        out.append(q.float().mul_(scale).to(x.dtype))
    return tree_unflatten(stacked_tree, out)


def tree_bits(tree, bits: int = 16) -> int:
    """Total uplink payload in bits for a parameter tree."""
    return bits * sum(x.numel() for x in tree_leaves(tree))
