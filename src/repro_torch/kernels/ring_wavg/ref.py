"""Plain PyTorch versions for the ring reduction: the ring_accum kernel's
(the CPU path and the oracle `chip_smoke.py` holds the kernel to on the
card) and the order-independent float64 twin of the whole ring."""
import numpy as np
import torch

from repro_torch.core import quantize
from repro_torch.tree import tree_index, tree_leaves, tree_unflatten


def ring_accum_ref(acc, q, coef):
    """acc (rows, BLOCK_N) f32 += coef (rows,) f32 x float(q (rows,
    BLOCK_N) int16 | int32 | f32), in place; returns acc."""
    return acc.add_(coef[:, None] * q.float())


def ring_average_ref(stacked_tree, weights, *, uniforms=None,
                     bits: int = 32):
    """sum_k w_norm[k] * dequant_k(tree_k), reduced in float64 numpy, in
    the dtypes of `stacked_tree` (leading axis K on every leaf).

    With bits < 32 and `uniforms` (K, N), device k's slice is quantized
    with `quantize.quantize_tree(uniforms[k], ...)`, the stream of the
    ring's wire, so only reduction order and precision are under test."""
    leaves = tree_leaves(stacked_tree)
    k = leaves[0].shape[0]
    w = np.asarray(weights.cpu() if torch.is_tensor(weights) else weights,
                   np.float64)
    w_norm = w / max(float(w.sum()), 1e-12)
    acc = [np.zeros(tuple(x.shape[1:]), np.float64) for x in leaves]
    for i in range(k):
        dev = tree_index(stacked_tree, i)
        if bits < 32 and uniforms is not None:
            q, s = quantize.quantize_tree(uniforms[i], dev, bits)
            dev = quantize.dequantize_tree(q, s)
        for j, leaf in enumerate(tree_leaves(dev)):
            acc[j] = acc[j] + w_norm[i] * leaf.double().cpu().numpy()
    return tree_unflatten(stacked_tree, [
        torch.from_numpy(a).to(x.dtype) for a, x in zip(acc, leaves)])
