"""Algorithm 2 — server discriminator averaging.

    phi = (sum_{k in S} m_k phi_k) / (sum_{k in S} m_k)

Scheduling is expressed through the weight vector: w_k = m_k for
scheduled devices and 0 otherwise, so one weighted mean covers partial
participation, stragglers, and unequal sample sizes.

The port runs Algorithm 2 the way the JAX package's mesh hot path does
(`repro.core.averaging.weighted_average_psum(impl="pallas")`): the
stacked tree is flattened into ONE (K, N) float32 payload in the leaf
order of `repro_torch.tree` (that of `_flatten_stacked`) and reduced by
ONE call of the wavg kernel — one launch per round on a CUDA tensor.
(The JAX stacked round averages leaf by leaf with `impl="jnp"`; both
compute the same weighted mean, to float32 round-off.)

NO-SURVIVOR SEMANTICS: a round where every weight is zero has no
defined average; `fallback` (the previous global) is kept instead, by a
`torch.where` on the device, with no host sync.

ROBUST REDUCERS: `robust=` (a `RobustConfig`) reduces the same flat
payload with a robust method of `repro_torch.kernels.robust_avg` and the
RAW weights (0 = dropped worker) — again one kernel launch per round:
the trimmed_wavg kernel for "trimmed_mean", the wavg kernel with
effective weights for "norm_clip" and "krum".
"""
from __future__ import annotations

import torch

from repro_torch.kernels.robust_avg import ops as robust_ops
from repro_torch.kernels.wavg import ops as wavg_ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _normalized(weights):
    weights = weights.float()
    return weights / torch.clamp(weights.sum(), min=1e-12)


def flatten_stacked(stacked_params):
    """A stacked tree (leading axis K on every leaf) as one contiguous
    (K, N) float32 payload, leaves in flatten order."""
    leaves = tree_leaves(stacked_params)
    k = leaves[0].shape[0]
    return torch.cat([x.reshape(k, -1).float() for x in leaves], dim=1)


def unflatten_row(flat, like_stacked):
    """Inverse of `flatten_stacked` for one (N,) row: a tree shaped like
    one slice of `like_stacked`, in its dtypes."""
    out, off = [], 0
    for x in tree_leaves(like_stacked):
        size = x[0].numel()
        out.append(flat[off:off + size].reshape(x.shape[1:]).to(x.dtype))
        off += size
    return tree_unflatten(like_stacked, out)


def weighted_average(stacked_params, weights, *, robust=None,
                     fallback=None):
    """stacked_params: tree with leading device axis K; weights: (K,).

    Returns the weighted average with the leading axis contracted.
    `robust` (a `RobustConfig`) selects a robust reducer, run with the
    raw weights. `fallback` (unstacked, result-shaped) is returned when
    the total weight is zero — the no-survivor round keeps the previous
    global.
    """
    flat = flatten_stacked(stacked_params)
    if robust is not None:
        avg_flat = robust_ops.robust_average(flat, weights.float(), robust)
    else:
        avg_flat = wavg_ops.weighted_average(flat, _normalized(weights))
    avg = unflatten_row(avg_flat, stacked_params)
    if fallback is None:
        return avg
    total = weights.float().sum()
    return tree_map(lambda a, f: torch.where(total > 0, a, f.to(a.dtype)),
                    avg, fallback)


def broadcast_like(params, n: int):
    """Tile a tree to a stacked leading device axis (Step 5 broadcast)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()),
                    params)
