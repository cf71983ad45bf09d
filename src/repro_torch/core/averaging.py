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

THE MESH LAYOUT (`weighted_average_psum`): every rank of a
`torch.distributed` group holds ITS worker's parameters and weight, and
Algorithm 2 is an explicit collective over the group, as in the JAX
package's shard_map path: a per-leaf all-reduce (``impl="jnp"``), one
all-gather of the flat payload reduced by ONE wavg (or robust) kernel
launch (``impl="pallas"``), or the chunked ring with the payload encoded
on the wire (``impl="ring"``, `repro_torch.kernels.ring_wavg`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ring_wavg import ops as ring_ops
from repro_torch.kernels.robust_avg import ops as robust_ops
from repro_torch.kernels.wavg import ops as wavg_ops
from repro_torch.launch import mesh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _normalized(weights):
    weights = weights.float()
    return weights / torch.clamp(weights.sum(), min=1e-12)


def flatten_stacked(stacked_params):
    """A stacked tree (leading axis K on every leaf) as one contiguous
    (K, N) float32 payload, leaves in flatten order. Each leaf is copied
    (and widened) into its columns, so no float32 copy of a narrower
    leaf is held beside the payload."""
    leaves = tree_leaves(stacked_params)
    k = leaves[0].shape[0]
    sizes = [x[0].numel() for x in leaves]
    flat = torch.empty((k, sum(sizes)), dtype=torch.float32,
                       device=leaves[0].device)
    off = 0
    for x, size in zip(leaves, sizes):
        flat[:, off:off + size].copy_(x.reshape(k, -1))
        off += size
    return flat


def _unflatten(flat, like):
    """Inverse of flattening one tree: the (N,) payload as a tree shaped
    like `like` (unstacked), in its dtypes."""
    out, off = [], 0
    for x in tree_leaves(like):
        out.append(flat[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return tree_unflatten(like, out)


def _keep_fallback(avg, fallback, total):
    """`fallback` where no worker survived (total weight zero)."""
    if fallback is None:
        return avg
    return tree_map(lambda a, f: torch.where(total > 0, a, f.to(a.dtype)),
                    avg, fallback)


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
    avg = _unflatten(avg_flat, tree_map(lambda x: x[0], stacked_params))
    return _keep_fallback(avg, fallback, weights.float().sum())


def weighted_average_psum(local_params, local_weight, *, group=None,
                          impl: str = "jnp", robust=None, uniforms=None,
                          quantize_bits: int = 32, fallback=None,
                          weights=None):
    """The mesh layout's Algorithm 2: every rank of `group` (the default
    group when None) holds ITS worker's parameters and (0-dim) weight;
    returns the weighted average on every rank. Port of
    `repro.core.averaging.weighted_average_psum`.

    impl="jnp"    - a per-leaf all-reduce of x * w, and one of w.
    impl="pallas" - the local tree flattened (leaf order of
        `repro_torch.tree`) into ONE f32 payload, all-gathered into
        (K, N) with the (K,) weights, and reduced by ONE wavg launch.
    A non-None `robust` (a `RobustConfig`) takes the same flat path and
        reduces with the robust method and the RAW gathered weights.
    impl="ring"   - the ring collective (`kernels.ring_wavg`): k-1
        chunked hops with dequantize-and-accumulate in the ring_accum
        kernel. With `quantize_bits` < 32 the payload is quantized with
        this rank's `uniforms` (N,) and travels encoded. It does not
        compose with `robust`.

    `fallback` (local-params-shaped) is returned when the total weight is
    zero: every impl keeps the previous global on a no-survivor round.
    `weights`: the group's (K,) weights in rank order, when the caller
    has gathered them already; None gathers them here.
    """
    if impl == "ring":
        if robust is not None:
            raise ValueError(
                "impl='ring' does not compose with robust reducers; "
                "robust aggregation stays on the flat gather path")
        return ring_ops.ring_average_psum(
            local_params, local_weight, group=group, uniforms=uniforms,
            bits=quantize_bits, fallback=fallback, weights=weights)

    leaves = tree_leaves(local_params)
    if not leaves:
        return local_params
    w_k = torch.as_tensor(local_weight, dtype=torch.float32,
                          device=leaves[0].device)
    if impl == "pallas" or robust is not None:
        flat = torch.cat([x.reshape(-1).float() for x in leaves])
        stacked = mesh.all_gather(flat, group)                  # (K, N)
        w_full = (mesh.all_gather(w_k.reshape(1), group).reshape(-1)
                  if weights is None else weights)
        if robust is not None:
            avg_flat = robust_ops.robust_average(stacked, w_full, robust)
        else:
            avg_flat = wavg_ops.weighted_average(stacked,
                                                 _normalized(w_full))
        return _keep_fallback(_unflatten(avg_flat, local_params), fallback,
                              w_full.sum())

    if impl != "jnp":
        raise ValueError(f"unknown weighted_average_psum impl {impl!r}")
    total = (mesh.all_reduce_sum(w_k, group) if weights is None
             else weights.sum())
    avg = tree_map(
        lambda x: (mesh.all_reduce_sum(x.float() * w_k, group)
                   / torch.clamp(total, min=1e-12)).to(x.dtype),
        local_params)
    return _keep_fallback(avg, fallback, total)


def broadcast_like(params, n: int):
    """Tile a tree to a stacked leading device axis (Step 5 broadcast)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()),
                    params)


def select_tree(mask, tree_true, tree_false):
    """Per-device `torch.where` over stacked trees: device k's slice from
    `tree_true` where mask[k], else from `tree_false` (straggler
    exclusion). mask: (K,) bool, or a 0-dim bool for unstacked trees."""
    return tree_map(
        lambda a, b: torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                                 a, b),
        tree_true, tree_false)
