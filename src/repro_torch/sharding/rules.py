"""Which leaves tensor parallelism shards, and on which dim: the TP half
of `repro.sharding.rules` (the mesh layout's `model` axis).

Column-parallel weights (and their biases) shard the output dim;
row-parallel weights shard the input dim. Negative dims make one rule
cover plain parameters, optimizer moments (the same leaf names under
m / v / mu) and trees stacked on a leading K axis. Leaves with other
names (attention, norms, convs, embeddings, SSM) replicate over the
model axis, and so does EVERYTHING under an "experts" subtree: MoE
experts reuse the MLP leaf names but have no in-slice collectives, so
sharding them would silently drop the cross-rank reduction. A TP-named
leaf whose dim tp does not divide is an ERROR, not a replication
fallback (`tp_leaf_dim`).

Where the JAX package hands shard_map per-leaf PartitionSpecs
(`tp_param_specs`, `shard_round_state_specs`), the port cuts a global
tree into rank r's shards (`shard_tree`) and puts shards back into the
global tree (`unshard_tree` from every rank's shards, `gather_tree`
with the model group's all-gather).

The GSPMD half of the JAX module is not ported, by design: `plan_for`,
`param_specs`, `state_specs`, the FSDP rules and `cache_specs` place one
global program's arrays on a device mesh, and the port runs no global
program. Its processes each hold their own tensors (a rank's worker, or
its shard of one), and one card has no device mesh, so there is nothing
for a placement to place. What the JAX module's shard_map specs serve,
the port covers here: `shard_round_state_specs` by `shard_tree` /
`gather_tree`, the TP specs by `tp_leaf_dim` / `tp_tree_dims`. (ROADMAP
item 10c, closed in writing; the launch step's `act_disc_spec` and
`MeshConfig` and the GSPMD variants `discrep`, `moepin` and `headpin`
go with it, `launch/steps.py`, `launch/variants.py`.)
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

_TP_COL = {"w_in", "w_gate", "b_in"}      # output-dim shard
_TP_ROW = {"w_out"}                       # input-dim shard
_TP_REPLICATED_SUBTREES = {"experts"}


def tp_leaf_dim(name: str, shape, tp: int):
    """The model-axis shard dim of one leaf (negative), or None when the
    leaf replicates by name.

    A TP-NAMED leaf whose shard dim `tp` does not divide RAISES instead
    of silently replicating: the Megatron apply path all-reduces
    unconditionally, so a replicated leaf would have its outputs
    inflated by exactly tp."""
    if tp <= 1:
        return None
    if name in _TP_COL and len(shape) >= 1:
        dim = -1
    elif name in _TP_ROW and len(shape) >= 2:
        dim = -2
    else:
        return None
    if shape[dim] % tp != 0:
        raise ValueError(
            f"tensor-parallel leaf {name!r} {tuple(shape)}: shard dim "
            f"{shape[dim]} is not divisible by tp={tp} — the Megatron "
            f"apply path would psum un-sharded products (outputs x{tp}); "
            f"pick a divisible width or a different tp")
    return dim


def _paths(tree, names=()):
    """(path names, leaf) pairs in `repro_torch.tree` leaf order (the JAX
    package's tree-flatten order)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _paths(tree[k], names + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, child in enumerate(tree)
                for pair in _paths(child, names + (f"[{i}]",))]
    return [(names, tree)]


def _tp_path_dim(path_names, shape, tp: int):
    """`tp_leaf_dim` with the leaf's PATH: any leaf under a replicated
    subtree (MoE experts) replicates whatever its name."""
    if any(n in _TP_REPLICATED_SUBTREES for n in path_names):
        return None
    name = path_names[-1] if path_names else ""
    return tp_leaf_dim(name, shape, tp)


def tp_tree_dims(tree, tp: int):
    """Shard dims of every leaf of `tree`, as a tuple in `tree_leaves`
    order (None: replicated).

    IMPORTANT: call this on GLOBAL-shaped trees. Divisibility is decided
    on the global dim; deciding it again on a shard could disagree
    (global 6 % 2 == 0, local 3 % 2 != 0)."""
    return tuple(_tp_path_dim(names, tuple(leaf.shape), tp)
                 for names, leaf in _paths(tree))


def tp_local_size(tree, tp: int) -> int:
    """Per-TP-rank element count of the GLOBAL `tree`: sharded leaves
    count size / tp. The Algorithm-2 all-gather payload per rank."""
    dims = tp_tree_dims(tree, tp)
    return sum(x.numel() // (tp if d is not None else 1)
               for x, d in zip(tree_leaves(tree), dims))


def shard_tree(tree, tp: int, rank: int, dims=None):
    """Model rank `rank`'s shards of the GLOBAL `tree` (each sharded leaf
    narrowed to its 1/tp slice of the shard dim, contiguous; replicated
    leaves as they are). `dims` defaults to `tp_tree_dims(tree, tp)`."""
    if dims is None:
        dims = tp_tree_dims(tree, tp)
    out = []
    for x, d in zip(tree_leaves(tree), dims):
        if d is None:
            out.append(x)
            continue
        size = x.shape[d] // tp
        out.append(x.narrow(d, rank * size, size).contiguous())
    return tree_unflatten(tree, out)


def unshard_tree(shards, dims):
    """The global tree from every model rank's shards (a list in rank
    order): sharded leaves concatenated on their dim, replicated ones
    taken from rank 0."""
    per_rank = [tree_leaves(s) for s in shards]
    out = []
    for i, d in enumerate(dims):
        parts = [leaves[i] for leaves in per_rank]
        out.append(parts[0] if d is None else torch.cat(parts, dim=d))
    return tree_unflatten(shards[0], out)


def gather_tree(local, dims, axis):
    """The global tree from this rank's shards: every sharded leaf
    all-gathered over the model group (`axis`: "model" or a process
    group) and concatenated on its dim. Every rank of the group calls
    it; every rank gets the global tree."""
    from repro_torch.launch import mesh
    group = mesh.axis_group(axis)
    out = []
    for x, d in zip(tree_leaves(local), dims):
        if d is None:
            out.append(x)
        else:
            out.append(torch.cat(list(mesh.all_gather(x, group).unbind(0)),
                                 dim=d))
    return tree_unflatten(local, out)


__all__ = ["tp_leaf_dim", "tp_tree_dims", "tp_local_size", "shard_tree",
           "unshard_tree", "gather_tree"]
