"""Megatron-style tensor-parallel collectives (port of `repro.nn.tp`).

Where the JAX package runs a worker's slice under `jax.shard_map` with a
manual `model` mesh axis, the port runs it on the ranks of a model
process group (`repro_torch.launch.mesh.spawn(..., tp=...)`). The
Megatron f/g operators are `torch.autograd.Function`s over that group's
collectives, so the collective on each side of the tape is pinned:

  `copy_to_tp`     - Megatron "f": identity forward, all-reduce backward.
      Marks a REPLICATED activation entering a column-parallel matmul;
      the backward all-reduce sums each rank's partial dx.
  `reduce_from_tp` - Megatron "g": all-reduce forward, identity backward.
      Closes a row-parallel matmul: the forward sums the partial
      products over the sharded contraction dim, and the (replicated)
      cotangent flows straight through.
  `gather_from_tp` - all-gather forward, own slice backward.
      Rebuilds a full activation from a column-parallel output.

The JAX package pins these with custom VJPs because differentiating a
raw `psum` silently drops the cross-rank dx sum of a column-parallel
matmul; here autograd never sees a collective at all.

`axis` is the string "model" (the group `launch.mesh` registered for
this rank, so specs take the JAX package's argument), a process group,
or None. All three are the identity for None, so TP-aware model code
runs unchanged at tp=1. On a gloo group the tensors travel through the
host (`launch.mesh.all_reduce_sum`, `all_gather`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch import mesh


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return mesh.all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.local = group, dim, x.shape[dim]
        parts = mesh.all_gather(x, group)            # (tp, ...)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        return (g.narrow(ctx.dim, rank * ctx.local, ctx.local), None, None)


def copy_to_tp(x, axis):
    """Identity forward / all-reduce backward (column-parallel input).
    The identity when axis is None."""
    return x if axis is None else _CopyToTp.apply(x, mesh.axis_group(axis))


def reduce_from_tp(x, axis):
    """All-reduce forward / identity backward (row-parallel output). The
    identity when axis is None."""
    return (x if axis is None
            else _ReduceFromTp.apply(x, mesh.axis_group(axis)))


def gather_from_tp(x, axis, dim=-1):
    """All-gather forward / own slice backward (column-parallel output
    gathered along `dim`). The identity when axis is None."""
    if axis is None:
        return x
    return _GatherFromTp.apply(x, mesh.axis_group(axis), dim % x.dim())


def tp_rank(axis) -> int:
    """This rank's index in the model group (0 when axis is None)."""
    return 0 if axis is None else dist.get_rank(mesh.axis_group(axis))


__all__ = ["copy_to_tp", "reduce_from_tp", "gather_from_tp", "tp_rank"]
