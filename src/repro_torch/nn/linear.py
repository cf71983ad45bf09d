"""Dense projection with Megatron column- and row-parallel modes (port
of `repro.nn.linear`).

`tp_mode` says how a TP-sharded weight takes part on a model-group rank
(see nn/tp.py for the collective pairs):

  "column" - the weight shard is a slice of the OUTPUT dim. The input is
      replicated (copy_to_tp pins the backward dx all-reduce); the output
      stays sharded unless gather_output=True all-gathers it.
  "row"    - the weight shard is a slice of the INPUT dim. The input
      arrives sharded (the preceding column layer's output); the partial
      products are all-reduced (reduce_from_tp) and the replicated bias
      is added AFTER the reduction, as in the unsharded matmul.

With tp_axis=None both modes are the plain dense projection.
"""
from __future__ import annotations

import torch

from repro_torch.nn import initializers
from repro_torch.nn.tp import copy_to_tp, gather_from_tp, reduce_from_tp


def linear_init(generator: torch.Generator, d_in: int, d_out: int, *,
                use_bias: bool = True, init=initializers.lecun_normal):
    params = {"w": init(generator, (d_in, d_out))}
    if use_bias:
        params["b"] = torch.zeros(d_out, device=generator.device)
    return params


def linear_apply(params, x, *, tp_axis=None, tp_mode=None,
                 gather_output: bool = False):
    if tp_axis is not None and tp_mode == "row":
        y = reduce_from_tp(x @ params["w"].to(x.dtype), tp_axis)
        if "b" in params:
            y = y + params["b"].to(x.dtype)
        return y
    if tp_axis is not None and tp_mode == "column":
        y = copy_to_tp(x, tp_axis) @ params["w"].to(x.dtype)
        if "b" in params:
            y = y + params["b"].to(x.dtype)     # the bias shard, output dim
        if gather_output:
            y = gather_from_tp(y, tp_axis, dim=-1)
        return y
    if tp_axis is not None:
        raise ValueError(f"tp_mode must be 'column' or 'row' with a "
                         f"tp_axis (got {tp_mode!r})")
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


__all__ = ["linear_init", "linear_apply"]
