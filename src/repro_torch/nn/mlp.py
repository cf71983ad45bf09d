"""Feed-forward blocks (port of `repro.nn.mlp`): SwiGLU (the LLM
default) and GELU (whisper), each with optional biases.

`mlp_apply(tp_axis=...)` runs the block Megatron-style on a model
group's rank: w_in / w_gate (and b_in) hold a d_ff shard
(column-parallel), w_out the matching input-dim shard (row-parallel),
and ONE all-reduce (`reduce_from_tp`) closes the block; the replicated
b_out is added after the reduction, so the result matches the unsharded
block to f32 round-off. The fused [in | gate] layout (`fuse_gate`, leaf
`w_inga`) interleaves both halves on one output dim, which a contiguous
model-axis shard would split across the in/gate boundary, so it refuses
tp_axis, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers
from repro_torch.nn.tp import copy_to_tp, reduce_from_tp


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, use_bias: bool = False,
             fuse_gate: bool = False):
    device = generator.device
    if gated and fuse_gate:
        # fused [in | gate]: one matmul forward, one dx all-reduce backward
        params = {
            "w_inga": initializers.lecun_normal(generator,
                                                (d_model, 2 * d_ff)),
            "w_out": initializers.lecun_normal(generator, (d_ff, d_model),
                                               fan_in=d_ff),
        }
        if use_bias:
            params["b_inga"] = torch.zeros(2 * d_ff, device=device)
            params["b_out"] = torch.zeros(d_model, device=device)
        return params
    params = {
        "w_in": initializers.lecun_normal(generator, (d_model, d_ff)),
        "w_out": initializers.lecun_normal(generator, (d_ff, d_model),
                                           fan_in=d_ff),
    }
    if gated:
        params["w_gate"] = initializers.lecun_normal(generator,
                                                     (d_model, d_ff))
    if use_bias:
        params["b_in"] = torch.zeros(d_ff, device=device)
        params["b_out"] = torch.zeros(d_model, device=device)
    return params


def mlp_apply(params, x, *, tp_axis=None):
    """SwiGLU silu(x W_gate) * (x W_in) when the tree has `w_gate` (or
    the fused `w_inga`: [in | gate]), else GELU (tanh form, as
    `jax.nn.gelu`) of x W_in; then W_out."""
    if "w_inga" in params:
        if tp_axis is not None:
            raise ValueError(
                "fused [in|gate] (fuse_gate=True) cannot be tensor-parallel:"
                " a contiguous model-axis shard of w_inga would split the"
                " in/gate halves; init with fuse_gate=False for TP")
        fused = x @ params["w_inga"].to(x.dtype)
        if "b_inga" in params:
            fused = fused + params["b_inga"].to(x.dtype)
        d_ff = fused.shape[-1] // 2
        h = F.silu(fused[..., d_ff:]) * fused[..., :d_ff]
    else:
        xt = copy_to_tp(x, tp_axis)
        h = xt @ params["w_in"].to(x.dtype)
        if "b_in" in params:
            h = h + params["b_in"].to(x.dtype)
        if "w_gate" in params:
            h = F.silu(xt @ params["w_gate"].to(x.dtype)) * h
        else:
            h = F.gelu(h, approximate="tanh")
    y = reduce_from_tp(h @ params["w_out"].to(x.dtype), tp_axis)
    if "b_out" in params:
        y = y + params["b_out"].to(x.dtype)
    return y
