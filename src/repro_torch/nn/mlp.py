"""Feed-forward blocks (port of `repro.nn.mlp`): SwiGLU (the LLM
default) and GELU (whisper), each with optional biases.

The fused [in | gate] projection (`fuse_gate`, leaf `w_inga`) and the
tensor-parallel form (`tp_axis`) are not ported (ROADMAP A12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers


def _refuse_a12(what: str):
    raise NotImplementedError(f"{what} is not ported (ROADMAP A12)")


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, use_bias: bool = False,
             fuse_gate: bool = False):
    if gated and fuse_gate:
        _refuse_a12("the fused [in | gate] projection (fuse_gate)")
    device = generator.device
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
    """SwiGLU silu(x W_gate) * (x W_in) when the tree has `w_gate`, else
    GELU (tanh form, as `jax.nn.gelu`) of x W_in; then W_out."""
    if "w_inga" in params:
        _refuse_a12("the fused [in | gate] projection (w_inga)")
    if tp_axis is not None:
        _refuse_a12("the tensor-parallel feed-forward (tp_axis)")
    h = x @ params["w_in"].to(x.dtype)
    if "b_in" in params:
        h = h + params["b_in"].to(x.dtype)
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"].to(x.dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ params["w_out"].to(x.dtype)
    if "b_out" in params:
        y = y + params["b_out"].to(x.dtype)
    return y
