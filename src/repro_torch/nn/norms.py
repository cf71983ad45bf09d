"""Normalization layers: RMSNorm (the backbones), LayerNorm (whisper)
and batch-norm for the DCGAN (NHWC), in batch-statistics mode."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def batchnorm_init(c: int, *, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


def batchnorm_apply(params, x, *, eps: float = 1e-5):
    """Normalizes over (N, H, W) with the current batch's mean and biased
    variance, always — as `repro.nn.norms.batchnorm_apply` does. There
    are no running statistics: `training=True` with no running buffers,
    never a module in eval mode."""
    y = F.batch_norm(x.permute(0, 3, 1, 2), None, None,
                     weight=params["scale"], bias=params["bias"],
                     training=True, eps=eps)
    return y.permute(0, 2, 3, 1)


def rmsnorm_init(d: int, *, device=None):
    return {"scale": torch.ones(d, device=device)}


def rmsnorm_apply(params, x, *, eps: float = 1e-6):
    """In float32 with `(var + eps) ** -0.5`, as the JAX package computes
    it; the result takes x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * (var + eps) ** -0.5
    return (y * params["scale"].float()).to(dtype)


def layernorm_init(d: int, *, device=None):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm_apply(params, x, *, eps: float = 1e-5):
    """In float32 with the biased variance and `(var + eps) ** -0.5`, as
    the JAX package computes it; the result takes x's dtype. eps is
    LayerNorm's own 1e-5, not the config's `norm_eps`."""
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mean) * (var + eps) ** -0.5
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)
