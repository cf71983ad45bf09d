"""Grouped-query self-attention with RoPE, qk-norm and sliding windows
on the training path (port of `repro.nn.attention`).

The dispatch is the JAX package's: when s * t reaches _FLASH_THRESHOLD
the blockwise flash path runs (on a CUDA tensor the Hopper kernel of
`repro_torch.kernels.flash_attn`, on a CPU tensor its plain version),
below it the naive softmax over the full (s, t) scores.

Cross-attention, KV caches, any-position serving and returned k/v
(`kv_x`, `cache`, `cache_index`, `cache_write_mask`, `paged_table`,
`q_positions`, `kv_positions`, `extra_mask`, `return_kv`,
`kv_override`) raise NotImplementedError (ROADMAP A14); the fused qkv
projection and the k/v-repeating flash layout of tensor parallelism
(`fuse_qkv`, `flash_repeat_kv`) raise too (A12).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.nn import initializers
from repro_torch.nn.flash_ref import NEG_INF
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rope import apply_rope

# from this (s_q * s_k) product on, attention goes through the blockwise
# flash path (the naive path materialises b*h*s*t float32 scores)
_FLASH_THRESHOLD = 512 * 512 + 1


def attention_init(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: Optional[int] = None, *,
                   qk_norm: bool = False, use_bias: bool = False,
                   fuse_qkv: bool = False):
    if fuse_qkv:
        raise NotImplementedError("the fused qkv projection (fuse_qkv) is "
                                  "not ported (ROADMAP A12)")
    if head_dim is None:
        head_dim = d_model // n_heads
    if n_heads % n_kv_heads:
        raise ValueError("GQA requires n_heads % n_kv_heads == 0")
    device = generator.device
    params = {
        "wq": initializers.lecun_normal(generator,
                                        (d_model, n_heads * head_dim)),
        "wk": initializers.lecun_normal(generator,
                                        (d_model, n_kv_heads * head_dim)),
        "wv": initializers.lecun_normal(generator,
                                        (d_model, n_kv_heads * head_dim)),
        "wo": initializers.lecun_normal(generator,
                                        (n_heads * head_dim, d_model),
                                        fan_in=n_heads * head_dim),
    }
    if use_bias:
        for name, width in (("bq", n_heads * head_dim),
                            ("bk", n_kv_heads * head_dim),
                            ("bv", n_kv_heads * head_dim), ("bo", d_model)):
            params[name] = torch.zeros(width, device=device)
    if qk_norm:
        params["q_norm"] = rmsnorm_init(head_dim, device=device)
        params["k_norm"] = rmsnorm_init(head_dim, device=device)
    return params


def _project(params, name, x, n_heads, head_dim):
    y = x @ params[f"w{name}"].to(x.dtype)
    bias = params.get(f"b{name}")
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.reshape(x.shape[:-1] + (n_heads, head_dim))


def build_mask(q_positions, k_positions, *, causal: bool,
               window: Optional[int]):
    """Additive float32 bias (..., q, k): 0 where query position i may
    see key position j (j <= i if causal; j > i - window if windowed),
    NEG_INF elsewhere."""
    qp = q_positions[..., :, None]
    kp = k_positions[..., None, :]
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    return torch.where(allowed, 0.0, NEG_INF).float()


def attention_apply(params, x, *, n_heads: int, n_kv_heads: int,
                    inv_freq=None, causal: bool = True,
                    window: Optional[int] = None, qk_norm: bool = False,
                    flash_repeat_kv: bool = False, **serving):
    """Self-attention forward. x: (b, s, d); query and key i sit at
    position i. Returns y (b, s, d)."""
    used = sorted(k for k, v in serving.items()
                  if v is not None and v is not False)
    if used:
        raise NotImplementedError(f"attention_apply({', '.join(used)}) is "
                                  f"not ported; the port runs training "
                                  f"self-attention (ROADMAP A14)")
    if "wqkv" in params:
        raise NotImplementedError("the fused qkv projection (wqkv) is not "
                                  "ported (ROADMAP A12)")
    b, s, _ = x.shape
    head_dim = params["wq"].shape[1] // n_heads
    q = _project(params, "q", x, n_heads, head_dim)
    k = _project(params, "k", x, n_kv_heads, head_dim)
    v = _project(params, "v", x, n_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm_apply(params["q_norm"], q)
        k = rmsnorm_apply(params["k_norm"], k)

    positions = torch.arange(s, device=x.device)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)

    group = n_heads // n_kv_heads
    scale = head_dim ** -0.5
    if s * s >= _FLASH_THRESHOLD:
        if flash_repeat_kv and group > 1:
            raise NotImplementedError("the k/v-repeating flash layout "
                                      "(flash_repeat_kv) is not ported "
                                      "(ROADMAP A12)")
        # (b, s, H, hd) queries against the unrepeated (b, s, KV, hd) k/v
        ctx = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        mask = build_mask(positions, positions, causal=causal, window=window)
        qg = q.reshape(b, s, n_kv_heads, group, head_dim)
        logits = torch.einsum("bsngh,btnh->bnsgt", qg.float(),
                              k.float()) * scale
        logits = logits + mask[None, None, :, None, :]
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bnsgt,btnh->bsngh", probs, v.float())
    ctx = ctx.reshape(b, s, n_heads * head_dim).to(x.dtype)

    y = ctx @ params["wo"].to(x.dtype)
    if "bo" in params:
        y = y + params["bo"].to(x.dtype)
    return y
