"""Sublayer blocks composed by the grouped backbone (port of
`repro.models.blocks`).

Each block is (init, apply) over a full residual sublayer; `apply`
takes an optional cache or state and returns (h, aux, new cache, state
or k/v), so the backbone treats train, prefill and decode alike. The
feed-forward of an attention layer is dense, or routed (`nn.moe`) when
the config has `moe`. Configs with biased projections (whisper) take
LayerNorm, the others RMSNorm. The cross-attention layer attends to
encoder or image states: whisper's without a feed-forward, llama-3.2-
vision's gated by tanh(gate_attn) and tanh(gate_ff) scalars, with its
own gated MLP.
"""
from __future__ import annotations

import torch

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.norms import (layernorm_apply, layernorm_init,
                                  rmsnorm_apply, rmsnorm_init)


def _norm_init(cfg: ArchConfig, d: int, *, device=None):
    if cfg.use_attn_bias:      # the whisper flavour: LayerNorm
        return layernorm_init(d, device=device)
    return rmsnorm_init(d, device=device)


def _norm_apply(cfg: ArchConfig, params, x):
    if cfg.use_attn_bias:
        return layernorm_apply(params, x)
    return rmsnorm_apply(params, x, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Self-attention + feed-forward layer (dense or MoE)
# ---------------------------------------------------------------------------

def attn_layer_init(generator: torch.Generator, cfg: ArchConfig, *,
                    causal: bool = True):
    """The parameters of a self-attention + feed-forward layer; `causal`
    is accepted as in the JAX package (the encoder's layers pass False)
    and changes no parameter."""
    device = generator.device
    params = {
        "ln_attn": _norm_init(cfg, cfg.d_model, device=device),
        "attn": nn.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, qk_norm=cfg.qk_norm,
            use_bias=cfg.use_attn_bias, fuse_qkv=cfg.fuse_proj),
        "ln_ff": _norm_init(cfg, cfg.d_model, device=device),
    }
    if cfg.moe is not None:
        params["ff"] = nn.moe_init(generator, cfg.d_model,
                                   cfg.moe.d_ff_expert, cfg.moe.n_experts)
    else:
        params["ff"] = nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   gated=not cfg.use_attn_bias,
                                   use_bias=cfg.use_attn_bias,
                                   fuse_gate=cfg.fuse_proj)
    return params


def attn_layer_apply(params, cfg: ArchConfig, h, *, window, inv_freq,
                     positions=None, causal: bool = True, cache=None,
                     cache_index=None, cache_write_mask=None,
                     paged_table=None, return_kv: bool = False,
                     moe_dropless: bool = False, tp_axis=None):
    """Returns (h, aux, new cache or k/v or None): the self-attention
    sublayer, then the feed-forward, each residual; aux is the MoE
    load-balance loss (0 for a dense feed-forward). The cache arguments
    select attention's serving paths (`nn.attention_apply`);
    moe_dropless routes every token (`nn.moe_apply(dropless=)`, the
    serving path). tp_axis runs the dense feed-forward Megatron-style on
    a model group's rank (attention and MoE replicate over the model
    axis)."""
    x = _norm_apply(cfg, params["ln_attn"], h)
    out = nn.attention_apply(
        params["attn"], x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        inv_freq=inv_freq, q_positions=positions, causal=causal,
        window=window, qk_norm=cfg.qk_norm, cache=cache,
        cache_index=cache_index, cache_write_mask=cache_write_mask,
        paged_table=paged_table, return_kv=return_kv,
        flash_repeat_kv=cfg.flash_repeat_kv)
    if cache is not None or return_kv:
        attn_out, new_cache = out
    else:
        attn_out, new_cache = out, None
    h = h + attn_out
    x = _norm_apply(cfg, params["ln_ff"], h)
    if cfg.moe is not None:
        ff_out, aux = nn.moe_apply(
            params["ff"], x, n_experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
            group_size=cfg.moe.group_size, dispatch=cfg.moe.dispatch,
            dropless=moe_dropless)
    else:
        ff_out = nn.mlp_apply(params["ff"], x, tp_axis=tp_axis)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ff_out, aux, new_cache


# ---------------------------------------------------------------------------
# Cross-attention layer (whisper's decoder; llama-3.2-vision, gated)
# ---------------------------------------------------------------------------

def cross_layer_init(generator: torch.Generator, cfg: ArchConfig, *,
                     gated: bool):
    device = generator.device
    params = {
        "ln": _norm_init(cfg, cfg.d_model, device=device),
        "attn": nn.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, qk_norm=cfg.qk_norm,
            use_bias=cfg.use_attn_bias),
    }
    if gated:
        # llama-3.2-vision: tanh-gated cross-attention with its own
        # feed-forward; both gates start at 0 (the layer starts closed)
        params["gate_attn"] = torch.zeros((), device=device)
        params["gate_ff"] = torch.zeros((), device=device)
        params["ln_ff"] = _norm_init(cfg, cfg.d_model, device=device)
        params["ff"] = nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   gated=True)
    return params


def cross_layer_apply(params, cfg: ArchConfig, h, *, enc_h=None,
                      enc_kv=None, gated: bool, tp_axis=None):
    """Cross-attend to encoder or image states: enc_h (b, t, d) raw
    states (train, prefill), projected to k/v here, or enc_kv, the
    projected {"k", "v"} of a cross cache (decode). No RoPE, no mask.
    Returns (h, aux, the projected k/v), so prefill fills the cross cache
    once. tp_axis runs the gated layer's feed-forward Megatron-style. A
    profile sees its forward as the range "cross_attention"."""
    with torch.profiler.record_function("cross_attention"):
        x = _norm_apply(cfg, params["ln"], h)
        if enc_kv is not None:
            attn_out = nn.attention_apply(
                params["attn"], x, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, inv_freq=None, causal=False,
                qk_norm=cfg.qk_norm, kv_override=enc_kv)
            kv_out = enc_kv
        else:
            attn_out, kv_out = nn.attention_apply(
                params["attn"], x, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, inv_freq=None, causal=False,
                qk_norm=cfg.qk_norm, kv_x=enc_h, return_kv=True)
        if gated:
            attn_out = torch.tanh(params["gate_attn"]).to(h.dtype) * attn_out
        h = h + attn_out
        if gated:
            x = _norm_apply(cfg, params["ln_ff"], h)
            ff_out = nn.mlp_apply(params["ff"], x, tp_axis=tp_axis)
            h = h + torch.tanh(params["gate_ff"]).to(h.dtype) * ff_out
        return (h, torch.zeros((), dtype=torch.float32, device=h.device),
                kv_out)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) layer
# ---------------------------------------------------------------------------

def ssm_layer_init(generator: torch.Generator, cfg: ArchConfig):
    s = cfg.ssm
    return {
        "ln": rmsnorm_init(cfg.d_model, device=generator.device),
        "mixer": nn.ssd_mixer_init(
            generator, cfg.d_model, d_state=s.d_state, head_dim=s.head_dim,
            expand=s.expand, n_groups=s.n_groups, d_conv=s.d_conv),
    }


def ssm_layer_apply(params, cfg: ArchConfig, h, *, state=None,
                    token_mask=None, scan_impl=None,
                    return_state: bool = False):
    """Returns (h, aux, new state or None): the residual Mamba-2
    sublayer (`nn.ssd_mixer_apply` for state, token_mask and
    return_state)."""
    s = cfg.ssm
    x = rmsnorm_apply(params["ln"], h, eps=cfg.norm_eps)
    out = nn.ssd_mixer_apply(
        params["mixer"], x, d_state=s.d_state, head_dim=s.head_dim,
        expand=s.expand, n_groups=s.n_groups, chunk=s.chunk, state=state,
        token_mask=token_mask, scan_impl=scan_impl,
        return_state=return_state)
    if state is not None or return_state:
        mixed, new_state = out
    else:
        mixed, new_state = out, None
    return (h + mixed, torch.zeros((), dtype=torch.float32, device=h.device),
            new_state)
