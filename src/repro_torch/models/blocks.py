"""Sublayer blocks composed by the grouped backbone (port of
`repro.models.blocks` for the dense, moe, ssm and hybrid families).

Each block is (init, apply) over a full residual sublayer; `apply`
takes an optional cache or state and returns (h, aux, new cache, state
or k/v), so the backbone treats train, prefill and decode alike. The
feed-forward of an attention layer is dense, or routed (`nn.moe`) when
the config has `moe`. Cross-attention and LayerNorm (whisper) wait for
the encoder-decoder and vision families (ROADMAP A13).
"""
from __future__ import annotations

import torch

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init


def _norm_init(cfg: ArchConfig, d: int, *, device=None):
    if cfg.use_attn_bias:
        raise NotImplementedError("LayerNorm backbones (whisper) are not "
                                  "ported (ROADMAP A13)")
    return rmsnorm_init(d, device=device)


def _norm_apply(cfg: ArchConfig, params, x):
    if cfg.use_attn_bias:
        raise NotImplementedError("LayerNorm backbones (whisper) are not "
                                  "ported (ROADMAP A13)")
    return rmsnorm_apply(params, x, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Self-attention + feed-forward layer (dense or MoE)
# ---------------------------------------------------------------------------

def attn_layer_init(generator: torch.Generator, cfg: ArchConfig):
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
