"""Sublayer blocks composed by the grouped backbone (port of
`repro.models.blocks` for the `dense` and `ssm` families).

Each block is (init, apply) over a full residual sublayer; `apply`
takes an optional cache or state and returns (h, aux, new cache, state
or k/v), so the backbone treats train, prefill and decode alike. The MoE
feed-forward, cross-attention and LayerNorm (whisper) variants wait for
their families (ROADMAP A13).
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
# Self-attention + dense feed-forward layer
# ---------------------------------------------------------------------------

def _refuse_moe(cfg: ArchConfig):
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the MoE feed-forward is not "
                                  f"ported (ROADMAP A13)")


def attn_layer_init(generator: torch.Generator, cfg: ArchConfig):
    _refuse_moe(cfg)
    device = generator.device
    return {
        "ln_attn": _norm_init(cfg, cfg.d_model, device=device),
        "attn": nn.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, qk_norm=cfg.qk_norm,
            use_bias=cfg.use_attn_bias, fuse_qkv=cfg.fuse_proj),
        "ln_ff": _norm_init(cfg, cfg.d_model, device=device),
        "ff": nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                          gated=not cfg.use_attn_bias,
                          use_bias=cfg.use_attn_bias,
                          fuse_gate=cfg.fuse_proj),
    }


def attn_layer_apply(params, cfg: ArchConfig, h, *, window, inv_freq,
                     positions=None, causal: bool = True, cache=None,
                     cache_index=None, cache_write_mask=None,
                     paged_table=None, return_kv: bool = False,
                     tp_axis=None):
    """Returns (h, aux, new cache or k/v or None): the self-attention
    sublayer, then the dense feed-forward, each residual. The cache
    arguments select attention's serving paths (`nn.attention_apply`).
    tp_axis runs the feed-forward Megatron-style on a model group's rank
    (attention replicates over the model axis)."""
    _refuse_moe(cfg)
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
    h = h + nn.mlp_apply(params["ff"], x, tp_axis=tp_axis)
    return h, torch.zeros((), dtype=torch.float32, device=h.device), new_cache


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
