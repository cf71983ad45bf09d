"""Sublayer blocks composed by the grouped backbone (port of
`repro.models.blocks` for the `ssm` family).

Each block is (init, apply) over a full residual sublayer. The
attention, cross-attention and LayerNorm (whisper) variants wait for the
attention families (ROADMAP A13).
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


def ssm_layer_apply(params, cfg: ArchConfig, h):
    """Returns (h, aux): the residual sublayer on the training path."""
    s = cfg.ssm
    x = rmsnorm_apply(params["ln"], h, eps=cfg.norm_eps)
    mixed = nn.ssd_mixer_apply(
        params["mixer"], x, d_state=s.d_state, head_dim=s.head_dim,
        expand=s.expand, n_groups=s.n_groups, chunk=s.chunk)
    return h + mixed, torch.zeros((), dtype=torch.float32, device=h.device)
