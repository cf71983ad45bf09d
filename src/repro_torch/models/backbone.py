"""The grouped backbone (port of `repro.models.backbone`) for the
`dense` and `ssm` families on the training path.

A backbone is a repeated group of sublayers (`cfg.group_pattern`),
`cfg.n_groups_stack` times, with every parameter stacked on a leading
group axis exactly as the JAX package stacks it (`groups/sub0/mixer/
in_proj` is (n_groups, d_model, d_in_proj)). The stacked leaves are what
the uplink quantizer scales (one scale per leaf) and what Algorithm 2
averages, so keeping the JAX tree keeps the uploads identical; the loop
indexes group i of each stacked leaf.

Dense groups are ("attn",), or a local:global pattern of sliding-window
and full attention; RoPE takes query and key i at position i. Other
families (moe, hybrid, encdec, vlm), and the prefill and decode modes,
raise NotImplementedError (ROADMAP A13, A14).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.tree import tree_index, tree_stack


_FAMILIES = ("dense", "ssm")
_ATTN = ("attn", "attn_local", "attn_global")


def _check_family(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the port "
            f"runs the {_FAMILIES} families (ROADMAP A13)")


def _sublayer_init(generator: torch.Generator, cfg: ArchConfig, kind: str):
    if kind in _ATTN:
        return blocks.attn_layer_init(generator, cfg)
    return blocks.ssm_layer_init(generator, cfg)


def _run_sublayer(params_i, cfg: ArchConfig, kind: str, h, inv_freq):
    if kind in _ATTN:
        return blocks.attn_layer_apply(params_i, cfg, h,
                                       window=cfg.sublayer_window(kind),
                                       inv_freq=inv_freq)
    return blocks.ssm_layer_apply(params_i, cfg, h)


def backbone_init(generator: torch.Generator, cfg: ArchConfig):
    _check_family(cfg)
    pattern = cfg.group_pattern

    def one_group():
        return {f"sub{i}": _sublayer_init(generator, cfg, kind)
                for i, kind in enumerate(pattern)}

    groups = tree_stack([one_group() for _ in range(cfg.n_groups_stack)])
    return {"groups": groups,
            "final_norm": blocks._norm_init(cfg, cfg.d_model,
                                            device=generator.device)}


def backbone_apply(params, cfg: ArchConfig, h, *, mode: str = "train",
                   remat: bool = True, **unsupported):
    """Run the backbone on the training path. h: (b, s, d) hidden states
    (already embedded / projected). remat=True recomputes each group in
    the backward pass (`torch.utils.checkpoint`, same math).
    Returns dict(h=..., aux=..., caches=None)."""
    _check_family(cfg)
    if mode != "train" or any(v is not None for v in unsupported.values()):
        raise NotImplementedError(
            f"backbone_apply(mode={mode!r}, {sorted(unsupported)}) is not "
            f"ported; the port runs mode='train' (ROADMAP A14)")
    pattern = cfg.group_pattern
    inv_freq = (nn.rope_frequencies(cfg.resolved_head_dim,
                                    base=cfg.rope_base, device=h.device)
                if any(kind in _ATTN for kind in pattern) else None)

    def group_body(h, params_g):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, kind in enumerate(pattern):
            h, aux_i = _run_sublayer(params_g[f"sub{i}"], cfg, kind, h,
                                     inv_freq)
            aux = aux + aux_i
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(cfg.n_groups_stack):
        params_g = tree_index(params["groups"], g)
        if remat and torch.is_grad_enabled():
            h, aux_g = checkpoint(group_body, h, params_g,
                                  use_reentrant=False)
        else:
            h, aux_g = group_body(h, params_g)
        aux = aux + aux_g
    h = blocks._norm_apply(cfg, params["final_norm"], h)
    return {"h": h, "aux": aux, "caches": None}
