"""Named perf variants: the port's counterpart of
`repro.launch.variants`.

A variant transforms (ArchConfig, step kwargs) before the dry run builds
the step, so each hypothesis -> change -> measure iteration is one
`dryrun --variant <name> --tag <name>` invocation whose JSON lands next
to the baseline for comparison. Names join with "+".

Every variant of the JAX package has its counterpart here but three:
`discrep`, `moepin` and `headpin` pin GSPMD sharding constraints
(`act_disc_spec`, `CONSTRAIN_DISPATCH`, `FLASH_HEAD_AXIS`) on a global
program's activations, and the port has no global program to constrain
(ROADMAP item 10c): they raise a ValueError.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.configs.base import ArchConfig

# The JAX package's variants that set GSPMD sharding constraints.
GSPMD_VARIANTS = ("discrep", "moepin", "headpin")


def apply(cfg: ArchConfig, variant: str):
    """Returns (cfg, step_kwargs) for a named variant ('' = baseline)."""
    kw: dict = {}
    if not variant:
        return cfg, kw
    for part in variant.split("+"):
        cfg, kw = _apply_one(cfg, kw, part)
    return cfg, kw


def _overrides(kw: dict, **fields) -> dict:
    ov = dict(kw.get("pcfg_overrides") or {})
    ov.update(fields)
    return {**kw, "pcfg_overrides": ov}


def _apply_one(cfg: ArchConfig, kw: dict, name: str):
    if name in GSPMD_VARIANTS:
        raise ValueError(
            f"variant {name!r} sets a GSPMD sharding constraint on a global "
            f"program; the port runs no global program (its process groups "
            f"hold their own tensors), so it has none (ROADMAP item 10c)")
    if name == "flashrep":
        # head-sharding-friendly flash layout (repeat kv to full heads)
        return dataclasses.replace(cfg, flash_repeat_kv=True), kw
    if name == "hoist":
        # the shared-seed fake batch once per local step for all K
        # devices, which is what JAX's `devices_round_hoisted` buys; the
        # port's Algorithm 1 always draws it so (`core.protocol.
        # devices_update`), so the flag changes no arithmetic here
        return cfg, _overrides(kw, hoist_fakes=True)
    if name == "fused":
        # fused qkv + fused in|gate projections (fewer TP backward ARs)
        return dataclasses.replace(cfg, fuse_proj=True), kw
    if name == "parallel":
        # paper's parallel schedule: the generator update is dataflow-
        # independent of Algorithm 2's reduction -> overlappable
        return cfg, {**kw, "schedule": "parallel"}
    if name == "moe_sort":
        # memory-lean sort dispatch instead of GShard one-hot einsum
        assert cfg.moe is not None
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="sort")), kw
    if m := re.fullmatch(r"micro(\d+)", name):
        return cfg, _overrides(kw, micro_batch_d=int(m.group(1)))
    if m := re.fullmatch(r"nd(\d+)", name):
        return cfg, _overrides(kw, n_d=int(m.group(1)))
    if m := re.fullmatch(r"group(\d+)", name):
        # MoE dispatch group size
        assert cfg.moe is not None
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         group_size=int(m.group(1)))), kw
    if m := re.fullmatch(r"cap(\d+)", name):
        # MoE capacity factor (percent)
        assert cfg.moe is not None
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=int(m.group(1)) / 100.0)), kw
    if m := re.fullmatch(r"disc(\d+)", name):
        # discriminator depth (layers)
        return dataclasses.replace(cfg, disc_layers=int(m.group(1))), kw
    raise ValueError(f"unknown variant {name!r}")
