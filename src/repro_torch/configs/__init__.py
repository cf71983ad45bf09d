"""Configurations: ``get_arch_config(name)`` / ``list_archs()`` for every
architecture of the JAX package, and the protocol and DCGAN configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, MoEConfig,
                                      ProtocolConfig, ShapeConfig, SSMConfig)
from repro_torch.configs.dcgan import DCGANConfig

# Canonical (dashed) ids of the architectures, mapped to modules: every
# config of the JAX package, in its order.
CANONICAL = {"mamba2-130m": "mamba2_130m",
             "mixtral-8x22b": "mixtral_8x22b",
             "whisper-base": "whisper_base",
             "granite-3-2b": "granite_3_2b",
             "qwen3-1.7b": "qwen3_1_7b",
             "granite-moe-3b-a800m": "granite_moe_3b_a800m",
             "zamba2-2.7b": "zamba2_2_7b",
             "gemma3-12b": "gemma3_12b",
             "minitron-4b": "minitron_4b",
             "llama-3.2-vision-90b": "llama_3_2_vision_90b"}


def get_arch_config(name: str):
    """The ArchConfig of an architecture (or the DCGANConfig for
    "dcgan"); any other name raises KeyError."""
    if name == "dcgan":
        return DCGANConfig()
    mod_name = CANONICAL.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in CANONICAL.values():
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(CANONICAL)} and 'dcgan'")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").config()


def list_archs():
    return list(CANONICAL.keys())


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ProtocolConfig",
           "ShapeConfig", "INPUT_SHAPES", "DCGANConfig", "get_arch_config",
           "list_archs"]
