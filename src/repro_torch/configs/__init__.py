"""Configurations: ``get_arch_config(name)`` / ``list_archs()`` for the
architectures the port runs, and the protocol and DCGAN configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, MoEConfig, ProtocolConfig,
                                      SSMConfig)
from repro_torch.configs.dcgan import DCGANConfig

# Canonical (dashed) ids of the ported architectures, mapped to modules:
# every dense, ssm, moe and hybrid config of the JAX package, in its
# order. It registers two more, whisper-base (encoder-decoder) and
# llama-3.2-vision-90b (vision); they wait for ROADMAP A13.
CANONICAL = {"mamba2-130m": "mamba2_130m",
             "mixtral-8x22b": "mixtral_8x22b",
             "granite-3-2b": "granite_3_2b",
             "qwen3-1.7b": "qwen3_1_7b",
             "granite-moe-3b-a800m": "granite_moe_3b_a800m",
             "zamba2-2.7b": "zamba2_2_7b",
             "gemma3-12b": "gemma3_12b",
             "minitron-4b": "minitron_4b"}


def get_arch_config(name: str):
    """The ArchConfig of a ported architecture (or the DCGANConfig for
    "dcgan"); any other name raises."""
    if name == "dcgan":
        return DCGANConfig()
    mod_name = CANONICAL.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in CANONICAL.values():
        raise KeyError(f"architecture {name!r} is not ported (ROADMAP A13: "
                       f"the encoder-decoder and vision families); the "
                       f"port has {sorted(CANONICAL)} and 'dcgan'")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").config()


def list_archs():
    return list(CANONICAL.keys())


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ProtocolConfig",
           "DCGANConfig", "get_arch_config", "list_archs"]
