"""Parameter initializers: functions of a `torch.Generator` and a shape.

The tensor lands on the generator's device. The values differ from the
JAX package's (threefry keys), so parity tests carry weights across
with `repro_torch.interop` instead of re-initializing.
"""
from __future__ import annotations

import math

import torch


def dcgan_conv(generator: torch.Generator, shape, dtype=torch.float32):
    """DCGAN paper init: N(0, 0.02) for all conv weights [Radford et al.]."""
    return 0.02 * torch.randn(shape, generator=generator, dtype=dtype,
                              device=generator.device)


def normal(generator: torch.Generator, shape, stddev: float = 0.02):
    return stddev * torch.randn(shape, generator=generator,
                                device=generator.device)


def lecun_normal(generator: torch.Generator, shape, fan_in: int | None = None):
    """Variance-scaling init with fan-in taken from the first axis by
    default, as in the JAX package."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) > 1 else 1
    stddev = 1.0 / math.sqrt(max(fan_in, 1))
    return stddev * torch.randn(shape, generator=generator,
                                device=generator.device)
