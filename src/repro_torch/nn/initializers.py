"""Parameter initializers: functions of a `torch.Generator` and a shape.

The tensor lands on the generator's device. The values differ from the
JAX package's (threefry keys), so parity tests carry weights across
with `repro_torch.interop` instead of re-initializing.
"""
from __future__ import annotations

import torch


def dcgan_conv(generator: torch.Generator, shape, dtype=torch.float32):
    """DCGAN paper init: N(0, 0.02) for all conv weights [Radford et al.]."""
    return 0.02 * torch.randn(shape, generator=generator, dtype=dtype,
                              device=generator.device)
