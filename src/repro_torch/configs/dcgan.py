"""The paper's own experimental model: DCGAN [arXiv:1511.06434].

Paper Section IV: generator 3,576,704 parameters, discriminator
2,765,568 parameters — the standard 64x64 DCGAN with nz=100,
ngf=ndf=64, nc=3 (conv weights only, batch-norm affine params included).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DCGANConfig:
    nz: int = 100            # latent dim
    ngf: int = 64            # generator feature maps
    ndf: int = 64            # discriminator feature maps
    nc: int = 3              # image channels
    image_size: int = 64
    source: str = "arXiv:1511.06434 (DCGAN); paper Section IV"


def config() -> DCGANConfig:
    return DCGANConfig()


def small_config() -> DCGANConfig:
    """CPU-scale variant for tests/examples (32x32, thin feature maps)."""
    return DCGANConfig(nz=32, ngf=16, ndf=16, nc=1, image_size=32)
