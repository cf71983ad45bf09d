"""GanModelSpec adapters: plug concrete models into the protocol."""
from __future__ import annotations

import torch

from repro_torch.configs.dcgan import DCGANConfig
from repro_torch.core.protocol import GanModelSpec
from repro_torch.models import dcgan as dcgan_model


def make_dcgan_spec(cfg: DCGANConfig, *,
                    gen_loss_variant: str = "minimax") -> GanModelSpec:
    """The paper's experimental model: image GAN over (b, H, W, C)."""
    return GanModelSpec(
        sample_z=lambda generator, n: torch.randn(
            (n, cfg.nz), generator=generator, device=generator.device),
        gen_apply=lambda gen, z: dcgan_model.generator_apply(gen, cfg, z),
        disc_real=lambda disc, x: dcgan_model.discriminator_apply(disc, cfg, x),
        disc_fake=lambda disc, f: dcgan_model.discriminator_apply(disc, cfg, f),
        gen_loss_variant=gen_loss_variant,
    )
