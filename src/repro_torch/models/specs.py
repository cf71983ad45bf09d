"""GanModelSpec adapters: plug concrete models into the protocol."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.dcgan import DCGANConfig
from repro_torch.core.protocol import GanModelSpec
from repro_torch.device import resolve_device
from repro_torch.models import dcgan as dcgan_model
from repro_torch.models import gan as gan_model


def make_dcgan_spec(cfg: DCGANConfig, *,
                    gen_loss_variant: str = "minimax") -> GanModelSpec:
    """The paper's experimental model: image GAN over (b, H, W, C)."""
    return GanModelSpec(
        sample_z=lambda generator, n, device=None: torch.randn(
            (n, cfg.nz), generator=generator,
            device=device or generator.device),
        gen_apply=lambda gen, z: dcgan_model.generator_apply(gen, cfg, z),
        disc_real=lambda disc, x: dcgan_model.discriminator_apply(disc, cfg, x),
        disc_fake=lambda disc, f: dcgan_model.discriminator_apply(disc, cfg, f),
        gen_loss_variant=gen_loss_variant,
    )


def make_backbone_spec(cfg: ArchConfig, seq_len: int, *, enc_feats_fn=None,
                       remat: bool = True,
                       gen_loss_variant: str = "minimax",
                       dtype=torch.float32, tp_axis=None) -> GanModelSpec:
    """Backbone-GAN over token data.

    Real batches are integer token arrays (m, seq_len); they enter the
    discriminator through its embedding table. Fakes are generator
    embedding sequences (m, seq_len, d). `sample_z(generator, n)` draws
    (n, seq_len, d_z) noise in `dtype`: bfloat16 noise (the launch step's,
    `launch/steps.py`) carries every downstream product in bfloat16, as
    the apply functions follow their input's dtype. Conditioned families
    get their stub
    frontend features from enc_feats_fn(n) (`make_stub_enc_feats`), in
    both nets.

    tp_axis: Megatron tensor parallelism of BOTH nets' feed-forward
    blocks over the model group ("model"): the parameters the apply
    functions receive must then be its shards (`sharding.rules`
    tp_leaf_dim names). fuse_proj configs cannot be tensor-parallel (the
    fused [in|gate] halves do not shard contiguously), nor MoE ones, as
    in the JAX package.
    """
    if tp_axis is not None:
        if cfg.fuse_proj:
            raise ValueError(
                f"{cfg.name}: fuse_proj=True cannot be tensor-parallel "
                f"(fused [in|gate] halves don't shard contiguously); "
                f"use a non-fused config for tp > 1")
        if cfg.moe is not None:
            raise ValueError(
                f"{cfg.name}: MoE feed-forward has no in-slice TP path "
                f"yet (moe_apply runs dense per expert; expert "
                f"parallelism is a ROADMAP item) — use tp=1 for MoE "
                f"configs on the mesh layout")

    def enc(n):
        return enc_feats_fn(n) if enc_feats_fn is not None else None

    def sample_z(generator, n, device=None):
        return torch.randn((n, seq_len, cfg.d_z), generator=generator,
                           device=device or generator.device, dtype=dtype)

    def gen_apply(gen, z):
        return gan_model.generator_apply(gen, cfg, z,
                                         enc_feats=enc(z.shape[0]),
                                         remat=remat, tp_axis=tp_axis)[0]

    def disc_real(disc, tokens):
        x = gan_model.discriminator_embed(disc, tokens)
        return gan_model.discriminator_apply(
            disc, cfg, x, enc_feats=enc(tokens.shape[0]), remat=remat,
            tp_axis=tp_axis)[0]

    def disc_fake(disc, fake):
        return gan_model.discriminator_apply(
            disc, cfg, fake, enc_feats=enc(fake.shape[0]), remat=remat,
            tp_axis=tp_axis)[0]

    return GanModelSpec(sample_z=sample_z, gen_apply=gen_apply,
                        disc_real=disc_real, disc_fake=disc_fake,
                        gen_loss_variant=gen_loss_variant, tp_axis=tp_axis)


def make_stub_enc_feats(cfg: ArchConfig, *, seed: int = 7, device=None):
    """A deterministic stand-in for the stubbed modality frontend (mel +
    conv for whisper, ViT + projector for llama-vision): enc_feats(n)
    gives (n, t, d_model) float32, one (1, t, d_model) standard normal
    draw broadcast over n, where t is cfg.enc_seq (encdec) or
    cfg.n_image_tokens (vlm); None for the other families. The draw
    comes from a `torch.Generator` seeded with `seed` on `device` (CUDA
    unless named), not from the JAX PRNG, so it differs from the JAX
    package's; parity tests pass the JAX draw in."""
    if cfg.family == "encdec":
        t = cfg.enc_seq
    elif cfg.family == "vlm":
        t = cfg.n_image_tokens
    else:
        return None
    device = resolve_device(device)
    base = torch.randn((1, t, cfg.d_model),
                       generator=torch.Generator(device).manual_seed(seed),
                       device=device)

    def enc_feats(n):
        return base.expand(n, t, cfg.d_model)

    return enc_feats
