"""The backbone-GAN (port of `repro.models.gan`):

  Generator      noise z (b, s, d_z) --z_proj--> backbone --out_proj-->
                 synthetic embedding sequence (b, s, d_model). The same
                 parameters carry an embedding table and an lm_head, so
                 the generator also serves as a causal LM
                 (`generator_lm_apply`: train, prefill and decode).

  Discriminator  embedding sequence --in_proj--> backbone --mean-pool-->
                 scalar real/fake logit. Real token data enters through
                 the discriminator's own embedding table.

The MoE load-balance loss comes back as `aux` from both nets; the GAN
spec drops it, as in the JAX package. The conditioned families take the
stub frontend's features `enc_feats` (b, t, d_model) in both nets:
whisper (encdec) runs them through the net's own encoder (`encoder`,
built under the net's config), llama-3.2-vision (vlm) cross-attends to
them as they are (the projector is part of the stub).

Also the minimal MLP-GAN (`mlp_gan_init`, `mlp_gan_spec`): the
dispatch-bound model of the JAX package's `benchmarks/driver_bench.py`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.core.protocol import GanModelSpec
from repro_torch.models.backbone import (backbone_apply, backbone_init,
                                         encoder_apply, encoder_init)
from repro_torch.nn import initializers
from repro_torch.nn.linear import linear_apply


def disc_config(cfg: ArchConfig) -> ArchConfig:
    if cfg.disc_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=cfg.disc_layers, disc_layers=None)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def generator_init(generator: torch.Generator, cfg: ArchConfig):
    params = {
        "z_proj": initializers.lecun_normal(generator, (cfg.d_z, cfg.d_model)),
        "backbone": backbone_init(generator, cfg),
        "out_proj": initializers.lecun_normal(generator,
                                              (cfg.d_model, cfg.d_model)),
        "embed": nn.embedding_init(generator, cfg.vocab, cfg.d_model),
        "lm_head": initializers.lecun_normal(generator,
                                             (cfg.d_model, cfg.vocab)),
    }
    if cfg.family == "encdec":
        params["encoder"] = encoder_init(generator, cfg)
    return params


def _encode(params, cfg: ArchConfig, enc_feats, *, remat: bool):
    """The cross sublayers' states from the stub frontend's features:
    the net's encoder over them (encdec), the features themselves (vlm),
    None for the other families."""
    if cfg.family == "encdec":
        if enc_feats is None:
            raise ValueError(f"{cfg.name} needs encoder features")
        return encoder_apply(params["encoder"], cfg, enc_feats, remat=remat)
    if cfg.family == "vlm":
        if enc_feats is None:
            raise ValueError(f"{cfg.name} needs image embeddings")
        return enc_feats
    return None


def generator_apply(params, cfg: ArchConfig, z, *, enc_feats=None,
                    remat: bool = True, tp_axis=None):
    """GAN mode: noise sequence -> (synthetic embedding sequence
    (b, s, d), aux). enc_feats: the conditioned families' frontend
    features (b, t, d). tp_axis runs the backbone's feed-forward blocks
    Megatron-style over the model group (`params` hold its shards; the
    projections here replicate)."""
    h = z @ params["z_proj"].to(z.dtype)
    enc_h = _encode(params, cfg, enc_feats, remat=remat)
    out = backbone_apply(params["backbone"], cfg, h, mode="train",
                         enc_h=enc_h, remat=remat, tp_axis=tp_axis)
    fake = out["h"] @ params["out_proj"].to(h.dtype)
    return fake, out["aux"]


def generator_lm_init(generator: torch.Generator, cfg: ArchConfig):
    return generator_init(generator, cfg)


def generator_lm_apply(params, cfg: ArchConfig, tokens, *,
                       mode: str = "train", caches=None, cache_index=None,
                       positions=None, cache_write_mask=None,
                       paged_table=None, enc_feats=None, remat: bool = True,
                       prefill_cache_len=None, tp_axis=None):
    """LM mode: tokens (b, s) -> {"logits" (b, s, vocab), "aux",
    "caches"}. Serving's prefill and decode conventions (any-position
    decode, chunked prefill, paged caches) are `backbone_apply`'s;
    enc_feats: the conditioned families' frontend features, read in
    train and prefill (decode attends through the prefilled cross
    caches, so the encoder does not run); tp_axis: the Megatron
    feed-forward over the model group (the sharded-leaf contract of
    training)."""
    h = nn.embedding_apply(params["embed"], tokens)
    enc_h = None if mode == "decode" else _encode(params, cfg, enc_feats,
                                                  remat=remat)
    out = backbone_apply(params["backbone"], cfg, h, mode=mode,
                         caches=caches, cache_index=cache_index,
                         positions=positions, enc_h=enc_h, remat=remat,
                         prefill_cache_len=prefill_cache_len,
                         cache_write_mask=cache_write_mask,
                         paged_table=paged_table, tp_axis=tp_axis)
    logits = out["h"] @ params["lm_head"].to(out["h"].dtype)
    return {"logits": logits, "aux": out["aux"], "caches": out["caches"]}


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def discriminator_init(generator: torch.Generator, cfg: ArchConfig):
    dcfg = disc_config(cfg)
    params = {
        "in_proj": initializers.lecun_normal(generator,
                                             (cfg.d_model, cfg.d_model)),
        "backbone": backbone_init(generator, dcfg),
        "embed": nn.embedding_init(generator, cfg.vocab, cfg.d_model),
        "score": initializers.lecun_normal(generator, (cfg.d_model, 1)),
    }
    if cfg.family == "encdec":
        params["encoder"] = encoder_init(generator, dcfg)
    return params


def discriminator_embed(params, tokens):
    """Embed real token data into the discriminator's input space."""
    return nn.embedding_apply(params["embed"], tokens)


def discriminator_apply(params, cfg: ArchConfig, x_embed, *,
                        enc_feats=None, remat: bool = True, tp_axis=None):
    """x_embed: (b, s, d) — real (embedded tokens) or fake (generator
    out). Returns (per-example logits (b,), aux). enc_feats go through
    the discriminator's own encoder, under its config; tp_axis as in
    generator_apply."""
    dcfg = disc_config(cfg)
    h = x_embed @ params["in_proj"].to(x_embed.dtype)
    enc_h = _encode(params, dcfg, enc_feats, remat=remat)
    out = backbone_apply(params["backbone"], dcfg, h, mode="train",
                         enc_h=enc_h, remat=remat, tp_axis=tp_axis)
    pooled = torch.mean(out["h"].float(), dim=1)
    logit = pooled @ params["score"].float()
    return logit[..., 0], out["aux"]


def gan_init(generator: torch.Generator, cfg: ArchConfig):
    return {"gen": generator_init(generator, cfg),
            "disc": discriminator_init(generator, cfg)}


# ---------------------------------------------------------------------------
# Minimal MLP-GAN — the dispatch-bound driver benchmark's model
# ---------------------------------------------------------------------------

def mlp_gan_init(generator: torch.Generator, *, d_z: int = 8,
                 d_hidden: int = 16, d_data: int = 64,
                 w_scale: float = 0.1):
    """Two-layer MLP G and D over flattened vectors (port of
    `repro.models.gan.mlp_gan_init`, the same tree and shapes; the
    normals come from `generator`, so a parity test carries the JAX
    package's parameters across with `repro_torch.interop`)."""
    def s(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * w_scale
    return {"gen": {"w_in": s(d_z, d_hidden), "w_out": s(d_hidden, d_data)},
            "disc": {"w_in": s(d_data, d_hidden), "w_out": s(d_hidden, 1)}}


def mlp_gan_spec(*, d_z: int = 8, tp_axis=None):
    """The `GanModelSpec` of the MLP-GAN (port of
    `repro.models.gan.mlp_gan_spec`).

    tp_axis=None is the plain dense math (any layout, any driver). With
    tp_axis set ("model") the spec runs on the ranks of a model group
    and takes their shards: w_in is column-parallel (copy_to_tp pins
    the backward dx all-reduce), w_out row-parallel (one forward
    all-reduce), for both networks."""
    def gen_apply(p, z):
        h = torch.tanh(linear_apply({"w": p["w_in"]}, z, tp_axis=tp_axis,
                                    tp_mode="column"))
        return torch.tanh(linear_apply({"w": p["w_out"]}, h,
                                       tp_axis=tp_axis, tp_mode="row"))

    def disc_logits(p, x):
        x = x.reshape(x.shape[0], -1)
        h = torch.tanh(linear_apply({"w": p["w_in"]}, x, tp_axis=tp_axis,
                                    tp_mode="column"))
        return linear_apply({"w": p["w_out"]}, h, tp_axis=tp_axis,
                            tp_mode="row")[:, 0]

    return GanModelSpec(
        sample_z=lambda generator, n, device=None: torch.randn(
            (n, d_z), generator=generator, device=device or generator.device),
        gen_apply=gen_apply, disc_real=disc_logits, disc_fake=disc_logits,
        tp_axis=tp_axis)
