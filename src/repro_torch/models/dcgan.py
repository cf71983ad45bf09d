"""DCGAN — the paper's experimental model [arXiv:1511.06434].

Port of `repro.models.dcgan`: the same parameter trees (HWIO convolution
weights, batch-norm scale and bias) and the same NHWC activations. With
the default config (nz=100, ngf=ndf=64, nc=3, 64x64) the generator has
3,576,704 parameters and the discriminator 2,765,568 (paper Section IV).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.dcgan import DCGANConfig


def _n_stages(image_size: int) -> int:
    n = int(math.log2(image_size)) - 2      # 64 -> 4, 32 -> 3
    if n < 1 or 2 ** (n + 2) != image_size:
        raise ValueError(f"image_size must be a power of two >= 8 "
                         f"(got {image_size})")
    return n


def generator_init(generator: torch.Generator, cfg: DCGANConfig):
    n = _n_stages(cfg.image_size)
    chain = [cfg.ngf * 2 ** k for k in range(n - 1, -1, -1)]  # e.g. [512,256,128,64]
    dev = generator.device
    # initial: z (1x1) -> 4x4 x chain[0]
    layers = [{"conv": nn.conv_transpose2d_init(generator, cfg.nz, chain[0], 4),
               "bn": nn.batchnorm_init(chain[0], device=dev)}]
    for i in range(n - 1):
        layers.append({"conv": nn.conv_transpose2d_init(generator, chain[i],
                                                        chain[i + 1], 4),
                       "bn": nn.batchnorm_init(chain[i + 1], device=dev)})
    layers.append({"conv": nn.conv_transpose2d_init(generator, chain[-1],
                                                    cfg.nc, 4)})
    return {"layers": layers}


def generator_apply(params, cfg: DCGANConfig, z):
    """z: (b, nz) -> images (b, H, W, nc) in [-1, 1]."""
    x = z.reshape(z.shape[0], 1, 1, cfg.nz)
    layers = params["layers"]
    x = nn.conv_transpose2d_apply(layers[0]["conv"], x, stride=1, padding=0)
    x = F.relu(nn.batchnorm_apply(layers[0]["bn"], x))
    for layer in layers[1:-1]:
        x = nn.conv_transpose2d_apply(layer["conv"], x, stride=2, padding=1)
        x = F.relu(nn.batchnorm_apply(layer["bn"], x))
    x = nn.conv_transpose2d_apply(layers[-1]["conv"], x, stride=2, padding=1)
    return torch.tanh(x)


def discriminator_init(generator: torch.Generator, cfg: DCGANConfig):
    n = _n_stages(cfg.image_size)
    chain = [cfg.ndf * 2 ** k for k in range(n)]              # e.g. [64,128,256,512]
    layers = [{"conv": nn.conv2d_init(generator, cfg.nc, chain[0], 4)}]  # no BN on 1st
    for i in range(n - 1):
        layers.append({"conv": nn.conv2d_init(generator, chain[i],
                                              chain[i + 1], 4),
                       "bn": nn.batchnorm_init(chain[i + 1],
                                               device=generator.device)})
    layers.append({"conv": nn.conv2d_init(generator, chain[-1], 1, 4)})
    return {"layers": layers}


def discriminator_apply(params, cfg: DCGANConfig, images):
    """images: (b, H, W, nc) -> logits (b,)."""
    layers = params["layers"]
    x = F.leaky_relu(nn.conv2d_apply(layers[0]["conv"], images), 0.2)
    for layer in layers[1:-1]:
        x = nn.conv2d_apply(layer["conv"], x)
        x = F.leaky_relu(nn.batchnorm_apply(layer["bn"], x), 0.2)
    x = nn.conv2d_apply(layers[-1]["conv"], x, stride=1, padding=0)
    return x.reshape(x.shape[0])


def gan_init(generator: torch.Generator, cfg: DCGANConfig):
    return {"gen": generator_init(generator, cfg),
            "disc": discriminator_init(generator, cfg)}
