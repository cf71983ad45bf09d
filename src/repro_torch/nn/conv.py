"""2-D convolutions for the paper's DCGAN (NHWC activations, HWIO weights).

The layouts are the JAX package's, so parameters carry across unchanged.
Inside, each call views the NHWC tensor as NCHW (a channels-last view,
no copy) and runs PyTorch's convolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers


def conv2d_init(generator: torch.Generator, c_in: int, c_out: int,
                kernel: int):
    return {"w": initializers.dcgan_conv(generator,
                                         (kernel, kernel, c_in, c_out))}


def conv2d_apply(params, x, *, stride: int = 2, padding: int = 1):
    """x: (b, H, W, c_in) -> (b, H', W', c_out)."""
    w = params["w"].permute(3, 2, 0, 1)                     # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d_init(generator: torch.Generator, c_in: int,
                          c_out: int, kernel: int):
    return {"w": initializers.dcgan_conv(generator,
                                         (kernel, kernel, c_in, c_out))}


def conv_transpose2d_apply(params, x, *, stride: int = 2, padding: int = 1):
    """Fractionally-strided conv: out = (in - 1) * stride - 2 * padding +
    kernel, with the JAX package's weight semantics.

    `repro.nn.conv` calls `lax.conv_transpose` with the default
    `transpose_kernel=False`, which convolves the dilated input with the
    HWIO kernel as it is. PyTorch's transposed convolution correlates
    with the kernel turned around, so the (I, O, H, W) weight it takes is
    the HWIO weight permuted AND flipped in both spatial axes.
    """
    w = params["w"].permute(2, 3, 0, 1).flip(2, 3)          # HWIO -> IOHW
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride,
                           padding=padding)
    return y.permute(0, 2, 3, 1)
