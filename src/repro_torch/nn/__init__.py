from repro_torch.nn.conv import (conv2d_apply, conv2d_init,
                                 conv_transpose2d_apply,
                                 conv_transpose2d_init)
from repro_torch.nn.norms import batchnorm_apply, batchnorm_init

__all__ = ["conv2d_apply", "conv2d_init", "conv_transpose2d_apply",
           "conv_transpose2d_init", "batchnorm_apply", "batchnorm_init"]
