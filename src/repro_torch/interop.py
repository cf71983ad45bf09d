"""Carries parameter trees between the JAX package and the port.

The JAX package's parameters, optimizer states and checkpoints are
nested dicts/lists of arrays; the port keeps the same trees, layouts
(HWIO convolution weights) and dtypes, so conversion is a copy of each
leaf. The leaf order is the JAX tree-flatten order (`repro_torch.tree`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def to_torch(tree, device):
    """Nested dict/list of numpy arrays (or anything `np.asarray` takes,
    such as JAX arrays) -> the same tree of tensors on `device`."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def to_numpy(tree):
    """The inverse of `to_torch`: tensors -> numpy arrays, exactly."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
