"""Synthetic stand-ins for the paper's datasets.

A numpy copy of `repro.data.synthetic`: the same seed gives bit-identical
arrays. CelebA / CIFAR-10 / RSNA Pneumonia are modeled by a Gaussian
mixture over low-frequency image patterns with the datasets' geometry,
token data by a mixture of Markov chains, so nothing has to be
downloaded.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDatasetSpec:
    name: str
    image_size: int
    channels: int
    n_modes: int


DATASET_SPECS = {
    # paper's three datasets, geometry-matched
    "celeba": ImageDatasetSpec("celeba", 64, 3, 8),
    "cifar10": ImageDatasetSpec("cifar10", 32, 3, 10),
    "rsna": ImageDatasetSpec("rsna", 64, 1, 4),
    # tiny variants for CPU tests
    "celeba32": ImageDatasetSpec("celeba32", 32, 3, 8),
    "rsna32": ImageDatasetSpec("rsna32", 32, 1, 4),
    "toy": ImageDatasetSpec("toy", 32, 1, 4),
}


def _mode_pattern(rng: np.random.Generator, size: int, channels: int):
    """A smooth random pattern: sum of a few low-frequency 2-D cosines."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    img = np.zeros((size, size, channels), dtype=np.float64)
    for _ in range(4):
        fy, fx = rng.uniform(0.5, 3.0, 2)
        phase_y, phase_x = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.3, 1.0, channels)
        wave = np.cos(2 * np.pi * fy * yy / size + phase_y) * \
            np.cos(2 * np.pi * fx * xx / size + phase_x)
        img += wave[..., None] * amp
    return img


def make_image_dataset(name: str, n: int, *, seed: int = 0,
                       noise: float = 0.15):
    """Returns (images (n, H, W, C) float32 in [-1, 1], mode_labels (n,))."""
    spec = DATASET_SPECS[name]
    rng = np.random.default_rng(seed)
    modes = np.stack([_mode_pattern(rng, spec.image_size, spec.channels)
                      for _ in range(spec.n_modes)])
    labels = rng.integers(0, spec.n_modes, n)
    imgs = modes[labels] + noise * rng.standard_normal(
        (n, spec.image_size, spec.image_size, spec.channels))
    imgs = np.tanh(imgs).astype(np.float32)   # squash into (-1, 1)
    return imgs, labels.astype(np.int32)


def make_token_dataset(n: int, seq_len: int, vocab: int, *, seed: int = 0,
                       n_modes: int = 8, order: int = 2):
    """Synthetic token sequences from a mixture of Markov chains — the
    text-world analogue of the image mixture (for backbone-GAN training).
    Returns (tokens (n, seq_len) int32, mode_labels (n,)).

    The transition tables are one (n_modes, vocab, vocab // 16) int64
    draw: 10.1 GB of host memory at vocab 50280."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_modes, n)
    # per-mode sparse transition structure
    out = np.empty((n, seq_len), dtype=np.int32)
    branch = max(2, vocab // 16)
    tables = rng.integers(0, vocab, (n_modes, vocab, branch))
    for i in range(n):
        t = tables[labels[i]]
        seq = np.empty(seq_len, dtype=np.int64)
        seq[0] = rng.integers(0, vocab)
        choices = rng.integers(0, branch, seq_len)
        for j in range(1, seq_len):
            seq[j] = t[seq[j - 1], choices[j]]
        out[i] = seq
    return out, labels.astype(np.int32)
