"""Device-shard partitioning.

The paper randomly partitions each dataset into equal shards (Section
IV). A Dirichlet(alpha) label-skew partitioner is provided for non-iid
ablations (the regime where discriminator-only averaging is most
stressed).
"""
from __future__ import annotations

import numpy as np


def partition_iid(data: np.ndarray, n_devices: int, *, seed: int = 0):
    """Random equal split -> (K, n_k, ...). Drops the remainder."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    per = n // n_devices
    idx = rng.permutation(n)[: per * n_devices]
    return data[idx].reshape((n_devices, per) + data.shape[1:])


def partition_dirichlet(data: np.ndarray, labels: np.ndarray,
                        n_devices: int, *, alpha: float = 0.5,
                        seed: int = 0):
    """Label-skew split: each class is spread over devices by a
    Dirichlet(alpha) draw; shards are then trimmed to equal size."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    buckets: list[list[int]] = [[] for _ in range(n_devices)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        probs = rng.dirichlet(alpha * np.ones(n_devices))
        splits = (np.cumsum(probs)[:-1] * len(idx)).astype(int)
        for dev, part in enumerate(np.split(idx, splits)):
            buckets[dev].extend(part.tolist())
    per = min(len(b) for b in buckets)
    assert per > 0, "a device received no data; raise alpha or n"
    out = np.stack([data[rng.permutation(np.asarray(b))[:per]]
                    for b in buckets])
    return out


def partition(data: np.ndarray, n_devices: int, *, labels=None,
              kind: str = "iid", alpha: float = 0.5, seed: int = 0):
    if kind == "iid":
        return partition_iid(data, n_devices, seed=seed)
    if kind == "dirichlet":
        assert labels is not None
        return partition_dirichlet(data, labels, n_devices, alpha=alpha,
                                   seed=seed)
    raise ValueError(kind)
