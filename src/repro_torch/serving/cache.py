"""Paged (blocked) decode caches of the serving engine (port of
`repro.serving.cache`).

Dense serving caches reserve `batch x max_len` keys and values for every
full-attention sublayer. The paged backend replaces each of those caches
with a shared BLOCK POOL and per-slot block tables:

    pool  {"k"/"v": (G, n_blocks, block_size, kv_heads, head_dim),
           "pos"/"valid": (G, n_blocks, block_size)}
    table (batch, max_blocks) rows of pool block ids

so persistent memory follows the live tokens (allocated blocks), not the
worst case. Block 0 is the null block: never allocated and never
written, its `valid` bits stay False, and padding table entries point at
it. Only full-attention sublayers page: a sliding-window cache is a
bounded per-slot ring, and the Mamba-2 state is O(1) a slot.

Allocation is on the host (`BlockAllocator`'s free list, in the JAX
package's order, so block ids match); the step sees only the pools and
tables.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.backbone import init_decode_caches
from repro_torch.tree import tree_leaves

_ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")


def paged_sub_names(cfg: ArchConfig) -> tuple:
    """The 'subI' entries of the group pattern that page: the
    full-attention sublayers (the hybrid's shared block's calls too,
    each with its own pool)."""
    return tuple(
        f"sub{i}" for i, kind in enumerate(cfg.group_pattern)
        if kind in _ATTN_KINDS and cfg.sublayer_window(kind) is None)


def slot_max_blocks(max_len: int, block_size: int) -> int:
    return -(-max_len // block_size)


def init_paged_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                      block_size: int, n_blocks: Optional[int] = None,
                      dtype=torch.float32, device=None):
    """Serving caches with the full-attention sublayers' caches replaced
    by block pools (the leading group axis kept). n_blocks defaults to
    the dense worst case (batch x max_blocks + the null block); fewer
    caps the pool, and admission then waits for blocks. Returns (caches,
    meta)."""
    mb = slot_max_blocks(max_len, block_size)
    if n_blocks is None:
        n_blocks = batch * mb + 1
    paged = paged_sub_names(cfg)
    caches = init_decode_caches(cfg, batch, max_len, dtype=dtype,
                                device=device)
    g = cfg.n_groups_stack
    shape = (g, n_blocks, block_size)
    kv = shape + (cfg.n_kv_heads, cfg.resolved_head_dim)
    for name in paged:
        caches[name] = {
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "pos": torch.zeros(shape, dtype=torch.int32, device=device),
            "valid": torch.zeros(shape, dtype=torch.bool, device=device)}
    meta = {"block_size": block_size, "n_blocks": n_blocks,
            "max_blocks": mb, "paged_subs": paged}
    return caches, meta


def invalidate_blocks(caches, paged_subs, block_ids):
    """Mark pool blocks `block_ids` (a tensor, padded with 0: the null
    block is invalid already) invalid in every paged sublayer, in place,
    so that a reused block never shows a former owner's entries."""
    for name in paged_subs:
        caches[name]["valid"][:, block_ids] = False
    return caches


def cache_bytes(caches) -> int:
    """Persistent cache footprint in bytes (pools and dense leaves)."""
    return int(sum(x.numel() * x.element_size()
                   for x in tree_leaves(caches)))


class BlockAllocator:
    """Host-side free list over pool blocks 1..n_blocks-1 (0 is null)."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """Pop n block ids, or None when the pool cannot give them."""
        if n == 0:
            return []
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1]
        del self._free[-n:]
        return got

    def free(self, block_ids):
        for b in block_ids:
            if not 0 < b < self.n_blocks:
                raise ValueError(f"block {b} is not in 1..{self.n_blocks - 1}")
            self._free.append(b)
