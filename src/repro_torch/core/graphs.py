"""One round body replayed as a captured CUDA graph: the port's stand-in
for the JAX package's one XLA dispatch per chunk of fused rounds
(`lax.scan` in `repro.core.protocol.rounds_scan`).

A `RoundGraph` runs `body(state, carry, slots) -> (state, carry, out)`
once a round on tensors at fixed addresses: the training state, the
scheduler carry (both static: the body ends by copying the new ones
into them) and the round's input slots, which the caller fills before
each round. With `capture=True` (the stacked layout on CUDA):

  1. the first round runs the body eagerly, on a side stream, under
     `torch.cuda.set_sync_debug_mode("error")`: the warm-up is a real
     round, builds every kernel library on first use (never inside the
     capture), and proves that the body never synchronises with the
     host; its segments are expandable too (a 16-layer granite-3-2b
     round in bfloat16 left 23 GiB of fixed segments unusable for a
     4 GiB block);
  2. the body is then captured once with `torch.cuda.graph` on the same
     stream (capturing runs nothing), with the caching allocator's
     expandable segments on for the capture alone (`_expandable_segments`)
     and the warm-up's cached blocks released first;
  3. every later round replays the graph: no Python between the kernels.

If the capture or a replay fails, the error propagates: there is no
eager fallback on CUDA. With `capture=False` (the CPU, and the mesh
layout, whose gloo collectives go through the host) the same body runs
eagerly every round.

Each round's `out` (a tree of float32 and bool tensors) is packed into
one float32 row and copied, on the device, into the chunk's (R, F)
buffer; a chunk ends with one synchronise and one copy to the host.
"""
from __future__ import annotations

import contextlib
import gc
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _set_allocator(settings: str):
    """Set options of the caching allocator (PYTORCH_CUDA_ALLOC_CONF's
    syntax) at run time, through whichever call this torch has."""
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(settings)


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator's expandable segments on inside the block.
    A capture allocates in the graph's private pool, which cannot hand a
    free segment back to the device until the capture ends; with fixed
    segments a round of multi-GiB leaves (granite-3-2b's) fragments that
    pool past the card (55 GiB of segments around 24 GiB of live
    tensors), and the eager warm-up's side-stream pool alike. Grown in
    place, the pool stays near the round's live peak. The setting only shapes the segments made inside the block:
    eager rounds and everything else keep fixed segments, unless the
    environment (PYTORCH_CUDA_ALLOC_CONF or PYTORCH_ALLOC_CONF) turns
    expandable segments on for the whole process, which is then left
    as it is."""
    conf = ",".join(os.environ.get(name, "") for name in (
        "PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"))
    if "expandable_segments:true" in conf.replace(" ", "").lower():
        yield
        return
    _set_allocator("expandable_segments:True")
    try:
        yield
    finally:
        _set_allocator("expandable_segments:False")


@contextlib.contextmanager
def _sync_debug_error():
    """Raise on any host synchronisation inside the block (CUDA only)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def copy_into(static, new):
    """Copy the tree `new` into the same-structured tree `static` in
    place. A leaf of `new` that shares storage with a leaf of `static`
    (e.g. a cache that keeps the round-start global) is cloned first, so
    no copy reads a tensor that an earlier copy overwrote."""
    dst, src = tree_leaves(static), tree_leaves(new)
    if len(dst) != len(src):
        raise ValueError(f"the round returned {len(src)} leaves for "
                         f"{len(dst)} static ones")
    held = {x.untyped_storage().data_ptr() for x in dst}
    src = [s.clone() if s.untyped_storage().data_ptr() in held else s
           for s in src]
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"the round changed a leaf from "
                             f"{tuple(d.shape)} {d.dtype} to "
                             f"{tuple(s.shape)} {s.dtype}")
        d.copy_(s)


def _pack(out):
    """The out tree as one float32 row, leaves in tree order."""
    leaves = tree_leaves(out)
    for x in leaves:
        if x.dtype not in (torch.float32, torch.bool):
            raise ValueError(f"a round's outputs are float32 or bool, not "
                             f"{x.dtype}")
    return torch.cat([x.reshape(-1).float() for x in leaves])


def _unpack(rows: np.ndarray, like):
    """(R, F) packed rows as the out tree of numpy arrays with a leading
    axis R, shaped and typed like `like` (meta tensors)."""
    n, leaves, off = rows.shape[0], [], 0
    for x in tree_leaves(like):
        a = rows[:, off:off + x.numel()].reshape((n,) + tuple(x.shape))
        leaves.append(a.astype(bool) if x.dtype == torch.bool else a)
        off += x.numel()
    return tree_unflatten(like, leaves)


class RoundGraph:
    """A round body at fixed addresses; see the module docstring.
    `bind` it once, then `run` chunks of rounds."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.state = self.carry = self.slots = None
        self._body = None
        self._graph = None
        self._row = None          # the captured round's packed output
        self._like = None         # the out tree's structure (meta tensors)
        self._stream = None
        self.eager_rounds = self.replays = 0

    @property
    def bound(self) -> bool:
        return self._body is not None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def bind(self, body: Callable, state, carry, slots):
        """The body and its static tensors: `state` and `carry` (updated
        in place each round) and `slots` (filled by the caller)."""
        if self.bound:
            raise ValueError("this RoundGraph is bound already")
        self._body = body
        self.state, self.carry, self.slots = state, carry, slots

    def _round(self):
        """The body on the static tensors, its results copied into them;
        returns the packed out row."""
        state, carry, out = self._body(self.state, self.carry, self.slots)
        copy_into((self.state, self.carry), (state, carry))
        if self._like is None:
            self._like = tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                out)
        return _pack(out)

    def _step(self):
        if self._graph is not None:
            self._graph.replay()
            self.replays += 1
            return self._row
        self.eager_rounds += 1
        if not self.capture:
            return self._round()
        # the warm-up: a real round, eager, on the stream that captures
        device = tree_leaves(self.state)[0].device
        main = torch.cuda.current_stream(device)
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(main)
        with _expandable_segments(), torch.cuda.stream(self._stream), \
                _sync_debug_error():
            row = self._round()
        main.wait_stream(self._stream)
        row.record_stream(main)
        # the warm-up's cached blocks back to the card (its reference
        # cycles collected first): the capture's private pool cannot use
        # them, and a round of multi-GB leaves (granite-3-2b at 16
        # layers in bfloat16) does not fit twice
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        with _expandable_segments(), torch.cuda.graph(graph,
                                                      stream=self._stream):
            self._row = self._round()
        self._graph = graph
        return row

    def run(self, n_rounds: int, fill: Callable[[int], None]):
        """`n_rounds` rounds; before round i, `fill(i)` writes its inputs
        into `slots`. Returns the rounds' out tree as numpy arrays with a
        leading axis n_rounds."""
        if not self.bound:
            raise ValueError("bind the round body first")
        rows = None
        for i in range(n_rounds):
            fill(i)
            row = self._step()
            if rows is None:
                rows = torch.empty((n_rounds, row.numel()),
                                   dtype=torch.float32, device=row.device)
            rows[i].copy_(row)
        if rows is None:
            return None
        if rows.device.type == "meta":
            # a dry run's rounds (`launch.dryrun`): no values to copy
            return tree_map(lambda x: x.new_empty((n_rounds,) + x.shape),
                            self._like)
        return _unpack(rows.cpu().numpy(), self._like)
