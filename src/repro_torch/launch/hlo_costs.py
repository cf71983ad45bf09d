"""Costs of one call of a step, counted op by op as it dispatches: the
port's counterpart of `repro.launch.hlo_costs`.

The JAX package parses a compiled program's optimized HLO and multiplies
each while body by its trip count, because XLA's own cost analysis
counts a loop body once. The port has no compiled artifact: a step is
Python that dispatches aten ops one at a time, so its counterpart of
the artifact is one call of the step. Eager dispatch visits every loop
trip, so each trip is counted because it runs. On the meta device (a
dry run) nothing is allocated; on real tensors the same counter
measures a real call.

`count_costs(fn, *args)` (or `CostCounter` as a context manager around
any call) counts, with the JAX package's conventions and dict keys:

  flops            products and convolutions, 2*M*N*K
                   (`torch.utils.flop_counter`'s registered formulas;
                   a forward convolution 2 * out_elems * (kernel_elems /
                   out_channels), JAX's `_conv_flops`); a hand-written
                   kernel's launch (and its meta branch) by the kernel's
                   own formula, `record_kernel`; the plain versions that
                   take a kernel's place on the CPU by their own ops
  hbm_bytes        the no-reuse traffic model: operand plus result bytes
                   of every materialising op. Views and aliasing ops
                   (from the op schema's alias info, the counterpart of
                   JAX's `_SKIP_OPS`) and bare allocations count nothing;
                   in-place writes into a larger buffer (`copy_`,
                   `index_copy_`, `index_put_`, scatters) twice the
                   written region (JAX's `dynamic-update-slice` rule);
                   gathers and index-selects twice their result
  collective_bytes the port's collective call sites report their bytes
                   by kind (`record_collective`): `launch.mesh`'s
                   all-gather its gathered result, an all-reduce its
                   operand twice (reduce-scatter plus all-gather), the
                   ring's hops their wire bytes as `collective-permute`
  bytes_by_kind, counts   per collective kind
  kernels          per hand-written kernel: calls, flops and bytes (its
                   formula where it runs or is dry-run; on the CPU the
                   plain version's ops, run inside its wrapper)

and a memory reckoning (`memory()`): the storages alive during the
call, each rounded up to the caching allocator's 512-byte granule,
tracked by storage (views share) and freed when the storage is:
argument_bytes (the storages of the call's tensor arguments),
output_bytes (those of its result), peak_bytes (the largest live sum,
arguments counted) and temp_bytes (peak less arguments).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# The caching allocator's granule: every block is a multiple of it.
GRANULE = 512

_aten = torch.ops.aten
# Allocations with no traffic of their own.
_ALLOC_OPS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided}
# Views whose schema does not say so.
_VIEW_OPS = {_aten._unsafe_view, _aten.lift_fresh}
# Reads of selected rows: twice the result (JAX's dynamic-slice and
# gather rule).
_GATHER_OPS = {_aten.index, _aten.index_select, _aten.gather,
               _aten.embedding, _aten.take}
# In-place writes of a region of a buffer: twice the region (JAX's
# dynamic-update-slice rule).
_UPDATE_OPS = {_aten.copy_, _aten.index_copy_, _aten.index_put_,
               _aten.scatter_, _aten.scatter_add_, _aten.scatter_reduce_,
               _aten.index_add_, _aten.masked_scatter_,
               _aten._index_put_impl_}
_CONV_OPS = {_aten.convolution, _aten._convolution}

# The counter open on this process, if any (one at a time).
_ACTIVE = None


def _round_up(n: int) -> int:
    return -(-n // GRANULE) * GRANULE


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def conv_flops(out_shape, weight_shape, transposed: bool) -> float:
    """JAX's `_conv_flops`: 2 * out_elems * (kernel_elems /
    out_channels). The out channels are the result's dim 1 (NCHW); a
    transposed convolution's weight is (in, out / groups, ...), so its
    kernel elements per output channel are in * prod(window) / groups,
    as in the dilated convolution XLA lowers it to."""
    out_elems = 1
    for d in out_shape:
        out_elems *= d
    k_elems = 1
    for d in weight_shape:
        k_elems *= d
    out_ch = out_shape[1]
    return 2.0 * out_elems * max(k_elems // max(out_ch, 1), 1)


def _flat(x):
    """The tensors of an op's argument or result (a tensor, or a list or
    tuple of tensors and Nones)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


# func -> (kind, flop function or None, argument names, out= names)
_OP_INFO: dict = {}


def _op_info(func):
    """What the counter needs of an op, from its overload and schema,
    computed once an op: its kind ("free": a view, an alias or a bare
    allocation; "gather"; "update"; "op"), its FLOP formula, and its
    arguments' names, those of its out= buffers apart."""
    info = _OP_INFO.get(func)
    if info is not None:
        return info
    packet = func.overloadpacket
    schema = func._schema
    if (packet in _ALLOC_OPS or packet in _VIEW_OPS
            or any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)):
        kind = "free"
    elif packet in _GATHER_OPS:
        kind = "gather"
    elif packet in _UPDATE_OPS:
        kind = "update"
    else:
        kind = "op"
    flop_fn = None
    if packet in _CONV_OPS:
        def flop_fn(args, kwargs, out):
            return conv_flops(out.shape, args[1].shape, bool(args[6]))
    elif packet in flop_registry:
        formula = flop_registry[packet]

        def flop_fn(args, kwargs, out):
            return formula(*args, **kwargs, out_val=out)
    names = tuple(a.name for a in schema.arguments)
    out_names = frozenset(a.name for a in schema.arguments
                          if getattr(a, "is_out", False))
    info = _OP_INFO[func] = (kind, flop_fn, names, out_names)
    return info


def _op_bytes(kind, names, out_names, args, kwargs, outs) -> float:
    """An op's traffic under the no-reuse model (module docstring)."""
    result = sum(_nbytes(t) for t in outs)
    if kind == "gather":
        return 2.0 * result
    operands = []
    for name, value in zip(names, args):
        if name not in out_names:          # an out= buffer is not read
            operands.extend(_flat(value))
    for name, value in kwargs.items():
        if name not in out_names:
            operands.extend(_flat(value))
    if kind == "update":
        # the region written (the operands besides the buffer), read
        # once and written once
        written = {id(t) for t in outs}
        return 2.0 * sum(_nbytes(t) for t in operands
                         if id(t) not in written)
    return float(result + sum(_nbytes(t) for t in operands))


class _Memory:
    """Live storage bytes, keyed by storage: a storage counts once
    however many tensors view it, and leaves when it is freed (a weak
    reference's callback)."""

    def __init__(self):
        self.live = {}           # storage key -> (rounded bytes, weakref)
        self.total = 0
        self.peak = 0

    def track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        size = _round_up(st.nbytes())
        old = self.live.get(key)
        if old is None:
            self.live[key] = (size, weakref.ref(
                st, lambda _, key=key: self._free(key)))
            self.total += size
        elif old[0] != size:     # resized in place
            self.live[key] = (size, old[1])
            self.total += size - old[0]
        else:
            return
        if self.total > self.peak:
            self.peak = self.total

    def _free(self, key):
        entry = self.live.pop(key, None)
        if entry is not None:
            self.total -= entry[0]

    def bytes_of(self, tensors) -> int:
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[st._cdata] = _round_up(st.nbytes())
        return sum(seen.values())


class CostCounter(TorchDispatchMode):
    """Counts the ops, kernels and collectives of the call it is open
    around (module docstring). `track_args(*args)` registers the call's
    arguments with the memory reckoning before the call, and
    `track_result(out)` its result after it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.bytes_by_kind = defaultdict(float)
        self.counts = defaultdict(int)
        self.kernels = {}
        self._scope = None       # the kernel whose wrapper is running
        # bytes of the results made on each device type but meta
        self.made_on = defaultdict(int)
        self._memory = _Memory()
        self._argument_bytes = self._output_bytes = 0

    # -- the mode -------------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a CostCounter is already open")
        _ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat(out)
        kind, flop_fn, names, out_names = _op_info(func)
        if kind != "free":
            flops = 0.0 if flop_fn is None else float(flop_fn(args, kwargs,
                                                              out))
            self._add(flops, _op_bytes(kind, names, out_names, args, kwargs,
                                       outs))
        for t in outs:
            if t.device.type != "meta":
                self.made_on[t.device.type] += _nbytes(t)
            self._memory.track(t)
        return out

    def _add(self, flops, n_bytes, kernel=None):
        """Add to the totals, and to `kernel`'s entry (by default the
        kernel whose plain version is running, if any)."""
        self.flops += flops
        self.hbm_bytes += n_bytes
        kernel = self._scope if kernel is None else kernel
        if kernel is not None:
            entry = self.kernels[kernel]
            entry["flops"] += flops
            entry["hbm_bytes"] += n_bytes

    def _kernel_entry(self, name):
        return self.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "hbm_bytes": 0.0})

    # -- the memory reckoning ------------------------------------------
    def track_args(self, *args, **kwargs):
        tensors = _tensors((args, kwargs))
        for t in tensors:
            self._memory.track(t)
        self._argument_bytes = self._memory.bytes_of(tensors)

    def track_result(self, out):
        self._output_bytes = self._memory.bytes_of(_tensors(out))

    def memory(self) -> dict:
        peak = max(self._memory.peak, self._argument_bytes)
        return {"argument_bytes": self._argument_bytes,
                "output_bytes": self._output_bytes,
                "temp_bytes": peak - self._argument_bytes,
                "peak_bytes": peak}

    def totals(self) -> dict:
        """The JAX package's dict (`repro.launch.hlo_costs.hlo_costs`),
        with the kernels' entries beside it."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": float(sum(self.bytes_by_kind.values())),
                "bytes_by_kind": dict(self.bytes_by_kind),
                "counts": dict(self.counts),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def count_costs(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) once under a CostCounter, its arguments
    and result tracked by the memory reckoning. Returns (result,
    counter)."""
    counter = CostCounter()
    counter.track_args(*args, **kwargs)
    with counter:
        out = fn(*args, **kwargs)
    counter.track_result(out)
    return out, counter


# ---------------------------------------------------------------------------
# What the kernels' wrappers and the collective call sites report
# ---------------------------------------------------------------------------

def record_kernel(name: str, flops: float, hbm_bytes: float):
    """A hand-written kernel's launch (or its meta branch's stand-in for
    one), counted by its formula in the open counter, if any."""
    c = _ACTIVE
    if c is None:
        return
    c._kernel_entry(name)["calls"] += 1
    c._add(flops, hbm_bytes, kernel=name)


@contextlib.contextmanager
def plain_call(name: str):
    """A kernel's plain version running in its place (on the CPU): one
    call of `name`, whose ops are counted as they run and filed under
    the kernel too."""
    c = _ACTIVE
    if c is None or c._scope is not None:
        yield
        return
    c._kernel_entry(name)["calls"] += 1
    c._scope = name
    try:
        yield
    finally:
        c._scope = None


def record_collective(kind: str, nbytes: float):
    """A collective of `kind` (one of COLLECTIVES) moving `nbytes`, as the
    JAX package counts it, in the open counter, if any."""
    c = _ACTIVE
    if c is None:
        return
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective kind {kind!r}")
    c.bytes_by_kind[kind] += float(nbytes)
    c.counts[kind] += 1


__all__ = ["CostCounter", "count_costs", "record_kernel", "plain_call",
           "record_collective", "conv_flops", "COLLECTIVES", "GRANULE"]
