"""Algorithm 2 as a chunked ring collective over `torch.distributed`, with
dequantize-and-accumulate in the hand-written Hopper ring_accum kernel.
Port of `repro.kernels.ring_wavg.ops`.

The flat path (`averaging.weighted_average_psum(impl="pallas")`)
all-gathers every worker's FULL f32 payload, K * N * 4 bytes a rank even
when the uplink was quantized to 16 bits. ``impl="ring"`` instead:

  * keeps the uplink payload ENCODED on the wire (int16 at the paper's 16
    bits; int32 at 17..31; f32 unquantized), as (n_blocks, BLOCK_N) wire
    blocks beside a travelling (n_blocks,) f32 vector of block scales
    (each leaf's per-tensor scale over its blocks);
  * reduces in k-1 point-to-point hops around the ring of ranks: after
    hop h rank r holds worker (r - h) mod k's payload and accumulates it,
    with coef = w_norm[src] * block scale, into a resident f32
    accumulator through the `ring_accum_` kernel wrapper;
  * sends each hop in chunks (DEFAULT_CHUNKS): chunk c+1's send and
    receive are posted before chunk c is accumulated, so the next
    transfer overlaps the current reduction.

Per-rank wire bytes: (k-1) * n_blocks * (BLOCK_N * wire itemsize + 4),
`ring_wire_bytes_per_rank`, which `wire_bytes_sent` counts as it goes.

THE TRANSPORT. On a gloo group (ranks that share one card, or the CPU)
the wire is host memory: a rank copies its encoded payload once to pinned
host memory, forwards what it receives from there, and copies to its card
only the chunk it accumulates. On an NCCL group the buffers stay on the
cards.

Quantization uses `core.quantize.quantize_tree` with the rank's row of the
round's uniforms, the stream of the flat path's roundtrip, so the ring
changes reduction order and precision only, never the quantized values.
`shard_round.check_ring_support` keeps the ring to tp=1, no robust
reducers and no upload-corrupting fault programs (those act on dequantized
per-worker trees). Dropout and stragglers compose: they only zero weights.

No survivor: when every weight is zero, ``fallback`` (the previous
global) is returned, by a `torch.where` on the device with no host sync.

`ring_accum_` launches the kernel in `repro_torch/csrc/ring_accum.cu` on a
CUDA tensor or raises; on a CPU tensor it takes the plain version
(`ref.ring_accum_ref`), and only because the tensor lies on the CPU; on a
meta tensor (a dry run) it launches nothing. The ring itself launches
through a `RowAccumulator`, which checks its tensors once a ring call and
then costs a launch only a bound check and one ctypes call (37 launches a
rank a ring round at K=10). A launch and a meta call report the kernel's
work (`cost`) to an open `launch.hlo_costs` counter, and every hop its
wire bytes, as `collective-permute`.

A DRY RUN (meta tensors, `launch.dryrun`) posts no transfer: its hops
count their wire bytes, the same as `wire_bytes_sent` counts on a real
ring, and receive buffers of the right shapes, so the ring's costs and
memory are reckoned without a peer.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import quantize
from repro_torch.kernels._build import load_library
from repro_torch.kernels.ring_wavg.ref import ring_accum_ref
from repro_torch.launch import hlo_costs, mesh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# Wire block: shared with the TPU wavg kernel's tiling in the JAX package.
BLOCK_N = 2048
# Chunks per hop: enough to overlap transfer and accumulate without
# shrinking chunks below useful sizes at small payloads.
DEFAULT_CHUNKS = 4

# Kernel launches since import (or since a caller reset it to 0).
launches = 0
# Payload and block-scale bytes handed to send by `ring_average_psum`.
wire_bytes_sent = 0

_ENTRY = {torch.int16: "ring_accum_i16", torch.int32: "ring_accum_i32",
          torch.float32: "ring_accum_f32"}


# The C entry points' parameters: acc, q, coef; rows; the card's SM
# count; stream.
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]


@functools.cache
def _kernel(dtype):
    fn = getattr(load_library("ring_accum", ("ring_accum.cu",)),
                 _ENTRY[dtype])
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def build():
    """Compile (if needed) and load the kernel library."""
    for dtype in _ENTRY:
        _kernel(dtype)


def wire_dtype(bits: int):
    """Wire dtype of the encoded payload at an uplink bit width: the
    quantizer clips to [-2**(bits-1), 2**(bits-1) - 1], so bits <= 16 fit
    int16 exactly."""
    if bits >= 32:
        return torch.float32
    return torch.int16 if bits <= 16 else torch.int32


def _n_blocks(tree) -> int:
    return sum(-(-x.numel() // BLOCK_N) for x in tree_leaves(tree))


def ring_wire_bytes_per_rank(tree, bits: int, k: int) -> int:
    """Bytes a rank sends in one ring reduction: k-1 hops, each of the
    padded wire payload and the block-scale vector."""
    itemsize = torch.empty((), dtype=wire_dtype(bits)).element_size()
    return (k - 1) * _n_blocks(tree) * (BLOCK_N * itemsize + 4)


def cost(rows: int, itemsize: int):
    """(flops, bytes) of one launch over `rows` wire blocks of
    `itemsize`-byte elements: a multiply-add an element; acc read and
    written, q read once, and a coefficient a row (PERF.md section 6,
    row 2: rows * 2048 * 10 + rows * 4 bytes at int16)."""
    return 2 * rows * BLOCK_N, rows * BLOCK_N * (8 + itemsize) + rows * 4


def _chunk_bounds(n_blocks: int, n_chunks: int):
    """Block-row ranges of the chunks of a hop; a ragged split gives at
    most two chunk sizes."""
    n_chunks = max(1, min(n_chunks, n_blocks))
    base, rem = divmod(n_blocks, n_chunks)
    bounds, r0 = [], 0
    for c in range(n_chunks):
        r1 = r0 + base + (1 if c < rem else 0)
        bounds.append((r0, r1))
        r0 = r1
    return bounds


def _encode(local_params, uniforms, bits: int):
    """A tree -> ((n_blocks, BLOCK_N) wire payload, (n_blocks,) f32 block
    scales). Each leaf starts a new block; the padding is zeros. With
    bits < 32 the leaves are quantized with `uniforms` (N,)."""
    leaves = tree_leaves(local_params)
    if bits < 32:
        if uniforms is None:
            raise ValueError(f"a {bits}-bit wire needs the uplink's "
                             f"uniforms")
        q_tree, s_tree = quantize.quantize_tree(uniforms, local_params, bits)
        pairs = zip(tree_leaves(q_tree), tree_leaves(s_tree))
    else:
        pairs = ((x, 1.0) for x in leaves)
    device = leaves[0].device
    n_blocks = _n_blocks(local_params)
    payload = torch.zeros((n_blocks, BLOCK_N), dtype=wire_dtype(bits),
                          device=device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=device)
    flat, row = payload.view(-1), 0
    for q, s in pairs:
        nb = -(-q.numel() // BLOCK_N)
        flat[row * BLOCK_N:row * BLOCK_N + q.numel()] = q.reshape(-1)
        scales[row:row + nb] = s
        row += nb
    return payload, scales


def _decode(acc, like):
    """The (n_blocks, BLOCK_N) accumulator as a tree shaped like `like`,
    in its dtypes."""
    flat, out, row = acc.view(-1), [], 0
    for x in tree_leaves(like):
        start = row * BLOCK_N
        out.append(flat[start:start + x.numel()].reshape(x.shape)
                   .to(x.dtype))
        row += -(-x.numel() // BLOCK_N)
    return tree_unflatten(like, out)


def _check(acc, q, coef):
    if (acc.dim() != 2 or acc.shape[1] != BLOCK_N or acc.shape[0] < 1
            or q.shape != acc.shape or coef.shape != acc.shape[:1]):
        raise ValueError(f"ring_accum takes acc and q (rows, {BLOCK_N}) and "
                         f"coef (rows,); got {tuple(acc.shape)}, "
                         f"{tuple(q.shape)} and {tuple(coef.shape)}")
    if (acc.dtype != torch.float32 or coef.dtype != torch.float32
            or q.dtype not in _ENTRY):
        raise ValueError(f"ring_accum takes f32 acc and coef and an int16, "
                         f"int32 or f32 q; got {acc.dtype}, {coef.dtype} "
                         f"and {q.dtype}")
    if not acc.device == q.device == coef.device:
        raise ValueError(f"acc on {acc.device}, q on {q.device}, coef on "
                         f"{coef.device}")
    if not (acc.is_contiguous() and q.is_contiguous()
            and coef.is_contiguous()):
        raise ValueError("ring_accum takes contiguous acc, q and coef")
    if acc.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("ring_accum takes 16-byte aligned acc and q")


def ring_accum_(acc, q, coef):
    """acc[r, :] += coef[r] * float(q[r, :]) in place, for acc (rows,
    BLOCK_N) f32, q (rows, BLOCK_N) int16 | int32 | f32 and coef (rows,)
    f32; returns acc."""
    with _device_guard(acc.device):
        RowAccumulator(acc, q, coef)(0, acc.shape[0])
    return acc


def _device_guard(device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class RowAccumulator:
    """`ring_accum_` on row ranges of (acc, q, coef), checked once here:
    the ring accumulates every chunk of a hop through one, so a launch
    costs a bound check, one ctypes call and the count. On CUDA tensors
    the caller holds the device (`_device_guard`) across the calls; the
    stream is the one current at construction. On CPU tensors a call
    takes the plain version on the slices."""

    def __init__(self, acc, q, coef):
        if acc.device.type not in ("cuda", "cpu", "meta"):
            raise ValueError(f"ring_accum runs on CUDA, CPU or meta tensors, "
                             f"not {acc.device}")
        _check(acc, q, coef)
        self.rows = acc.shape[0]
        self.tensors = acc, q, coef
        self.device_type = acc.device.type
        self._itemsize = q.element_size()
        self._launch = None
        if acc.device.type == "cuda":
            self._launch = _kernel(q.dtype)
            self._sms = _sm_count(acc.device.index)
            self._stream = torch.cuda.current_stream(acc.device).cuda_stream
            # a row's bytes in acc, q and coef: rows are 2048 elements,
            # so every row of acc and q starts 16-byte aligned
            self._base = [(t.data_ptr(), t.stride(0) * t.element_size())
                          for t in (acc, q, coef)]

    def __call__(self, r0, r1):
        """Accumulate rows [r0, r1)."""
        global launches
        if not 0 <= r0 < r1 <= self.rows:
            raise ValueError(f"ring_accum rows [{r0}, {r1}) outside the "
                             f"{self.rows} rows checked")
        if self.device_type == "meta":
            hlo_costs.record_kernel("ring_accum",
                                    *cost(r1 - r0, self._itemsize))
            return
        if self._launch is None:
            acc, q, coef = self.tensors
            with hlo_costs.plain_call("ring_accum"):
                ring_accum_ref(acc[r0:r1], q[r0:r1], coef[r0:r1])
            return
        (a, ra), (q, rq), (c, rc) = self._base
        err = self._launch(a + r0 * ra, q + r0 * rq, c + r0 * rc, r1 - r0,
                           self._sms, self._stream)
        if err != 0:
            raise RuntimeError(f"ring_accum kernel launch failed with CUDA "
                               f"error {err}")
        launches += 1
        hlo_costs.record_kernel("ring_accum", *cost(r1 - r0, self._itemsize))


def _host_copy(t):
    """`t` in host memory for the gloo wire: pinned when it leaves a
    card, so the chunk copies back to the card can run asynchronously."""
    if t.device.type == "cpu":
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _empty_like_wire(t):
    return torch.empty(t.shape, dtype=t.dtype, device=t.device,
                       pin_memory=t.is_pinned())


def _ring_hops(acc, payload, scales, coef, w_norm, bounds, k, my, group):
    """Hops 1..k-1 of the ring: after hop h this rank has accumulated
    worker (my - h) mod k's payload into `acc`, chunk by chunk."""
    global wire_bytes_sent
    nxt = mesh.global_rank(group, (my + 1) % k)
    prv = mesh.global_rank(group, (my - 1) % k)

    dry = acc.device.type == "meta"

    def post(send, recv, tag):
        hlo_costs.record_collective("collective-permute", send.nbytes)
        if dry:
            return []            # a dry run: the bytes, no transfer
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group, tag),
            dist.P2POp(dist.irecv, recv, prv, group, tag)])

    on_host = not dry and mesh.wire_on_host(group)
    buf, sbuf = ((_host_copy(payload), _host_copy(scales)) if on_host
                 else (payload, scales))
    if on_host:
        # the chunks received in host memory are copied here to be
        # accumulated
        dev_q = torch.empty_like(payload)
        accumulate = [RowAccumulator(acc, dev_q, coef)] * 2
    else:
        # the wire is on the device: two receive buffers, in turn
        recv_bufs = [torch.empty_like(payload) for _ in range(2)]
        accumulate = [RowAccumulator(acc, r, coef) for r in recv_bufs]
    for h in range(1, k):
        # The block scales travel once a hop, beside the payload: after
        # hop h this rank holds worker (my - h) mod k's.
        rscales = _empty_like_wire(sbuf)
        for req in post(sbuf, rscales, len(bounds)):
            req.wait()
        wire_bytes_sent += 0 if dry else sbuf.nbytes
        sbuf = rscales
        torch.mul(sbuf.to(coef.device), w_norm[(my - h) % k], out=coef)

        # Chunk c+1's transfer is posted before chunk c is accumulated,
        # so the two overlap.
        rbuf = _empty_like_wire(buf) if on_host else recv_bufs[h % 2]
        reqs = [post(buf[r0:r1], rbuf[r0:r1], c)
                for c, (r0, r1) in enumerate(bounds[:1])]
        for c, (r0, r1) in enumerate(bounds):
            if c + 1 < len(bounds):
                n0, n1 = bounds[c + 1]
                reqs.append(post(buf[n0:n1], rbuf[n0:n1], c + 1))
            for req in reqs[c]:
                req.wait()
            wire_bytes_sent += 0 if dry else buf[r0:r1].nbytes
            if on_host:
                dev_q[r0:r1].copy_(rbuf[r0:r1], non_blocking=True)
            accumulate[h % 2](r0, r1)
        buf = rbuf


def ring_average_psum(local_params, local_weight, *, group=None,
                      uniforms=None, bits: int = 32,
                      n_chunks: Optional[int] = None, fallback=None,
                      weights=None):
    """The ring collective of Algorithm 2, the `weighted_average_psum`
    twin for ``impl="ring"``: every rank of `group` holds ITS worker's
    parameters and weight; returns the weighted average on every rank.

    uniforms: this rank's (N,) stochastic-rounding uniforms, needed when
    bits < 32 (the payload is then quantized and travels encoded).
    fallback: a tree shaped like `local_params`, returned when the total
    weight is zero (a no-survivor round).
    weights: the group's (K,) weights in rank order, when the caller has
    gathered them already; None gathers them here.
    """
    leaves = tree_leaves(local_params)
    if not leaves:
        return local_params
    device = leaves[0].device
    k, my = dist.get_world_size(group), dist.get_rank(group)
    w_full = weights if weights is not None else mesh.all_gather(
        torch.as_tensor(local_weight, dtype=torch.float32,
                        device=device).reshape(1), group).reshape(k)
    total = w_full.sum()
    w_norm = w_full / torch.clamp(total, min=1e-12)

    payload, scales = _encode(local_params, uniforms, bits)
    bounds = _chunk_bounds(payload.shape[0], DEFAULT_CHUNKS
                           if n_chunks is None else n_chunks)

    # Every launch goes through a RowAccumulator, checked once here over
    # the whole accumulator, a wire buffer on the device and the
    # coefficients, which each hop rewrites in place.
    acc = torch.zeros(payload.shape, dtype=torch.float32, device=device)
    coef = w_norm[my] * scales
    with _device_guard(device):
        # Hop 0: the rank's own contribution, no wire traffic.
        RowAccumulator(acc, payload, coef)(0, acc.shape[0])
        if k > 1:
            _ring_hops(acc, payload, scales, coef, w_norm, bounds, k, my,
                       group)

    avg = _decode(acc, local_params)
    if fallback is None:
        return avg
    return tree_map(lambda a, f: torch.where(total > 0, a, f.to(a.dtype)),
                    avg, fallback)


__all__ = ["ring_average_psum", "ring_wire_bytes_per_rank", "wire_dtype",
           "ring_accum_", "ring_accum_ref", "RowAccumulator", "build", "cost",
           "BLOCK_N", "DEFAULT_CHUNKS"]
