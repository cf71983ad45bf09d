"""The mesh layout's process side: one `torch.distributed` rank per paper
worker, or per (worker, model rank) pair under tensor parallelism. Port
of the process-group part of `repro.launch.mesh` (where a JAX mesh axis
holds the workers, here a process group does).

`spawn` starts the ranks and collects what each returns; the collective
helpers below run an all-gather or an all-reduce on any group. On a gloo
group (ranks that share a card, or the CPU) the wire is host memory, so
the helpers stage device tensors through the host; on an NCCL group the
tensors stay on their cards. Each helper reports its bytes to an open
`launch.hlo_costs` counter, as the JAX package counts them: an
all-gather its gathered result, an all-reduce its operand twice. On meta
tensors (a dry run, `launch.dryrun`) a helper transfers nothing and
returns an empty result of the right shape: the group need only know
its size and this rank (a fake process group does).

THE 2-D LAYOUT (`spawn(..., tp=t)`): the world is K x t ranks, global
rank k * t + r being worker k's model rank r, as a JAX (data, model)
mesh orders its devices. Every rank builds a data group for each r
(ranks k * t + r over k: Algorithm 2's collectives) and a model group
for each k (ranks k * t + r over r: the Megatron feed-forward's), and
registers its own two under the axis names "data" and "model"
(`axis_group`), which the TP-aware specs name as the JAX package's do.
"""
from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device
from repro_torch.launch import hlo_costs


def wire_on_host(group=None) -> bool:
    """True when the group's backend sends from host memory (gloo)."""
    return dist.get_backend(group) == "gloo"


def global_rank(group, rank: int) -> int:
    """The global rank of `group`'s rank `rank` (the peer P2P ops take)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def all_gather(t, group=None):
    """Every rank's `t`, stacked on a new leading axis in rank order, on
    `t`'s device."""
    k = dist.get_world_size(group)
    hlo_costs.record_collective("all-gather", k * t.nbytes)
    if t.device.type == "meta":
        return t.new_empty((k,) + tuple(t.shape))
    src = t.detach().contiguous()
    if wire_on_host(group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)


def all_reduce_sum(t, group=None):
    """The sum of every rank's `t`, on `t`'s device."""
    hlo_costs.record_collective("all-reduce", 2 * t.nbytes)
    if t.device.type == "meta":
        return torch.empty_like(t)
    buf = t.detach().to("cpu" if wire_on_host(group) else t.device,
                        copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_reduce_max(t, group=None):
    """The elementwise max of every rank's `t`, on `t`'s device."""
    hlo_costs.record_collective("all-reduce", 2 * t.nbytes)
    if t.device.type == "meta":
        return torch.empty_like(t)
    buf = t.detach().to("cpu" if wire_on_host(group) else t.device,
                        copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(t.device)


# ---------------------------------------------------------------------------
# The 2-D (data x model) groups
# ---------------------------------------------------------------------------

_AXES: dict = {}      # axis name -> this rank's process group


def _build_tp_groups(world_size: int, tp: int):
    """Create every data and model group (each rank creates all of them,
    in one order, as `dist.new_group` requires) and register this rank's
    two under "data" and "model"."""
    n_workers, me = world_size // tp, dist.get_rank()
    _AXES.clear()
    for r in range(tp):
        g = dist.new_group([k * tp + r for k in range(n_workers)])
        if me % tp == r:
            _AXES["data"] = g
    for k in range(n_workers):
        g = dist.new_group([k * tp + r for r in range(tp)])
        if me // tp == k:
            _AXES["model"] = g


def axis_group(axis):
    """The process group of `axis`: a registered axis name ("data",
    "model") resolves to this rank's group of that axis; a process group
    passes through; None stays None."""
    if axis is None or not isinstance(axis, str):
        return axis
    if axis not in _AXES:
        raise RuntimeError(
            f"no {axis!r} process group on this rank: start the ranks with "
            f"repro_torch.launch.mesh.spawn(..., tp=...) (registered: "
            f"{sorted(_AXES)})")
    return _AXES[axis]


def tp_mesh_error(model_group, tp: int):
    """The shared tp-vs-groups contract: tensor parallelism of width `tp`
    needs a model process group of exactly that size. Returns the
    actionable message, or None when the group satisfies it (the
    counterpart of `repro.launch.mesh.tp_mesh_error`, with the model
    group in place of the mesh's 'model' axis)."""
    if tp <= 1:
        return None
    size = (None if model_group is None
            else dist.get_world_size(model_group))
    if size != tp:
        return (f"tp={tp} needs a model process group of size {tp} (got "
                f"{'none' if size is None else size}); start the ranks "
                f"with repro_torch.launch.mesh.spawn(..., tp={tp})")
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(value):
    """Tensors in a (nested) result -> numpy arrays, for the queue."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _rank_main(rank, world_size, fn, device_type, backend, init_method,
               timeout_s, queue, tp=1):
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        if tp > 1:
            _build_tp_groups(world_size, tp)
        try:
            result = _to_host(fn(rank, world_size, device))
        finally:
            _AXES.clear()
            dist.destroy_process_group()
        queue.put((rank, True, result))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, *, device="cuda", backend=None,
          init_method=None, timeout_s: float = 300.0, tp: int = 1):
    """Run `fn(rank, world_size, device)` on `world_size` ranks, each a
    process started with `torch.multiprocessing`'s "spawn" method, inside
    a process group; returns their results in rank order, with tensors
    turned into numpy arrays. `fn` must be picklable (a module-level
    function, or a `functools.partial` of one).

    device: "cuda" (the default; raises without CUDA) or "cpu". Rank r
    runs on cuda:{r % device_count}.
    backend: None means "nccl" on CUDA and "gloo" on the CPU. NCCL needs a
    card per rank: ranks that share a card need backend="gloo".
    init_method: None means tcp://localhost on a free port.
    timeout_s: bounds `init_process_group`, every collective, and the
    wait for each rank's result.
    tp: the model ranks a worker (module docstring): world_size // tp
    workers, each rank with its "data" and "model" groups registered.

    A rank that raises makes `spawn` stop the other ranks and raise a
    RuntimeError that carries the rank's traceback.
    """
    dev = resolve_device(device)
    if tp < 1 or world_size % tp:
        raise ValueError(f"tp={tp} must divide world_size={world_size}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' runs on CUDA devices")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"backend='nccl' needs a card per rank: {world_size} ranks "
                f"on {torch.cuda.device_count()} card(s); ranks that share "
                f"a card need backend='gloo'")
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world_size, fn, dev.type, backend,
                               init_method, timeout_s, queue, tp))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    results, got, finished = [None] * world_size, set(), False
    deadline, seen_dead = time.monotonic() + timeout_s, False
    try:
        while len(got) < world_size:
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without a result (its last message
                # gets one more second to arrive), or one that hangs
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if (dead and seen_dead) or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"spawn: ranks {sorted(set(range(world_size)) - got)}"
                        f" gave no result (exited: {dead}; limit "
                        f"{timeout_s} s)") from None
                seen_dead = bool(dead)
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            results[rank] = value
            got.add(rank)
        finished = True
    finally:
        for p in procs:
            if not finished:
                p.terminate()
            p.join(timeout=timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
    return results


__all__ = ["spawn", "all_gather", "all_reduce_sum", "all_reduce_max",
           "wire_on_host", "global_rank", "axis_group", "tp_mesh_error"]
