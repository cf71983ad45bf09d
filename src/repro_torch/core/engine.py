"""Training engine: drives communication rounds with device scheduling,
the wireless channel simulator, wall-clock accounting, and periodic
evaluation — the paper's experimental harness (Figs 3-6).

Port of `repro.core.engine.Trainer`: algorithms "proposed", "fedgan"
and the "centralized" baseline, with the hostile-worker regime: fault
programs (`faults=`) and robust reducers (`reducer=`), under two drivers
on two layouts:

                    layout="stacked"          layout="mesh"
  proposed       host + fused              host + fused
  fedgan         host + fused              host + fused
  centralized    host only                 — (no device structure)

The centralized baseline trains one worker on the K shards pooled in
device order, with the draws of one device over the pooled rows; the
host driver still schedules and times the K devices, so its wallclock
curve is the JAX Trainer's. It has no fused driver, no mesh layout, no
faults and no reducer, and refuses them as the JAX Trainer does.

DRIVER — how rounds are dispatched:

  driver="fused" - Step 1 (scheduling, channel timing, dropout and
      stragglers) on the device, in one round body with Steps 2-5 and the
      wallclock (`protocol.rounds`). On the stacked layout on CUDA the
      body runs eagerly once, under `set_sync_debug_mode("error")`, and
      then replays once a round as ONE captured CUDA graph
      (`core/graphs.py`), the counterpart of the JAX package's one XLA
      dispatch a chunk; on the CPU and on the mesh layout it runs
      uncaptured. Round t's draws come from the same streams as the host
      driver's; fading and the random policy draw from a per-round stream
      of their own. FID runs on the host at chunk boundaries (the JAX
      package's path for a fid_fn it cannot trace).
  driver="host"  - one round per call with numpy scheduling and channel
      state, as the JAX package's host driver, whose masks, weights and
      wallclock it matches bit for bit: the equivalence oracle of the
      fused driver, whose masks and weights equal its own for
      deterministic policies with fading off.
  driver="auto" (default) - as in the JAX package: "fused" for the
      proposed protocol and FedGAN, "host" for the centralized baseline.

LAYOUT:

  layout="stacked" - the K devices stacked on one card.
  layout="mesh"    - one rank of a `torch.distributed` group per device
      (`repro_torch.launch.mesh.spawn` starts them; `core/shard_round.py`
      runs the round). Every rank builds its own Trainer once the group
      exists and runs the same driver from the same seeded streams, so
      masks, weights and history agree on every rank and with a stacked
      Trainer of the same seed and driver. `avg_impl` picks Algorithm
      2's collective: "pallas" (flat all-gather, wavg kernel), "jnp"
      (per-leaf all-reduce) or "ring" (the chunked ring, ring_accum
      kernel). With tp > 1 every device is a model group of tp ranks
      (`spawn(..., tp=tp)`): the spec must be built with
      tp_axis="model" (`models.gan.mlp_gan_spec(tp_axis=)`,
      `make_backbone_spec(tp_axis=)`), each rank holds its shards of the
      TP-named leaves, cut on entry from the global tree, and runs the
      Megatron feed-forward over its model group, while scheduling, the
      channel, the quantized uplink's draws and Algorithm 2 stay on the
      data group: each rank averages its shard only. Faults, robust
      reducers and the ring are tp=1 only, as in the JAX Trainer.

MICROBATCHING (`pcfg.micro_batch_d` / `micro_batch_g`) splits Algorithm
1's and Algorithm 3's batches into chunks (`protocol._accumulated_grad`)
on every algorithm but FedGAN, which has none, as in the JAX package.

CHECKPOINT/RESUME: `save_checkpoint`/`restore` write and read the state
with the round index, the clock and the scheduler carry through
`repro_torch.checkpoint`, in the JAX package's format and tree
({"state", "trainer": {"round_index", "clock", "sched_carry"}}), so a
checkpoint crosses packages both ways. A resumed fused run continues
masks, parameters and the wallclock curve exactly: every draw is keyed
by (seed, round), and nothing else carries across rounds (the device
channel and the fault roles are fixed, the round's slots are refilled).
Host-driver resume is exact for deterministic policies with fading off
(its numpy streams are not serialized, as in JAX). `restore` on a
Trainer whose round graph is bound copies into the graph's static
tensors, so a replay reads the restored state. On the mesh layout the
checkpoint is global-shaped: the ranks' own optimizer states are
gathered into the stacked (K, ...) tree, which rank 0 writes, and each
rank restores its own slice. Under tensor parallelism the shards are
first gathered over the model group, so a checkpoint is global-shaped
at every tp: one written at tp=2 restores at tp=1, and in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import faults as faults_lib
from repro_torch.core import fedgan, graphs, protocol, shard_round
from repro_torch.core.channel import (ChannelConfig, ChannelSimulator,
                                      round_wallclock)
from repro_torch.core.device_channel import DeviceChannel
from repro_torch.core.device_scheduling import DeviceScheduler
from repro_torch.core.scheduling import SchedulerState, schedule_round
from repro_torch.device import resolve_device
from repro_torch.kernels.robust_avg.ops import ROBUST_METHODS, RobustConfig
from repro_torch.launch import mesh
from repro_torch.sharding import rules
from repro_torch.tree import tree_index, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class _Algorithm:
    """How one algorithm builds its state and runs its rounds, as in
    the JAX package's `_ALGORITHMS` table: the stacked round and fused
    rounds, the mesh ones (None where the algorithm has no mesh layout
    or no fused driver), the uplink payload (None: no uploads, so no
    faults or reducer), the state entries a mesh rank keeps for itself,
    and whether the channel times two uploaded nets (FedGAN) and the
    shards are pooled into one worker (the centralized baseline)."""
    make_state: Callable   # (init_fn, pcfg, n_devices, seed=, device=)
    round_fn: Callable     # (spec, pcfg, state, data, w, draws, faults=,
    #                         reducer=) -> (state, metrics)
    rounds_fn: Optional[Callable] = None
    mesh_round: Optional[Callable] = None
    mesh_rounds: Optional[Callable] = None
    payload: Optional[Callable] = None
    stacked_keys: tuple = ()
    fedgan: bool = False
    pooled: bool = False   # centralized: one worker on the pooled shards


_ALGORITHMS = {
    "proposed": _Algorithm(
        make_state=protocol.make_train_state, round_fn=protocol.gan_round,
        rounds_fn=protocol.gan_rounds, mesh_round=shard_round.mesh_round,
        mesh_rounds=shard_round.mesh_rounds,
        payload=shard_round.PROPOSED_PAYLOAD,
        stacked_keys=shard_round.PROPOSED_STACKED_KEYS),
    "fedgan": _Algorithm(
        make_state=fedgan.make_fedgan_state, round_fn=fedgan.fedgan_round,
        rounds_fn=fedgan.fedgan_rounds,
        mesh_round=shard_round.fedgan_mesh_round,
        mesh_rounds=shard_round.fedgan_mesh_rounds,
        payload=shard_round.FEDGAN_PAYLOAD,
        stacked_keys=shard_round.FEDGAN_STACKED_KEYS, fedgan=True),
    "centralized": _Algorithm(
        make_state=lambda init_fn, pcfg, n, **kw: protocol.make_train_state(
            init_fn, pcfg, 1, **kw),
        round_fn=lambda spec, pcfg, st, data, w, draws, **_: (
            protocol.centralized_step(spec, pcfg, st, data, draws)),
        pooled=True),
}
ALGORITHMS = tuple(_ALGORITHMS)
FUSED_ALGORITHMS = tuple(n for n, a in _ALGORITHMS.items() if a.rounds_fn)
MESH_ALGORITHMS = tuple(n for n, a in _ALGORITHMS.items() if a.mesh_round)
DRIVERS = ("auto", "fused", "host")
LAYOUTS = ("stacked", "mesh")
# Algorithm-2 collectives of the mesh layout (core/averaging.py).
MESH_AVG_IMPLS = ("pallas", "jnp", "ring")


@dataclasses.dataclass
class RoundRecord:
    round: int
    wallclock_s: float
    cumulative_s: float
    metrics: dict
    fid: Optional[float] = None
    mask: Optional[np.ndarray] = None      # (K,) bool — scheduled devices
    weights: Optional[np.ndarray] = None   # (K,) float32 — Algorithm 2's
                                           # weights (0: not averaged)


def _check_scope(algorithm, driver, layout, tp, pcfg):
    """Refuse what this port does not run, and what the JAX Trainer
    refuses, instead of degrading; returns the algorithm's record."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r} "
                         f"(have {ALGORITHMS})")
    algo = _ALGORITHMS[algorithm]
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r} is not ported; the port "
                         f"runs {LAYOUTS}")
    if layout == "mesh" and algo.mesh_round is None:
        raise ValueError(
            f"layout='mesh' is not supported for algorithm "
            f"{algorithm!r} (mesh algorithms: {MESH_ALGORITHMS}); "
            f"use layout='stacked'")
    if tp < 1:
        raise ValueError(f"tp must be >= 1 (got {tp})")
    if tp > 1 and layout != "mesh":
        raise ValueError(
            f"tp={tp} requires layout='mesh' (tensor parallelism runs "
            f"on the mesh layout's model groups; the stacked layout has "
            f"none)")
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r} (have {DRIVERS})")
    if driver == "fused" and algo.rounds_fn is None:
        raise ValueError(
            f"driver='fused' is not supported for algorithm "
            f"{algorithm!r} (fused algorithms: {FUSED_ALGORITHMS}); "
            f"use driver='host' or 'auto'")
    # the JAX package asserts this in the first round; the port refuses
    # before it builds anything
    for name, micro, total in (
            ("micro_batch_d", pcfg.micro_batch_d, pcfg.sample_size),
            ("micro_batch_g", pcfg.micro_batch_g, pcfg.server_sample_size)):
        if micro is not None and micro < total and total % micro:
            raise ValueError(f"{name}={micro} must divide the batch "
                             f"{total}")
    return algo


def _check_avg_impl(avg_impl, layout, tp, faults, reducer):
    """The JAX Trainer's checks of `avg_impl`."""
    if avg_impl not in MESH_AVG_IMPLS:
        raise ValueError(f"unknown avg_impl {avg_impl!r} "
                         f"(have {MESH_AVG_IMPLS})")
    if avg_impl != "pallas" and layout != "mesh":
        raise ValueError(
            f"avg_impl={avg_impl!r} selects the mesh layout's "
            f"Algorithm-2 collective; layout={layout!r} has no "
            f"explicit collective (use layout='mesh' or the default "
            f"avg_impl='pallas')")
    shard_round.check_faults_tp(faults, reducer, tp)
    shard_round.check_ring_support(avg_impl, tp, faults, reducer)


def _check_spec_tp(spec, layout, tp):
    """The JAX Trainer's check of the spec's TP-awareness against its
    own: a dense spec takes shards shape-consistently but never reduces
    the partial products, silently wrong."""
    spec_tp_axis = spec.tp_axis
    want_tp_axis = "model" if tp > 1 else None
    if layout == "mesh" and spec_tp_axis != want_tp_axis:
        raise ValueError(
            f"tp={tp} needs a spec built with "
            f"tp_axis={want_tp_axis!r}, got tp_axis="
            f"{spec_tp_axis!r} — rebuild it (e.g. "
            f"make_backbone_spec(tp_axis=...) / "
            f"mlp_gan_spec(tp_axis=...))")
    if layout != "mesh" and spec_tp_axis is not None:
        raise ValueError(
            f"spec was built with tp_axis={spec_tp_axis!r} (in-slice "
            f"collectives) but layout={layout!r} has no model group; "
            f"rebuild the spec with tp_axis=None")


def _mesh_rank(group, n_devices, tp):
    """(group, this process's rank in it, its model rank) of the mesh
    layout: under TP the group defaults to the rank's data group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "layout='mesh' runs inside a torch.distributed process group, "
            "one rank per device (start the ranks with "
            "repro_torch.launch.mesh.spawn)")
    tp_rank = 0
    if tp > 1:
        model = mesh.axis_group("model")
        err = mesh.tp_mesh_error(model, tp)
        if err:
            raise ValueError(err)
        tp_rank = dist.get_rank(model)
        if group is None:
            group = mesh.axis_group("data")
    world = dist.get_world_size(group)
    if world != n_devices:
        raise ValueError(f"layout='mesh' needs one rank per device: the "
                         f"group has {world} ranks for pcfg.n_devices="
                         f"{n_devices}")
    return group, dist.get_rank(group), tp_rank


def _check_faults(faults, reducer, pcfg, algorithm, algo):
    """The JAX Trainer's checks of `faults` and `reducer`; returns the
    reducer as a RobustConfig (None for the plain weighted mean)."""
    if isinstance(reducer, str):
        reducer = None if reducer == "mean" else RobustConfig(method=reducer)
    if reducer is not None and not isinstance(reducer, RobustConfig):
        raise ValueError(
            f"reducer must be 'mean', one of {ROBUST_METHODS}, or a "
            f"RobustConfig (got {reducer!r})")
    if algo.payload is None and (faults is not None or reducer is not None):
        raise ValueError(
            f"faults/reducer are not supported for algorithm "
            f"{algorithm!r} (no device uploads to corrupt or "
            f"robustly aggregate)")
    if faults is not None and not isinstance(faults,
                                             faults_lib.FaultConfig):
        raise ValueError(f"faults must be a FaultConfig (got {faults!r})")
    if faults is not None and faults.n_devices != pcfg.n_devices:
        raise ValueError(
            f"faults.n_devices={faults.n_devices} must match "
            f"pcfg.n_devices={pcfg.n_devices}")
    return reducer


class Trainer:
    """Runs the proposed protocol, FedGAN or the centralized baseline over
    a simulated device fleet on one device (CUDA unless `device` names
    another).

    init_fn(generator) -> {"gen", "disc"} builds the initial parameters.
    data_stacked: (K, n_k, ...) array of device shards, or a flat (N, ...)
    array with `partition=` ("iid" | "dirichlet").
    seed: seeds the initial parameters and every round's draws.
    faults: optional `faults.FaultConfig` (hostile workers); reducer:
    "mean", a robust method name or a `RobustConfig`.
    driver: "fused", "host" or "auto" (module docstring); the resolved
    driver is `self.driver`.
    layout: "stacked", or "mesh" inside a process group of
    pcfg.n_devices ranks (`group`, the default group when None), where
    the rank keeps its own row of `data_stacked` and its own optimizer
    states; avg_impl: the mesh layout's Algorithm-2 collective.
    tp: the mesh layout's model ranks a device (module docstring); at
    tp > 1 `group` defaults to the rank's data group.
    sampler: optional t -> `protocol.RoundDraws` replacing the seeded
    `protocol.DrawSampler` (tests feed the JAX package's draws).
    fid_fn(gen_params, generator) is called on evaluation rounds with a
    generator seeded from (seed, round).
    """

    def __init__(self, spec: protocol.GanModelSpec, pcfg: ProtocolConfig,
                 init_fn: Callable, data_stacked, seed: int = 0, *,
                 algorithm: str = "proposed",
                 channel_cfg: Optional[ChannelConfig] = None,
                 disc_step_flops: float = 1e9, gen_step_flops: float = 1e9,
                 driver: str = "auto", layout: str = "stacked", tp: int = 1,
                 faults=None, reducer=None, avg_impl: str = "pallas",
                 group=None,
                 partition: Optional[str] = None, labels=None,
                 partition_alpha: float = 0.5, partition_seed: int = 0,
                 sampler: Optional[Callable] = None, device=None):
        algo = _check_scope(algorithm, driver, layout, tp, pcfg)
        _check_spec_tp(spec, layout, tp)
        reducer = _check_faults(faults, reducer, pcfg, algorithm, algo)
        _check_avg_impl(avg_impl, layout, tp, faults, reducer)
        # "auto" as `repro.core.engine.Trainer` resolves it: fused where
        # the algorithm has a fused driver
        if driver == "auto":
            driver = "fused" if algo.rounds_fn is not None else "host"
        self.driver = driver
        self.layout, self.avg_impl, self.tp = layout, avg_impl, tp
        self.rank, self.tp_rank = None, 0
        if layout == "mesh":
            group, self.rank, self.tp_rank = _mesh_rank(
                group, pcfg.n_devices, tp)
        self.group = group
        self.device = resolve_device(device)
        if partition is not None:
            from repro_torch.data.partition import partition as partition_fn
            data_stacked = partition_fn(
                np.asarray(data_stacked), pcfg.n_devices, labels=labels,
                kind=partition, alpha=partition_alpha, seed=partition_seed)
        if len(data_stacked) != pcfg.n_devices:
            raise ValueError(f"data has {len(data_stacked)} shards for "
                             f"pcfg.n_devices={pcfg.n_devices}")
        if self.rank is not None:       # the mesh rank keeps its own shard
            data_stacked = data_stacked[self.rank]
        # Integer shards (token ids) stay integers, as in the JAX Trainer;
        # everything else is float32.
        data = torch.as_tensor(data_stacked)
        self.data = data.to(self.device, torch.int64
                            if not data.is_floating_point() else torch.float32)
        n_local = self.data.shape[0 if self.rank is not None else 1]
        draw_pcfg = pcfg
        if algo.pooled:
            # the centralized baseline: one worker on the shards pooled in
            # device order, drawing as one device over the pooled rows
            self.data = self.data.reshape((-1,) + self.data.shape[2:])
            n_local = self.data.shape[0]
            draw_pcfg = dataclasses.replace(pcfg, n_devices=1)

        self.spec, self.pcfg, self.seed = spec, pcfg, seed
        self.algorithm, self._algo = algorithm, algo
        self._fedgan = algo.fedgan
        self.faults, self.reducer = faults, reducer
        self._fault_prog = faults_lib.fault_program(faults)
        self.n_devices = pcfg.n_devices
        channel_cfg = channel_cfg or ChannelConfig(n_devices=pcfg.n_devices)
        self.channel = ChannelSimulator(channel_cfg)
        self.sched = SchedulerState(
            policy=pcfg.scheduler, n_devices=pcfg.n_devices,
            ratio=pcfg.scheduling_ratio)
        self.rng = np.random.default_rng(0)
        self.disc_step_flops = disc_step_flops
        self.gen_step_flops = gen_step_flops

        self._tp_ctx, self._tp_dims = None, None
        if self.rank is None:
            self._round_fn, self._rounds_fn = algo.round_fn, algo.rounds_fn
            self.state = algo.make_state(init_fn, pcfg, self.n_devices,
                                         seed=seed, device=self.device)
        else:
            # one worker's optimizer states, unstacked
            state = algo.make_state(init_fn, pcfg, 1, seed=seed,
                                    device=self.device)
            self.state = {k: tree_index(v, 0) if k in algo.stacked_keys
                          else v for k, v in state.items()}
            if tp > 1:
                # divisibility and the quantizer's shard dims are decided
                # on the global tree
                self._tp_ctx = shard_round.make_tp_ctx(algo.payload,
                                                       self.state, tp)
                self._tp_dims = {k: rules.tp_tree_dims(v, tp)
                                 for k, v in self.state.items()}
            self._round_fn, self._rounds_fn = (
                functools.partial(fn, group=group, avg_impl=avg_impl,
                                  tp_ctx=self._tp_ctx)
                for fn in (algo.mesh_round, algo.mesh_rounds))
        # The free-riders' stale-upload cache rides in the state.
        self.state = faults_lib.attach_fault_state(self.state, faults,
                                                   algo.payload)
        # the worker's global counts: the channel times whole models
        self._disc_nparams = protocol.count_params(self.state["disc"])
        self._gen_nparams = protocol.count_params(self.state["gen"])
        self._uplink_bits = protocol.uplink_payload_bits(
            self.state, pcfg, fedgan=self._fedgan)
        self._global_shapes = tree_map(lambda x: tuple(x.shape), self.state)
        if self._tp_dims is not None:
            self.state = self._shard(self.state)
        self.sampler = sampler or protocol.DrawSampler(
            spec, draw_pcfg, seed=seed, n_local=n_local,
            n_params=self._disc_nparams + (
                self._gen_nparams if self._fedgan else 0),
            device=self.device, faults=faults)
        if self.driver == "fused":
            self.device_channel = DeviceChannel(channel_cfg, self.device)
            self.device_sched = DeviceScheduler(
                policy=pcfg.scheduler, n_devices=pcfg.n_devices,
                ratio=pcfg.scheduling_ratio)
            self._sched_carry = self.device_sched.init_carry(self.device)
            # one captured graph for the Trainer's life: stacked on CUDA
            self._graph = graphs.RoundGraph(
                capture=self.device.type == "cuda" and self.rank is None)
        self.history: list[RoundRecord] = []
        self._clock = 0.0
        self._round_index = 0

    def run(self, n_rounds: int, *, eval_every: int = 0,
            fid_fn: Optional[Callable] = None, verbose: bool = False):
        """Run `n_rounds` rounds with the Trainer's driver; returns the
        history. fid_fn(gen_params, generator) runs on rounds t with
        (t + 1) % eval_every == 0, with a generator seeded from (seed,
        STREAM_FID, t)."""
        run = self._run_fused if self.driver == "fused" else self._run_host
        return run(n_rounds, eval_every=eval_every, fid_fn=fid_fn,
                   verbose=verbose)

    def _shard(self, state):
        """This model rank's shards of a global state (tp > 1)."""
        return {k: rules.shard_tree(v, self.tp, self.tp_rank,
                                    self._tp_dims[k])
                for k, v in state.items()}

    def _unshard(self, state):
        """The global state from every model rank's shards (collective
        over the model group; the state itself at tp=1)."""
        if self._tp_dims is None:
            return state
        return {k: rules.gather_tree(v, self._tp_dims[k], "model")
                for k, v in state.items()}

    def _fid(self, fid_fn, eval_every, t):
        if fid_fn is None or not eval_every or (t + 1) % eval_every:
            return None
        gen = (self.state["gen"] if self._tp_dims is None else
               rules.gather_tree(self.state["gen"], self._tp_dims["gen"],
                                 "model"))
        return float(fid_fn(gen, protocol.seeded_generator(
            self.seed, protocol.STREAM_FID, t, self.device)))

    # ------------------------------------------------------------------
    # fused driver: Step 1 on the device, a captured graph a round
    # ------------------------------------------------------------------
    def _eval_boundaries(self, n_rounds: int, eval_every: int,
                         have_fid: bool):
        """Chunk lengths whose boundaries land on the FID rounds (the
        JAX package's path for a fid_fn it cannot trace)."""
        if not (have_fid and eval_every):
            return [n_rounds] if n_rounds else []
        chunks, done = [], 0
        start = self._round_index
        while done < n_rounds:
            # next multiple of eval_every past the current absolute round
            nxt = ((start + done) // eval_every + 1) * eval_every
            chunks.append(min(nxt - (start + done), n_rounds - done))
            done += chunks[-1]
        return chunks

    def _run_fused(self, n_rounds: int, *, eval_every: int,
                   fid_fn: Optional[Callable], verbose: bool):
        for chunk in self._eval_boundaries(n_rounds, eval_every,
                                           fid_fn is not None):
            start = self._round_index
            self.state, self._sched_carry, out = self._rounds_fn(
                self.spec, self.pcfg, self.state, self.data, chunk,
                channel=self.device_channel, scheduler=self.device_sched,
                sampler=self.sampler, seed=self.seed,
                sched_carry=self._sched_carry, start_round=start,
                disc_step_flops=self.disc_step_flops,
                gen_step_flops=self.gen_step_flops,
                uplink_bits=self._uplink_bits,
                disc_nparams=self._disc_nparams,
                gen_nparams=self._gen_nparams, faults=self.faults,
                reducer=self.reducer, graph=self._graph)
            for i in range(chunk):
                t = start + i
                wall = float(out["wallclock_s"][i])
                self._clock += wall
                rec = RoundRecord(
                    t, wall, self._clock,
                    {k: float(v[i]) for k, v in out["metrics"].items()},
                    self._fid(fid_fn, eval_every, t),
                    mask=out["mask"][i].copy(),
                    weights=out["weights"][i].copy())
                self.history.append(rec)
                if verbose:
                    self._print_record(rec)
            self._round_index += chunk
        return self.history

    # ------------------------------------------------------------------
    # host driver: one round a call (the oracle)
    # ------------------------------------------------------------------
    def schedule(self, draws: protocol.RoundDraws):
        """Step 1 of the next round, on the host (numpy): the channel
        state, the scheduling mask, the round's timing and Algorithm 2's
        weights. Fault dropout knocks scheduled devices out BEFORE timing,
        from the round's host uniforms; stragglers and free-riders scale
        the local compute time. Advances the channel and scheduler state;
        `run` calls it once a round. Returns (mask, weights, timing)."""
        pcfg = self.pcfg
        rates = self.channel.uplink_rates(self.sched.n_scheduled)
        mask = schedule_round(self.sched, rates, self.rng)
        compute_mult = None
        if self._fault_prog is not None:
            mask = mask & ~self._fault_prog.dropout_mask(draws.drop_u)
            compute_mult = self._fault_prog.compute_mult_np
        timing = self.channel.round_timing(
            mask=mask, disc_params=self._disc_nparams,
            gen_params=self._gen_nparams,
            disc_step_flops=self.disc_step_flops,
            gen_step_flops=self.gen_step_flops,
            n_d=pcfg.n_d, n_g=pcfg.n_g, fedgan=self._fedgan,
            uplink_bits=self._uplink_bits, compute_mult=compute_mult)
        active = mask & ~timing.stragglers
        weights = np.where(active, float(pcfg.sample_size),
                           0.0).astype(np.float32)
        return mask, weights, timing

    def _run_host(self, n_rounds: int, *, eval_every: int,
                  fid_fn: Optional[Callable], verbose: bool):
        pcfg = self.pcfg
        for _ in range(n_rounds):
            t = self._round_index
            draws = self.sampler(t)
            mask, weights, timing = self.schedule(draws)

            # Steps 2-5 on the device; a mesh rank passes its own weight.
            w = torch.from_numpy(weights).to(self.device)
            self.state, metrics = self._round_fn(
                self.spec, pcfg, self.state, self.data,
                w if self.rank is None else w[self.rank], draws,
                faults=self.faults, reducer=self.reducer)

            wall = round_wallclock(timing, mask, schedule=pcfg.schedule,
                                   fedgan=self._fedgan)
            self._clock += wall
            rec = RoundRecord(t, wall, self._clock,
                              {k: float(v) for k, v in metrics.items()},
                              self._fid(fid_fn, eval_every, t),
                              mask=mask.copy(), weights=weights)
            self.history.append(rec)
            self._round_index += 1
            if verbose:
                self._print_record(rec)
        return self.history

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def _global_state(self):
        """The state as the stacked layout holds it: on a mesh rank, the
        shards gathered over the model group (tp > 1), then the ranks'
        own optimizer states gathered into (K, ...) trees."""
        if self.rank is None:
            return self.state
        return {k: tree_map(lambda x: mesh.all_gather(x, self.group), v)
                if k in self._algo.stacked_keys else v
                for k, v in self._unshard(self.state).items()}

    def save_checkpoint(self, directory: str):
        """Write the state with the round index, the clock and the
        scheduler carry as checkpoint `round_index` of `directory`
        (module docstring); returns its path. On the mesh layout every
        rank takes part, rank 0 writes and returns the path, the other
        ranks return None once it is written."""
        carry = (self._sched_carry if self.driver == "fused" else
                 {"rr_cursor": np.int32(self.sched.rr_cursor),
                  # float64: the numpy EWMA must resume exactly
                  "ewma_rate": np.asarray(self.sched.ewma_rate)})
        tree = {"state": self._global_state(),
                "trainer": {"round_index": np.int64(self._round_index),
                            "clock": np.float64(self._clock),
                            "sched_carry": carry}}
        meta = {"algorithm": self.algorithm, "layout": self.layout,
                "driver": self.driver}
        path = None
        if self.rank in (None, 0) and self.tp_rank == 0:
            path = checkpoint.save_checkpoint(directory, self._round_index,
                                              tree, metadata=meta)
        if self.tp > 1:
            # worker 0's model group, then every data group: each rank
            # waits for rank (0, 0)'s write
            dist.barrier(mesh.axis_group("model"))
        if self.rank is not None:
            dist.barrier(self.group)    # written before any rank goes on
        return path

    def restore(self, directory: str, step: Optional[int] = None):
        """Load a checkpoint of `save_checkpoint`, the port's or the JAX
        package's (the latest when `step` is None), and position the
        Trainer to continue from it; returns its step. The state's
        structure must match the Trainer's; each leaf takes the
        Trainer's dtype and device. A bound round graph keeps its
        static tensors and receives the restored values."""
        tree, step, _ = checkpoint.load_checkpoint(directory, step)
        keys = self._algo.stacked_keys if self.rank is not None else ()
        state = {k: tree_index(v, self.rank) if k in keys else v
                 for k, v in tree["state"].items()}

        def leaf(ref, shape, x):
            if tuple(x.shape) != shape:
                raise ValueError(f"a leaf of shape {tuple(x.shape)} for "
                                 f"{shape}")
            return torch.as_tensor(x).to(ref.device, ref.dtype)

        try:
            state = tree_map(leaf, self.state, self._global_shapes, state)
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"the checkpoint's state does not fit this "
                             f"Trainer's: {err!r}") from err
        if self._tp_dims is not None:
            state = self._shard(state)
        if len(tree_leaves(state)) != len(tree_leaves(tree["state"])):
            raise ValueError("the checkpoint's state holds entries this "
                             "Trainer's does not")
        extra = tree["trainer"]
        carry = extra["sched_carry"]
        if self.driver == "fused":
            carry = {"rr_cursor": torch.as_tensor(
                         np.asarray(carry["rr_cursor"], np.int32),
                         device=self.device),
                     "ewma_rate": torch.as_tensor(
                         np.asarray(carry["ewma_rate"], np.float32),
                         device=self.device)}
            if self._graph.bound:
                # a captured graph replays kernels on these addresses
                graphs.copy_into((self._graph.state, self._graph.carry),
                                 (state, carry))
                state, carry = self._graph.state, self._graph.carry
            self._sched_carry = carry
        else:
            self.sched.rr_cursor = int(carry["rr_cursor"])
            self.sched.ewma_rate = np.asarray(carry["ewma_rate"],
                                              np.float64)
        self.state = state
        self._round_index = int(extra["round_index"])
        self._clock = float(extra["clock"])
        return step

    @staticmethod
    def _print_record(rec: RoundRecord):
        msg = (f"round {rec.round:4d}  t={rec.cumulative_s:9.2f}s  "
               f"D={rec.metrics.get('disc_objective', float('nan')):+.4f}")
        if rec.fid is not None:
            msg += f"  FID={rec.fid:8.2f}"
        print(msg)
