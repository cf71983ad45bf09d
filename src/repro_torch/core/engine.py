"""Training engine: drives communication rounds with device scheduling,
the wireless channel simulator, wall-clock accounting, and periodic
evaluation — the paper's experimental harness (Figs 3-6).

Port of `repro.core.engine.Trainer` for the slices that run on one
GPU: algorithms "proposed" and "fedgan", layout "stacked" (the K
devices stacked on one card) and the host driver (one round per call,
numpy scheduling and channel state, as in the JAX package's host
driver, whose masks, weights and wallclock this one matches bit for
bit), with the hostile-worker regime: fault programs (`faults=`) and
robust reducers (`reducer=`). Every other choice of the JAX Trainer —
the centralized baseline, the fused driver, the mesh layout, tensor
parallelism, microbatching — raises a ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import faults as faults_lib
from repro_torch.core import fedgan, protocol
from repro_torch.core.channel import (ChannelConfig, ChannelSimulator,
                                      round_wallclock)
from repro_torch.core.scheduling import SchedulerState, schedule_round
from repro_torch.device import resolve_device
from repro_torch.kernels.robust_avg.ops import ROBUST_METHODS, RobustConfig

ALGORITHMS = ("proposed", "fedgan")


@dataclasses.dataclass
class RoundRecord:
    round: int
    wallclock_s: float
    cumulative_s: float
    metrics: dict
    fid: Optional[float] = None
    mask: Optional[np.ndarray] = None      # (K,) bool — scheduled devices
    weights: Optional[np.ndarray] = None   # (K,) float32 — Algorithm 2's


def _check_scope(algorithm, driver, layout, tp, pcfg):
    """Refuse what this port does not run yet, instead of degrading."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm={algorithm!r} is not ported; the "
                         f"port runs {ALGORITHMS}")
    if driver not in ("auto", "host"):
        raise ValueError(f"driver={driver!r} is not ported; the port "
                         f"runs the host driver ('host' or 'auto')")
    if layout != "stacked":
        raise ValueError(f"layout={layout!r} is not ported; the port "
                         f"runs layout='stacked'")
    if tp != 1:
        raise ValueError(f"tp={tp} is not ported; the port runs tp=1")
    if pcfg.micro_batch_d is not None or pcfg.micro_batch_g is not None:
        raise ValueError("micro_batch_d/micro_batch_g are not ported; "
                         "leave them None")


def _check_faults(faults, reducer, pcfg):
    """The JAX Trainer's checks of `faults` and `reducer`; returns the
    reducer as a RobustConfig (None for the plain weighted mean)."""
    if isinstance(reducer, str):
        reducer = None if reducer == "mean" else RobustConfig(method=reducer)
    if reducer is not None and not isinstance(reducer, RobustConfig):
        raise ValueError(
            f"reducer must be 'mean', one of {ROBUST_METHODS}, or a "
            f"RobustConfig (got {reducer!r})")
    if faults is not None and not isinstance(faults,
                                             faults_lib.FaultConfig):
        raise ValueError(f"faults must be a FaultConfig (got {faults!r})")
    if faults is not None and faults.n_devices != pcfg.n_devices:
        raise ValueError(
            f"faults.n_devices={faults.n_devices} must match "
            f"pcfg.n_devices={pcfg.n_devices}")
    return reducer


class Trainer:
    """Runs the proposed protocol or FedGAN over a simulated device fleet
    on one device (CUDA unless `device` names another).

    init_fn(generator) -> {"gen", "disc"} builds the initial parameters.
    data_stacked: (K, n_k, ...) array of device shards, or a flat (N, ...)
    array with `partition=` ("iid" | "dirichlet").
    seed: seeds the initial parameters and every round's draws.
    faults: optional `faults.FaultConfig` (hostile workers); reducer:
    "mean", a robust method name or a `RobustConfig`.
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
                 faults=None, reducer=None,
                 partition: Optional[str] = None, labels=None,
                 partition_alpha: float = 0.5, partition_seed: int = 0,
                 sampler: Optional[Callable] = None, device=None):
        _check_scope(algorithm, driver, layout, tp, pcfg)
        reducer = _check_faults(faults, reducer, pcfg)
        self.device = resolve_device(device)
        if partition is not None:
            from repro_torch.data.partition import partition as partition_fn
            data_stacked = partition_fn(
                np.asarray(data_stacked), pcfg.n_devices, labels=labels,
                kind=partition, alpha=partition_alpha, seed=partition_seed)
        # Integer shards (token ids) stay integers, as in the JAX Trainer;
        # everything else is float32.
        data = torch.as_tensor(data_stacked)
        self.data = data.to(self.device, torch.int64
                            if not data.is_floating_point() else torch.float32)
        if self.data.shape[0] != pcfg.n_devices:
            raise ValueError(f"data has {self.data.shape[0]} shards for "
                             f"pcfg.n_devices={pcfg.n_devices}")

        self.spec, self.pcfg, self.seed = spec, pcfg, seed
        self.algorithm = algorithm
        self._fedgan = algorithm == "fedgan"
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

        make_state, payload_fn, self._round_fn = (
            (fedgan.make_fedgan_state,
             lambda st: {"gen": st["gen"], "disc": st["disc"]},
             fedgan.fedgan_round) if self._fedgan else
            (protocol.make_train_state, lambda st: st["disc"],
             protocol.gan_round))
        self.state = make_state(init_fn, pcfg, self.n_devices, seed=seed,
                                device=self.device)
        # The free-riders' stale-upload cache rides in the state.
        self.state = faults_lib.attach_fault_state(self.state, faults,
                                                   payload_fn)
        self._disc_nparams = protocol.count_params(self.state["disc"])
        self._gen_nparams = protocol.count_params(self.state["gen"])
        self._uplink_bits = protocol.uplink_payload_bits(
            self.state, pcfg, fedgan=self._fedgan)
        self.sampler = sampler or protocol.DrawSampler(
            spec, pcfg, seed=seed, n_local=self.data.shape[1],
            n_params=self._disc_nparams + (
                self._gen_nparams if self._fedgan else 0),
            device=self.device, faults=faults)
        self.history: list[RoundRecord] = []
        self._clock = 0.0
        self._round_index = 0

    def run(self, n_rounds: int, *, eval_every: int = 0,
            fid_fn: Optional[Callable] = None, verbose: bool = False):
        """Run `n_rounds` rounds, one at a time (the host driver)."""
        pcfg = self.pcfg
        for _ in range(n_rounds):
            t = self._round_index
            draws = self.sampler(t)

            # Step 1: schedule + channel state (numpy, host). Fault
            # dropout knocks scheduled devices out BEFORE timing, from
            # the round's host uniforms; stragglers and free-riders scale
            # the local compute time.
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

            # Steps 2-5 on the device.
            self.state, metrics = self._round_fn(
                self.spec, pcfg, self.state, self.data,
                torch.from_numpy(weights).to(self.device), draws,
                faults=self.faults, reducer=self.reducer)

            wall = round_wallclock(timing, mask, schedule=pcfg.schedule,
                                   fedgan=self._fedgan)
            self._clock += wall
            fid = None
            if fid_fn is not None and eval_every and (t + 1) % eval_every == 0:
                fid = float(fid_fn(self.state["gen"],
                                   protocol.seeded_generator(
                                       self.seed, protocol.STREAM_FID, t,
                                       self.device)))
            rec = RoundRecord(t, wall, self._clock,
                              {k: float(v) for k, v in metrics.items()}, fid,
                              mask=mask.copy(), weights=weights)
            self.history.append(rec)
            self._round_index += 1
            if verbose:
                self._print_record(rec)
        return self.history

    @staticmethod
    def _print_record(rec: RoundRecord):
        msg = (f"round {rec.round:4d}  t={rec.cumulative_s:9.2f}s  "
               f"D={rec.metrics.get('disc_objective', float('nan')):+.4f}")
        if rec.fid is not None:
            msg += f"  FID={rec.fid:8.2f}"
        print(msg)
