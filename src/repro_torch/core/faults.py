"""Hostile-worker fault injection. Port of `repro.core.faults`.

A `FaultConfig` describes a worker population, a `FaultProgram` realizes
it:

  * STATIC ROLES — which workers are free-riders or byzantine, and each
    worker's compute slowdown, are drawn ONCE on the host from
    `numpy.default_rng(cfg.seed)` in the JAX package's order (one
    permutation, then one uniform draw), so the roles match it bit for
    bit. A compromised device stays compromised.
  * PER-ROUND REALIZATIONS enter as explicit draws (`protocol.RoundDraws`):
    the dropout uniforms (K,) are a host numpy array, so the host
    driver knows the dropout mask before channel timing with no device
    sync (the fused driver copies them into a device slot and takes
    `dropout_mask_device`); the byzantine normals are drawn on the
    device, one row per byzantine worker. Tests pass the JAX package's
    own draws instead.

Fault axes:

  dropout_prob     — per-round iid worker dropout, applied to the
                     scheduling mask BEFORE channel timing.
  straggler_factor — worker k's local compute time is multiplied by
                     slowdown_k ~ U[1, factor] (`compute_mult`, fed to
                     `channel.round_timing`).
  n_free_riders    — workers that upload a STALE copy of the global
                     model (the round-start global cached in
                     `state["fault"]["stale"]`); they spend no compute
                     (compute_mult 0).
  n_byzantine      — workers that upload `byz_scale` x N(0, 1) noise:
                     one flat draw over the payload in `repro_torch.tree`
                     leaf order, sliced per leaf.

Free-rider and byzantine roles are disjoint. Counter the corruption with
the robust reducers (`repro_torch.kernels.robust_avg`) through
`Trainer(reducer=...)`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Hostile-worker population description."""
    n_devices: int
    dropout_prob: float = 0.0
    n_free_riders: int = 0
    n_byzantine: int = 0
    byz_scale: float = 10.0
    straggler_factor: float = 1.0
    seed: int = 0

    def __post_init__(self):
        # dropout_prob=1.0 is legal: every round is a no-survivor round
        # and the globals stay frozen (averaging's fallback).
        if not 0.0 <= self.dropout_prob <= 1.0:
            raise ValueError(
                f"dropout_prob must be in [0, 1] (got {self.dropout_prob})")
        if self.n_free_riders < 0 or self.n_byzantine < 0:
            raise ValueError("n_free_riders/n_byzantine must be >= 0")
        if self.n_free_riders + self.n_byzantine > self.n_devices:
            raise ValueError(
                f"{self.n_free_riders} free-riders + {self.n_byzantine} "
                f"byzantine workers exceed n_devices={self.n_devices}")
        if self.straggler_factor < 1.0:
            raise ValueError(
                f"straggler_factor must be >= 1 (got "
                f"{self.straggler_factor}) — it multiplies compute time")

    @property
    def corrupts_uploads(self) -> bool:
        return self.n_free_riders > 0 or self.n_byzantine > 0


class DeviceRoles(NamedTuple):
    """A program's static roles as tensors on one device."""
    compute_mult: torch.Tensor      # (K,) float32
    free_rider_rows: torch.Tensor   # int64 device indices
    byzantine_rows: torch.Tensor    # int64 device indices


class FaultProgram:
    """Realized fault program: static role arrays (numpy, host) and the
    per-round realizations of the round's draws. Build it through
    `fault_program(cfg)` (memoized)."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(cfg.n_devices)
        free_rider = np.zeros(cfg.n_devices, bool)
        free_rider[perm[:cfg.n_free_riders]] = True
        byzantine = np.zeros(cfg.n_devices, bool)
        byzantine[perm[cfg.n_free_riders:
                       cfg.n_free_riders + cfg.n_byzantine]] = True
        slowdown = rng.uniform(1.0, cfg.straggler_factor,
                               cfg.n_devices) if cfg.straggler_factor > 1.0 \
            else np.ones(cfg.n_devices)
        # free-riders train nothing: zero local compute time
        compute_mult = np.where(free_rider, 0.0, slowdown)

        self.free_rider_np = free_rider
        self.byzantine_np = byzantine
        self.compute_mult_np = compute_mult.astype(np.float64)
        self.free_rider_idx = np.flatnonzero(free_rider).tolist()
        self.byzantine_idx = np.flatnonzero(byzantine).tolist()
        self._roles: dict = {}

    def roles_on(self, device) -> DeviceRoles:
        """The static roles as tensors on `device`, copied there once: a
        captured round reads them and copies nothing from the host."""
        device = torch.device(device)
        roles = self._roles.get(device)
        if roles is None:
            rows = lambda idx: torch.tensor(idx, dtype=torch.int64,
                                            device=device)
            roles = self._roles[device] = DeviceRoles(
                torch.tensor(self.compute_mult_np, dtype=torch.float32,
                             device=device),
                rows(self.free_rider_idx), rows(self.byzantine_idx))
        return roles

    @property
    def corrupts(self) -> bool:
        return self.cfg.corrupts_uploads

    def dropout_mask(self, drop_u) -> np.ndarray:
        """(K,) bool — True where the worker DROPS this round, from the
        round's host uniforms `drop_u` (K,)."""
        if self.cfg.dropout_prob <= 0.0:
            return np.zeros(self.cfg.n_devices, bool)
        if drop_u is None or np.shape(drop_u) != (self.cfg.n_devices,):
            raise ValueError(f"dropout_prob={self.cfg.dropout_prob} needs "
                             f"the round's ({self.cfg.n_devices},) dropout "
                             f"uniforms")
        # compared in float32, as the JAX package compares its draw
        return (np.asarray(drop_u, np.float32)
                < np.float32(self.cfg.dropout_prob))

    def dropout_mask_device(self, drop_u):
        """`dropout_mask` on the device, from the round's (K,) float32
        uniforms `drop_u` (a tensor; None without dropout), compared in
        float32. The counterpart of the JAX package's
        `FaultProgram.dropout_mask`, which draws its own uniforms."""
        if self.cfg.dropout_prob <= 0.0:
            return None
        if drop_u is None or tuple(drop_u.shape) != (self.cfg.n_devices,):
            raise ValueError(f"dropout_prob={self.cfg.dropout_prob} needs "
                             f"the round's ({self.cfg.n_devices},) dropout "
                             f"uniforms")
        return drop_u.float() < float(np.float32(self.cfg.dropout_prob))


def byzantine_noise(normals, payload, scale: float):
    """Scaled-Gaussian forged payload with the structure of `payload`
    (one device's tree): `normals` (..., N) is ONE flat standard-normal
    draw over the payload in leaf order per leading index, sliced per
    leaf, times `scale` in float32. Leaves get the leading shape."""
    flat = normals.float() * scale
    lead = tuple(normals.shape[:-1])
    out, off = [], 0
    for x in tree_leaves(payload):
        out.append(flat[..., off:off + x.numel()].reshape(lead + x.shape)
                   .to(x.dtype))
        off += x.numel()
    return tree_unflatten(payload, out)


def _check_byz_normals(cfg: FaultConfig, payload, byz_normals):
    """The byzantine devices' normals must cover one device's payload."""
    n = sum(x.numel() for x in tree_leaves(payload))
    if byz_normals is None or tuple(byz_normals.shape) != (cfg.n_byzantine,
                                                           n):
        raise ValueError(
            f"{cfg.n_byzantine} byzantine devices need "
            f"({cfg.n_byzantine}, {n}) normals for their payload; got "
            f"{None if byz_normals is None else tuple(byz_normals.shape)}")


def corrupt_upload(prog: FaultProgram, payload_stacked, byz_normals,
                   stale=None):
    """The devices' ACTUAL uploads under the fault program, for a payload
    tree with leading device axis K: free-riders' rows replaced by the
    UNSTACKED `stale` cached global, byzantine rows by scaled noise.
    `byz_normals` is (n_byzantine, N), row i for the i-th byzantine
    device in index order. The roles are host constants, so the rows
    are picked by index tensors kept on the device (`roles_on`), with
    no device sync."""
    cfg = prog.cfg
    roles = prog.roles_on(tree_leaves(payload_stacked)[0].device)
    replace = []                  # (device rows, their leaves' values)
    if cfg.n_free_riders > 0 and stale is not None:
        replace.append((roles.free_rider_rows, stale))
    if cfg.n_byzantine > 0:
        one = tree_map(lambda x: x[0], payload_stacked)
        _check_byz_normals(cfg, one, byz_normals)
        replace.append((roles.byzantine_rows,
                        byzantine_noise(byz_normals, one, cfg.byz_scale)))
    if not replace:
        return payload_stacked

    def corrupt_leaf(x, *rows):
        x = x.clone()
        for (idx, _), row in zip(replace, rows):
            x[idx] = row.to(x.dtype)
        return x

    return tree_map(corrupt_leaf, payload_stacked, *(t for _, t in replace))


def corrupt_upload_rank(prog: FaultProgram, rank: int, payload,
                        byz_normals, stale=None):
    """Worker `rank`'s ACTUAL upload under the fault program, for its own
    (unstacked) payload tree: the mesh layout's per-rank form of
    `corrupt_upload`, with the same values. A free-rider uploads the
    `stale` cached global, a byzantine worker its row of `byz_normals`
    (n_byzantine, N) as scaled noise; everyone else `payload`."""
    cfg = prog.cfg
    if cfg.n_byzantine > 0:
        _check_byz_normals(cfg, payload, byz_normals)
    if cfg.n_free_riders > 0 and stale is not None \
            and prog.free_rider_np[rank]:
        return tree_map(lambda p, s: s.to(p.dtype), payload, stale)
    if prog.byzantine_np[rank]:
        row = prog.byzantine_idx.index(rank)
        return byzantine_noise(byz_normals[row], payload, cfg.byz_scale)
    return payload


def attach_fault_state(state, faults: FaultConfig | None, payload_fn):
    """Seed the stale-upload cache into a fresh training state when the
    fault program has free-riders: `state["fault"]["stale"]` holds a COPY
    of the round-start global payload (`payload_fn(state)`)."""
    if faults is None or faults.n_free_riders == 0 or payload_fn is None:
        return state
    state = dict(state)
    state["fault"] = {"stale": tree_map(torch.clone, payload_fn(state))}
    return state


# FaultConfig -> FaultProgram memo.
_PROGRAMS: dict = {}


def fault_program(cfg: FaultConfig | None) -> FaultProgram | None:
    if cfg is None:
        return None
    prog = _PROGRAMS.get(cfg)
    if prog is None:
        prog = _PROGRAMS[cfg] = FaultProgram(cfg)
    return prog
