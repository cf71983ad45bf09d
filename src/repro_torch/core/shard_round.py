"""The mesh layout: every paper worker is one rank of a
`torch.distributed` process group, or, under tensor parallelism, one
model group of tp ranks. Port of `repro.core.shard_round`.

A rank runs its own Algorithm 1 on its own data shard, its own slice of
the uplink, the Algorithm-2 collective over the group
(`averaging.weighted_average_psum`: "jnp", "pallas" or "ring"), and the
replicated Algorithm 3: every rank takes the round's whole `RoundDraws`
and computes the same server update from the same averaged
discriminator, so the global parameters agree on every rank with no
broadcast. The host drives scheduling and passes each rank its own
weight, as the JAX package's single-round oracles take theirs.

A rank's state is {"gen", "disc", "gen_opt", "disc_opt"} with ITS own
disc_opt (FedGAN: its own gen_opt too), unstacked, and an optional
replicated "fault" entry: the free-riders' stale cache.

TENSOR PARALLELISM (`tp_ctx`, a `TpCtx`): worker k is the model group
of ranks (k, 0..tp-1) (`launch.mesh.spawn(..., tp=)`). The TP-named
leaves (`sharding.rules.tp_leaf_dim`) are the rank's shards, and the
spec (built with tp_axis="model") runs the Megatron feed-forward over
the model group, while everything the paper defines over workers
(weights, the uplink's draws, the Algorithm-2 reduction) stays on the
DATA group (`group`): every rank of worker k takes worker k's data,
noise and draws, and averages just its shard, so the Algorithm-2
all-gather is 1/tp of the model. The uplink quantizer rebuilds the
worker's global draw and scale a shard (`quantize.roundtrip_tp`), so
tp=2 quantizes bit for bit like tp=1 given the same values. Faults,
robust reducers and the ring stay tp=1 only, as in the JAX package.

Two entry points a round: `mesh_round` (the proposed protocol, the
counterpart of `shard_round.shard_map_round`) and `fedgan_mesh_round`
(FedGAN, the counterpart of `shard_round.fedgan_shard_map_round`). Two
for the fused driver: `mesh_rounds` and `fedgan_mesh_rounds` (the
counterparts of `shard_rounds_scan` and `fedgan_shard_rounds_scan`),
where every rank runs Step 1 on its device from the same slots
(`protocol.rounds`), so the masks agree on every rank and with the
stacked fused driver, with no collective. These rounds run eagerly,
never as a captured CUDA graph: the gloo collectives go through the
host (NCCL across cards, which a graph could capture, needs a machine
with several).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import faults as faults_lib
from repro_torch.core import fedgan as fedgan_mod
from repro_torch.core import protocol, quantize
from repro_torch.core.averaging import weighted_average_psum
from repro_torch.launch import mesh
from repro_torch.sharding import rules
from repro_torch.tree import tree_index, tree_map

# Per-algorithm mesh conventions: the state entries a rank keeps for
# itself (stacked K on the stacked layout), the metric names of the
# round (those of the stacked round functions), and the uplink payload.
PROPOSED_STACKED_KEYS = ("disc_opt",)
PROPOSED_METRICS = ("disc_objective", "gen_objective", "participation")
PROPOSED_PAYLOAD = lambda state: state["disc"]
FEDGAN_STACKED_KEYS = ("gen_opt", "disc_opt")
FEDGAN_METRICS = ("participation",)
FEDGAN_PAYLOAD = lambda state: {"gen": state["gen"],
                                "disc": state["disc"]}


@dataclasses.dataclass(frozen=True)
class TpCtx:
    """The tensor-parallel context of the slice rounds: the model axis
    ("model", or a process group), its size, and the uplink payload's
    per-leaf shard dims (`tree_leaves` order, from
    `sharding.rules.tp_tree_dims` on the GLOBAL payload)."""
    axis: object
    size: int
    payload_dims: tuple


def make_tp_ctx(payload_fn, global_state, tp: int):
    """The TpCtx of `global_state` over the "model" group (divisibility
    decided on the global dims), or None at tp=1."""
    if tp <= 1:
        return None
    return TpCtx("model", tp,
                 rules.tp_tree_dims(payload_fn(global_state), tp))


def _uplink_uniforms(pcfg: ProtocolConfig, draws, my_index):
    """This worker's row of the round's quantizer uniforms."""
    return draws.quant_u[my_index] if pcfg.quantize_bits < 32 else None


def _quantize_uplink(tp_ctx, uniforms, payload, bits: int):
    """The Step-3 quantizer, per TP regime: the worker's row at tp=1, the
    row rebuilt a shard under TP (bit for bit the same given the same
    values)."""
    if tp_ctx is None:
        return quantize.roundtrip(uniforms, payload, bits)
    return quantize.roundtrip_tp(uniforms, payload, bits,
                                 tp_axis=tp_ctx.axis, tp=tp_ctx.size,
                                 shard_dims=tp_ctx.payload_dims)


def _flat_uplink(pcfg, faults, my_index, payload, draws, st, tp_ctx):
    """Step 3 on the flat path: the quantized uplink (keyed by this
    worker's row of the uniforms, as the stacked `roundtrip_stacked`),
    then the fault program's corruption of this worker's upload."""
    payload = _quantize_uplink(tp_ctx,
                               _uplink_uniforms(pcfg, draws, my_index),
                               payload, pcfg.quantize_bits)
    prog = faults_lib.fault_program(faults)
    if prog is not None and prog.corrupts:
        stale = st["fault"]["stale"] if "fault" in st else None
        payload = faults_lib.corrupt_upload_rank(
            prog, my_index, payload, draws.byz_normals, stale=stale)
    return payload


def _average(pcfg, group, faults, robust, avg_impl, tp_ctx, my_index,
             payload, w_k, weights, draws, st, prev):
    """Steps 3-4 of one worker: the uplink and the Algorithm-2 collective
    over the data group (given the round's gathered `weights`, so it
    gathers none). The ring quantizes inside the collective (the payload
    travels encoded); the flat paths quantize and corrupt first. Under
    TP the payload is this rank's shards."""
    if avg_impl == "ring":
        return weighted_average_psum(
            payload, w_k, group=group, impl="ring",
            uniforms=_uplink_uniforms(pcfg, draws, my_index),
            quantize_bits=pcfg.quantize_bits, fallback=prev,
            weights=weights)
    payload = _flat_uplink(pcfg, faults, my_index, payload, draws, st,
                           tp_ctx)
    return weighted_average_psum(payload, w_k, group=group, impl=avg_impl,
                                 robust=robust, fallback=prev,
                                 weights=weights)


# ---------------------------------------------------------------------------
# Per-rank round bodies (Steps 2-5, one algorithm each)
# ---------------------------------------------------------------------------

def _proposed_slice_round(spec, pcfg: ProtocolConfig, group, faults,
                          robust, avg_impl: str, tp_ctx, my_index, st,
                          data_k, w_k, weights, weight_sum, draws):
    """The proposed protocol's Steps 2-5 as seen by ONE rank: Algorithm 1
    on its shard (its row of the round's sample indices), its quantized
    uplink, Algorithm 2 over the group, the replicated Algorithm 3.
    Returns (new_st, metrics)."""
    one = dataclasses.replace(draws, idx=draws.idx[:, my_index:my_index + 1])
    discs, opts, objs = protocol.devices_update(
        spec, pcfg, st["gen"], st["disc"],
        tree_map(lambda x: x[None], st["disc_opt"]), data_k[None], one)
    disc_k, disc_opt_k = tree_index(discs, 0), tree_index(opts, 0)

    disc_avg = _average(pcfg, group, faults, robust, avg_impl, tp_ctx,
                        my_index, disc_k, w_k, weights, draws, st,
                        st["disc"])

    disc_for_gen = disc_avg if pcfg.schedule == "serial" else st["disc"]
    gen, gen_opt, gen_obj = protocol.server_update(
        spec, pcfg, st["gen"], st["gen_opt"], disc_for_gen, draws)

    w = w_k.float()
    wsum = torch.clamp(weight_sum, min=1e-12)
    metrics = {
        "disc_objective": mesh.all_reduce_sum(objs[0] * w, group) / wsum,
        "gen_objective": gen_obj,
        "participation": (weights > 0).float().mean(),
    }
    new_st = {"gen": gen, "disc": disc_avg, "gen_opt": gen_opt,
              "disc_opt": disc_opt_k}
    if "fault" in st:
        new_st["fault"] = {"stale": st["disc"]}
    return new_st, metrics


def _fedgan_slice_round(spec, pcfg: ProtocolConfig, group, faults, robust,
                        avg_impl: str, tp_ctx, my_index, st, data_k, w_k,
                        weights, weight_sum, draws):
    """One FedGAN round as seen by ONE rank: n_d local (disc, gen)
    iteration pairs on its shard, then the averaging of BOTH nets as ONE
    two-net payload ({"gen", "disc"}, quantized as one tree with this
    worker's uniforms, as the stacked round) in one collective."""
    gen_k, disc_k, gen_opt_k, disc_opt_k = fedgan_mod.fedgan_device_update(
        spec, pcfg, st["gen"], st["disc"], st["gen_opt"], st["disc_opt"],
        data_k, draws.z_dev, draws.idx[:, my_index])
    prev = {"gen": st["gen"], "disc": st["disc"]}
    avg = _average(pcfg, group, faults, robust, avg_impl, tp_ctx, my_index,
                   {"gen": gen_k, "disc": disc_k}, w_k, weights, draws, st,
                   prev)
    new_st = {"gen": avg["gen"], "disc": avg["disc"],
              "gen_opt": gen_opt_k, "disc_opt": disc_opt_k}
    if "fault" in st:
        new_st["fault"] = {"stale": prev}
    return new_st, {"participation": (weights > 0).float().mean()}


# ---------------------------------------------------------------------------
# One round per call (host-scheduled weights)
# ---------------------------------------------------------------------------

def _check_tp(spec, tp_ctx, avg_impl, faults, reducer):
    """The JAX builders' checks of a mesh round: the faults / robust and
    ring contracts at the round's tp, and a spec whose TP-awareness
    matches it (a dense spec would take shards without reducing)."""
    tp = 1 if tp_ctx is None else tp_ctx.size
    check_faults_tp(faults, reducer, tp)
    check_ring_support(avg_impl, tp, faults, reducer)
    if (spec.tp_axis is not None) != (tp > 1):
        raise ValueError(f"a round at tp={tp} needs a spec built with "
                         f"tp_axis={'model' if tp > 1 else None!r}, got "
                         f"tp_axis={spec.tp_axis!r}")


def _mesh_single_round(slice_round_fn: Callable, spec, pcfg, state,
                       data_local, weight_local, draws, group, avg_impl,
                       faults, reducer, tp_ctx):
    """One round on this rank: the contracts, its own weight, the data
    group's all-gathered weights (one collective) and their sum, then
    the algorithm's slice round."""
    _check_tp(spec, tp_ctx, avg_impl, faults, reducer)
    if pcfg.schedule not in ("serial", "parallel"):
        raise ValueError(f"unknown schedule {pcfg.schedule!r}")
    protocol._check_draws(pcfg, draws, dist.get_world_size(group))
    my_index = dist.get_rank(group)
    w_k = torch.as_tensor(weight_local, dtype=torch.float32,
                          device=data_local.device)
    weights = mesh.all_gather(w_k.reshape(1), group).reshape(-1)
    wsum = weights.sum()
    return slice_round_fn(spec, pcfg, group, faults, reducer, avg_impl,
                          tp_ctx, my_index, state, data_local, w_k, weights,
                          wsum, draws)


def check_faults_tp(faults, robust, tp: int):
    """Fault injection and robust reduction compose with the mesh layout
    at tp=1 only: under TP the per-rank payload is a model-axis shard, so
    byzantine noise, the stale cache and shard-local norms and distances
    would all diverge from the worker-global semantics."""
    if tp > 1 and (faults is not None or robust is not None):
        raise NotImplementedError(
            "faults/robust reducers are not supported under tensor "
            "parallelism (tp > 1); run tp=1")


def check_ring_support(avg_impl: str, tp: int, faults, robust):
    """The contract of `avg_impl="ring"`: tp == 1 (the encoded payload is
    worker-global), no robust reducers and no upload-corrupting fault
    programs (both act on dequantized per-worker trees, which the ring
    never materializes; they stay on the flat gather path). Dropout and
    stragglers compose: they only zero weights. (A process group is one
    ring, so the JAX package's single-device-axis check has no
    counterpart.)"""
    if avg_impl != "ring":
        return
    if tp > 1:
        raise NotImplementedError(
            "avg_impl='ring' is not supported under tensor parallelism "
            "(tp > 1); the encoded ring payload is worker-global")
    if robust is not None:
        raise NotImplementedError(
            "avg_impl='ring' does not compose with robust reducers; "
            "use the flat path (avg_impl='pallas')")
    prog = faults_lib.fault_program(faults)
    if prog is not None and prog.corrupts:
        raise NotImplementedError(
            "avg_impl='ring' does not compose with upload-corrupting "
            "fault programs (free riders / byzantine); use the flat "
            "path (avg_impl='pallas')")


def mesh_round(spec, pcfg: ProtocolConfig, state, data_local, weight_local,
               draws, *, group=None, avg_impl: str = "pallas", faults=None,
               reducer=None, tp_ctx=None):
    """One proposed-protocol round on this rank of `group` (the
    counterpart of `repro.core.shard_round.shard_map_round`).

    state: this rank's state (module docstring); data_local: its (n_k,
    ...) shard; weight_local: its Algorithm-2 weight (0 when not
    scheduled); draws: the round's whole `RoundDraws`, the same on every
    rank. `faults` corrupts this worker's upload, `reducer` (a
    RobustConfig) selects the robust reducer. tp_ctx: None at tp=1;
    under TP (`make_tp_ctx` of the global state) `group` is the data
    group and the state this rank's shards. Returns (new_state,
    metrics), the globals and metrics equal on every rank of a model
    rank's data group."""
    return _mesh_single_round(_proposed_slice_round, spec, pcfg, state,
                              data_local, weight_local, draws, group,
                              avg_impl, faults, reducer, tp_ctx)


def fedgan_mesh_round(spec, pcfg: ProtocolConfig, state, data_local,
                      weight_local, draws, *, group=None,
                      avg_impl: str = "pallas", faults=None, reducer=None,
                      tp_ctx=None):
    """One FedGAN round on this rank of `group` (the counterpart of
    `repro.core.shard_round.fedgan_shard_map_round`); the rank keeps its
    own gen_opt and disc_opt. Arguments as `mesh_round`."""
    return _mesh_single_round(_fedgan_slice_round, spec, pcfg, state,
                              data_local, weight_local, draws, group,
                              avg_impl, faults, reducer, tp_ctx)


# ---------------------------------------------------------------------------
# The fused driver: R rounds with Step 1 on every rank
# ---------------------------------------------------------------------------

def _mesh_rounds(slice_round_fn: Callable, spec, pcfg: ProtocolConfig,
                 state, data_local, n_rounds: int, *, fedgan: bool,
                 group=None, avg_impl: str = "pallas", faults=None,
                 reducer=None, tp_ctx=None, **kw):
    """`protocol.rounds` over this rank's slice round: every rank
    schedules from the same slots, takes its own weight from the
    round's (K,) weights and runs the algorithm's slice round. Port of
    `repro.core.shard_round._mesh_rounds_scan`; uncaptured (module
    docstring). Under TP the channel's parameter counts and payload
    bits must be the worker's global ones (`disc_nparams`,
    `gen_nparams`, `uplink_bits` of `protocol.rounds`)."""
    _check_tp(spec, tp_ctx, avg_impl, faults, reducer)
    if pcfg.schedule not in ("serial", "parallel"):
        raise ValueError(f"unknown schedule {pcfg.schedule!r}")
    my_index = dist.get_rank(group)

    def round_fn(st, data_k, weights, draws):
        protocol._check_draws(pcfg, draws, weights.shape[0])
        return slice_round_fn(spec, pcfg, group, faults, reducer, avg_impl,
                              tp_ctx, my_index, st, data_k,
                              weights[my_index], weights, weights.sum(),
                              draws)

    return protocol.rounds(
        round_fn, pcfg, state, data_local, n_rounds, fedgan=fedgan,
        faults=faults, **kw)


def mesh_rounds(spec, pcfg: ProtocolConfig, state, data_local,
                n_rounds: int, **kw):
    """`n_rounds` fused rounds of the proposed protocol on this rank of
    `group` (the counterpart of `repro.core.shard_round.
    shard_rounds_scan`). state and data_local as `mesh_round`; the
    keyword arguments are `protocol.rounds`' and group, avg_impl,
    faults, reducer, tp_ctx as `mesh_round`'s. Returns (state,
    sched_carry, out) as `protocol.rounds`, the same masks, weights and
    wallclock on every rank."""
    return _mesh_rounds(_proposed_slice_round, spec, pcfg, state,
                        data_local, n_rounds, fedgan=False, **kw)


def fedgan_mesh_rounds(spec, pcfg: ProtocolConfig, state, data_local,
                       n_rounds: int, **kw):
    """`n_rounds` fused FedGAN rounds on this rank (the counterpart of
    `repro.core.shard_round.fedgan_shard_rounds_scan`); arguments as
    `mesh_rounds`."""
    return _mesh_rounds(_fedgan_slice_round, spec, pcfg, state, data_local,
                        n_rounds, fedgan=True, **kw)


__all__ = ["mesh_round", "fedgan_mesh_round", "mesh_rounds",
           "fedgan_mesh_rounds", "check_faults_tp", "TpCtx", "make_tp_ctx",
           "check_ring_support", "PROPOSED_STACKED_KEYS", "PROPOSED_METRICS",
           "PROPOSED_PAYLOAD", "FEDGAN_STACKED_KEYS", "FEDGAN_METRICS",
           "FEDGAN_PAYLOAD"]
