"""THE PAPER'S CONTRIBUTION — the distributed GAN training protocol.

One communication round (Section II-B, Section III):

  Step 1  server schedules S ⊆ K devices          (core.scheduling, host)
  Step 2  scheduled devices run Algorithm 1 (n_d local discriminator
          steps); under the PARALLEL schedule the server runs Algorithm 3
          from the same round-start parameters, with shared-seed noise
  Step 3  devices upload local discriminators     (16-bit, core.quantize)
  Step 4  server averages them — Algorithm 2      (core.averaging, the
          hand-written wavg kernel on CUDA)
  Step 5  server broadcasts the global GAN
  SERIAL schedule: Algorithm 3 runs after Step 4 against the fresh
          global discriminator.

Port of `repro.core.protocol` for the stacked layout: the paper's K
devices live on one GPU, Algorithm 1 runs device by device, and
Algorithm 2 reduces the K uploads in one kernel launch. Algorithms 1
and 3 accumulate gradients over microbatches when the config asks
(`_accumulated_grad`), and `centralized_step` is Fig. 4's centralized
baseline (one worker on the pooled data).

RANDOMNESS enters as explicit tensors (`RoundDraws`): the shared noise
per local and server step, the devices' sample indices, the uplink
quantizer's uniforms and, under a fault program (`core.faults`), the
dropout uniforms (on the host) and the byzantine devices' normals.
`DrawSampler` makes them from seeded generators; tests pass the JAX
package's own draws instead, so both packages compute the same round.

FUSED ROUND ENGINE: `rounds` runs R complete rounds of ANY round
function with Step 1 on the device: scheduling (`core.device_scheduling`),
channel timing and straggler exclusion (`core.device_channel`), the
round's model math and the Fig. 1/Fig. 2 wall-clock composition, as one
round body over tensors at fixed addresses (`RoundSlots`), replayed as a
captured CUDA graph on the stacked layout (`core.graphs`). Every random
draw is made before its round, into the slots: the model's draws from
the same streams as the host driver (so both drivers train on the same
draws), the dropout uniforms, and, from the stream (seed,
STREAM_CHANNEL, t), the fading exponentials and the random policy's
permutation. `gan_rounds` instantiates it for the proposed protocol and
`fedgan.fedgan_rounds` for FedGAN. The host driver
(`engine.Trainer(driver="host")`) is the equivalence oracle: for
deterministic policies with fading off, the fused masks and weights
equal its own bit for bit, and the wallclock, parameters and metrics
agree to float32 round-off.

HOSTILE WORKERS: `gan_round(faults=, reducer=)` corrupts the uploads
after the quantized uplink (free-riders replay the stale round-start
global, byzantine devices upload scaled noise) and reduces them with a
robust reducer (`kernels/robust_avg`) when one is given.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import device_channel, device_scheduling, graphs
from repro_torch.core import faults as faults_lib
from repro_torch.core import losses, quantize
from repro_torch.core.averaging import broadcast_like, weighted_average
from repro_torch.device import resolve_device
from repro_torch.optim import apply_updates, make_optimizer
from repro_torch.tree import (tree_index, tree_leaves, tree_map, tree_stack,
                              tree_unflatten)

# Stream tags mixed with the run's seed (`seeded_generator`): one stream
# per round for the model's randomness, one per round for FID noise, one
# per round for the fault program's dropout (a host numpy stream), one
# per round for the fused driver's channel (fading, random permutation).
STREAM_ROUND = 0
STREAM_FID = 1
STREAM_DROPOUT = 2
STREAM_CHANNEL = 3


@dataclasses.dataclass(frozen=True)
class GanModelSpec:
    """Adapter between the protocol and a concrete (G, D) pair.

    sample_z(generator, n, device=None)
                                     -> noise batch on `device`, by default
                                        generator.device
    gen_apply(gen_params, z)         -> fake data batch
    disc_real(disc_params, batch)    -> logits (n,) on real data
    disc_fake(disc_params, fake)     -> logits (n,) on generated data

    tp_axis: set by TP-aware builders (`make_backbone_spec(tp_axis=)`,
    `gan.mlp_gan_spec(tp_axis=)`) when the apply functions run Megatron
    collectives over the model group: the parameters they receive must
    then be model-axis SHARDS. `engine.Trainer(tp=)` checks it against
    its own tp, since a mismatch computes silently wrong results.
    """
    sample_z: Callable
    gen_apply: Callable
    disc_real: Callable
    disc_fake: Callable
    gen_loss_variant: str = "minimax"
    tp_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RoundDraws:
    """All of one round's randomness, as tensors on the round's device.

    z_dev:   (n_d, m, ...) shared noise of local step j (every device):
                           (n_d, m, nz) for the DCGAN, (n_d, m, seq_len,
                           d_z) for a backbone-GAN
    z_srv:   (n_g, M, ...) shared noise of server step j
    idx:     (n_d, K, m)   int64 sample indices into device k's shard
    quant_u: (K, N)        stochastic-rounding uniforms of device k's
                           upload (N payload parameters); None when the
                           uplink is not quantized (>= 32 bits)
    drop_u:  (K,)          numpy, on the HOST: the fault program's dropout
                           uniforms (None without dropout)
    byz_normals: (B, N)    standard normals of the B byzantine devices'
                           forged uploads, in device order (None without
                           byzantine devices)
    """
    z_dev: torch.Tensor
    z_srv: torch.Tensor
    idx: torch.Tensor
    quant_u: Optional[torch.Tensor]
    drop_u: Optional[np.ndarray] = None
    byz_normals: Optional[torch.Tensor] = None


def seeded_generator(seed: int, stream: int, index: int,
                     device) -> torch.Generator:
    """A generator on `device` seeded from (seed, stream, index). A draw
    on the meta device (a dry run's) takes no values from a generator,
    so a CPU one stands in there."""
    mixed = np.random.SeedSequence([seed, stream, index]).generate_state(1)
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(int(mixed[0]))
    return gen


class DrawSampler:
    """The default source of each round's `RoundDraws`.

    Round t draws from its own generator, seeded from (seed, t). The
    shared noise of step j is ONE draw of max(m, M) rows that devices
    and server both slice (the paper's "identical pseudo random
    sequence", Section III-A). `n_params` is the size of one device's
    upload. Under `faults`, the dropout uniforms come from a host numpy
    stream seeded from (seed, STREAM_DROPOUT, t) and the byzantine
    normals from the round's device generator."""

    def __init__(self, spec: GanModelSpec, pcfg: ProtocolConfig, *,
                 seed: int, n_local: int, n_params: int, device,
                 faults: Optional[faults_lib.FaultConfig] = None):
        self.spec, self.pcfg = spec, pcfg
        self.seed, self.n_local, self.n_params = seed, n_local, n_params
        self.device, self.faults = device, faults

    def __call__(self, t: int, out: Optional[RoundDraws] = None
                 ) -> RoundDraws:
        """Round t's draws. With `out` (draws of this sampler's shapes,
        e.g. the fused driver's slots) they are written into its tensors
        in place, the same values; the result holds those tensors and
        the round's host dropout uniforms."""
        pcfg = self.pcfg
        m, big_m = pcfg.sample_size, pcfg.server_sample_size
        gen = seeded_generator(self.seed, STREAM_ROUND, t, self.device)
        z_dev, z_srv = (None, None) if out is None else (out.z_dev,
                                                         out.z_srv)
        for j in range(max(pcfg.n_d, pcfg.n_g)):
            z_j = self._sample_z(gen, max(m, big_m))
            if z_dev is None:
                z_dev = z_j.new_empty((pcfg.n_d, m) + z_j.shape[1:])
                z_srv = z_j.new_empty((pcfg.n_g, big_m) + z_j.shape[1:])
            if j < pcfg.n_d:
                z_dev[j].copy_(z_j[:m])
            if j < pcfg.n_g:
                z_srv[j].copy_(z_j[:big_m])
        slot = lambda name: None if out is None else getattr(out, name)
        idx = torch.randint(0, self.n_local, (pcfg.n_d, pcfg.n_devices, m),
                            generator=gen, device=self.device,
                            out=slot("idx"))
        quant_u = drop_u = byz = None
        if pcfg.quantize_bits < 32:
            quant_u = torch.rand((pcfg.n_devices, self.n_params),
                                 generator=gen, device=self.device,
                                 out=slot("quant_u"))
        faults = self.faults
        if faults is not None and faults.dropout_prob > 0:
            drop_u = np.random.default_rng(np.random.SeedSequence(
                [self.seed, STREAM_DROPOUT, t])).random(pcfg.n_devices)
        if faults is not None and faults.n_byzantine > 0:
            byz = torch.randn((faults.n_byzantine, self.n_params),
                              generator=gen, device=self.device,
                              out=slot("byz_normals"))
        return RoundDraws(z_dev, z_srv, idx, quant_u, drop_u, byz)

    def _sample_z(self, gen, n):
        """The spec's noise draw; on the meta device from the CPU
        generator that stands in there (`seeded_generator`)."""
        if torch.device(self.device).type != "meta":
            return self.spec.sample_z(gen, n)
        return self.spec.sample_z(gen, n, device="meta")


def make_train_state(init_fn: Callable, pcfg: ProtocolConfig,
                     n_devices: int, *, seed: int = 0, device=None):
    """init_fn(generator) -> {"gen": ..., "disc": ...}, called with a
    `torch.Generator` seeded from `seed` on `device` (CUDA unless the
    caller names another). Returns {"gen", "disc", "gen_opt",
    "disc_opt"}; disc_opt is the per-device local optimizer state,
    stacked K (persists locally, never averaged)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tree_map(lambda x: x.to(device), init_fn(gen))
    gen_opt = make_optimizer(pcfg.optimizer, pcfg.lr_g).init(params["gen"])
    disc_opt = make_optimizer(pcfg.optimizer, pcfg.lr_d).init(params["disc"])
    return {"gen": params["gen"], "disc": params["disc"],
            "gen_opt": gen_opt, "disc_opt": broadcast_like(disc_opt,
                                                           n_devices)}


def _value_and_grad(objective: Callable, params):
    """(objective(params), d objective / d params) for a parameter tree."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    value = objective(tree_unflatten(params, leaves))
    # A leaf the objective does not reach (the backbone generator's
    # embedding table and lm_head in GAN mode) gets a zero gradient, as
    # under jax.grad.
    grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                materialize_grads=True)
    return value.detach(), tree_unflatten(params, list(grads))


def _accumulated_grad(objective: Callable, params, batches, total: int,
                      micro: Optional[int]):
    """`_value_and_grad` with gradient accumulation over microbatches.
    Port of `repro.core.protocol._accumulated_grad`.

    objective(params, *slices) -> scalar mean loss over the slices.
    batches: tensors with leading axis `total`, sliced jointly, in
    order, into `total // micro` chunks (`micro` must divide `total`);
    the loss and gradients are the mean over the chunks. `micro` None or
    >= total runs the whole batch at once. A forward per chunk: batch
    statistics are the chunk's, as in the JAX package.
    """
    if micro is None or micro >= total:
        return _value_and_grad(lambda p: objective(p, *batches), params)
    if total % micro:
        raise ValueError(f"micro {micro} must divide batch {total}")
    n_chunks = total // micro
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batches[0].device)
    grad_sum = tree_map(torch.zeros_like, params)
    for i in range(n_chunks):
        chunk = [b[i * micro:(i + 1) * micro] for b in batches]
        loss, grads = _value_and_grad(lambda p: objective(p, *chunk),
                                      params)
        loss_sum = loss_sum + loss
        grad_sum = tree_map(torch.add, grad_sum, grads)
    scale = 1.0 / n_chunks
    return loss_sum * scale, tree_map(lambda g: g * scale, grad_sum)


# ---------------------------------------------------------------------------
# Algorithm 1 — the devices' local updates
# ---------------------------------------------------------------------------

def devices_update(spec: GanModelSpec, pcfg: ProtocolConfig, gen_params,
                   disc_params, disc_opt_stacked, data_stacked,
                   draws: RoundDraws):
    """n_d mini-batch steps ascending eq (2) on every device's shard,
    each from the round-start global discriminator.

    The shared noise makes every device's fake batch at local step j
    identical, so G(theta, z_j) runs once per step, without a gradient,
    for all K devices — the same math as one forward per device.
    With `pcfg.micro_batch_d` the real and fake batches are sliced
    jointly into microbatches (`_accumulated_grad`).
    Returns (stacked discs, stacked opt states, (K,) last objectives).
    """
    n_devices = data_stacked.shape[0]
    opt = make_optimizer(pcfg.optimizer, pcfg.lr_d)
    discs = [disc_params] * n_devices
    opts = [tree_index(disc_opt_stacked, k) for k in range(n_devices)]
    objs = [None] * n_devices

    def neg_obj(phi, x_mb, fake_mb):
        return -losses.disc_objective(spec.disc_real(phi, x_mb),
                                      spec.disc_fake(phi, fake_mb))

    for j in range(pcfg.n_d):
        with torch.no_grad():
            fake = spec.gen_apply(gen_params, draws.z_dev[j])
        for k in range(n_devices):
            x = data_stacked[k][draws.idx[j, k]]
            loss, grads = _accumulated_grad(neg_obj, discs[k], [x, fake],
                                            pcfg.sample_size,
                                            pcfg.micro_batch_d)
            updates, opts[k] = opt.update(grads, opts[k])
            discs[k] = apply_updates(discs[k], updates)  # eq (3)
            objs[k] = -loss
    return tree_stack(discs), tree_stack(opts), torch.stack(objs)


# ---------------------------------------------------------------------------
# Algorithm 3 — server generator update
# ---------------------------------------------------------------------------

def server_update(spec: GanModelSpec, pcfg: ProtocolConfig, gen_params,
                  gen_opt, disc_params, draws: RoundDraws):
    """n_g steps descending eq (1) against the given discriminator, with
    the SAME shared noise stream as the devices. Only G is
    differentiated. With `pcfg.micro_batch_g` the noise is sliced into
    microbatches and G runs once a chunk (`_accumulated_grad`)."""
    opt = make_optimizer(pcfg.optimizer, pcfg.lr_g)
    gen, obj = gen_params, None

    def objective(theta, z_mb):
        fake = spec.gen_apply(theta, z_mb)
        return losses.gen_objective(spec.disc_fake(disc_params, fake),
                                    variant=spec.gen_loss_variant)

    for j in range(pcfg.n_g):
        obj, grads = _accumulated_grad(objective, gen, [draws.z_srv[j]],
                                       pcfg.server_sample_size,
                                       pcfg.micro_batch_g)
        updates, gen_opt = opt.update(grads, gen_opt)
        gen = apply_updates(gen, updates)         # eq (4)
    return gen, gen_opt, obj


# ---------------------------------------------------------------------------
# One communication round (Steps 1–5)
# ---------------------------------------------------------------------------

def _check_draws(pcfg: ProtocolConfig, draws: RoundDraws, n_devices: int):
    m, big_m = pcfg.sample_size, pcfg.server_sample_size
    if (draws.z_dev.shape[:2] != (pcfg.n_d, m)
            or draws.z_srv.shape[:2] != (pcfg.n_g, big_m)
            or tuple(draws.idx.shape) != (pcfg.n_d, n_devices, m)):
        raise ValueError(
            f"draws do not fit the round: z_dev {tuple(draws.z_dev.shape)},"
            f" z_srv {tuple(draws.z_srv.shape)}, idx "
            f"{tuple(draws.idx.shape)} for n_d={pcfg.n_d}, n_g={pcfg.n_g},"
            f" K={n_devices}, m={m}, M={big_m}")


def corrupt_uploads(payload, draws: RoundDraws, state, faults=None):
    """The uploads the server receives under the fault program: the
    quantized `payload` (stacked K) with the free-riders' rows replaced
    by `state["fault"]["stale"]` and the byzantine rows by scaled noise
    (`draws.byz_normals`)."""
    prog = faults_lib.fault_program(faults)
    if prog is None or not prog.corrupts:
        return payload
    stale = state["fault"]["stale"] if "fault" in state else None
    return faults_lib.corrupt_upload(prog, payload, draws.byz_normals,
                                     stale=stale)


def gan_round(spec: GanModelSpec, pcfg: ProtocolConfig, state,
              data_stacked, weights, draws: RoundDraws, *, faults=None,
              reducer=None):
    """One full round.

    state: {"gen", "disc", "gen_opt", "disc_opt"} — disc is the GLOBAL
           discriminator (post-broadcast) and disc_opt the per-device
           local optimizer states (stacked K). An optional "fault" entry
           holds the free-rider stale-upload cache (core/faults.py).
    data_stacked: (K, n_k, ...) tensor — device-private shards.
    weights: (K,) — m_k for scheduled devices, 0 otherwise (Step 1
           output; also encodes straggler exclusion, footnote 1).
    draws: the round's randomness (`RoundDraws`).
    faults: optional FaultConfig — free-riders replay the stale cache,
           byzantine devices upload scaled noise (`draws.byz_normals`).
    reducer: optional RobustConfig — Step 4 aggregates with the robust
           reducer instead of the plain weighted mean.
    Returns (new_state, metrics) with metrics as 0-dim tensors.
    """
    if pcfg.schedule not in ("serial", "parallel"):
        raise ValueError(f"unknown schedule {pcfg.schedule!r}")
    n_devices = weights.shape[0]
    _check_draws(pcfg, draws, n_devices)

    # Step 2 — Algorithm 1 on every device (free-riders and byzantine
    # devices too: their optimizer states advance and their objectives
    # enter the metric, as in the JAX package).
    new_discs, new_disc_opt, disc_objs = devices_update(
        spec, pcfg, state["gen"], state["disc"], state["disc_opt"],
        data_stacked, draws)

    # Step 3 — each device quantizes its upload (16 bits by default;
    # >= 32 bits is the float32 identity).
    new_discs = quantize.roundtrip_stacked(draws.quant_u, new_discs,
                                           pcfg.quantize_bits)

    # Hostile uploads, where the server receives them (after the
    # quantized uplink), then Step 4 — Algorithm 2, robust with a
    # reducer. On a no-survivor round (every weight zero) the previous
    # global discriminator is kept.
    new_discs = corrupt_uploads(new_discs, draws, state, faults)
    disc_avg = weighted_average(new_discs, weights, robust=reducer,
                                fallback=state["disc"])

    # Algorithm 3 — serial: against fresh phi^{t+1}; parallel: against the
    # round-start phi^t.
    disc_for_gen = disc_avg if pcfg.schedule == "serial" else state["disc"]
    new_gen, new_gen_opt, gen_obj = server_update(
        spec, pcfg, state["gen"], state["gen_opt"], disc_for_gen, draws)

    w = weights.float()
    wsum = torch.clamp(w.sum(), min=1e-12)
    metrics = {
        "disc_objective": torch.sum(disc_objs * w) / wsum,
        "gen_objective": gen_obj,
        "participation": (w > 0).float().mean(),
    }
    new_state = {"gen": new_gen, "disc": disc_avg,
                 "gen_opt": new_gen_opt, "disc_opt": new_disc_opt}
    if "fault" in state:
        # the free-riders' replay of next round: this round's broadcast
        new_state["fault"] = {"stale": state["disc"]}
    return new_state, metrics


def centralized_step(spec: GanModelSpec, pcfg: ProtocolConfig, state, data,
                     draws: RoundDraws):
    """Centralized baseline (Fig. 4): one worker, same budget — n_d
    discriminator steps on the pooled data `data` (n, ...) then n_g
    generator steps against the new discriminator. Port of
    `repro.core.protocol.centralized_step`: state["disc_opt"] has a
    leading axis of 1, and `draws` are one device's (idx (n_d, 1, m)
    into the pooled rows)."""
    discs, disc_opt, objs = devices_update(
        spec, pcfg, state["gen"], state["disc"], state["disc_opt"],
        data[None], draws)
    disc = tree_index(discs, 0)
    gen, gen_opt, gen_obj = server_update(
        spec, pcfg, state["gen"], state["gen_opt"], disc, draws)
    new_state = {"gen": gen, "disc": disc, "gen_opt": gen_opt,
                 "disc_opt": disc_opt}
    return new_state, {"disc_objective": objs[0], "gen_objective": gen_obj,
                       "participation": torch.ones((), dtype=torch.float32,
                                                   device=objs.device)}


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def uplink_payload_bits(state, pcfg: ProtocolConfig, *,
                        fedgan: bool = False) -> int:
    """Per-device upload payload in bits at the protocol's quantization
    width: phi only for the proposed framework, theta AND phi for FedGAN
    (the communication asymmetry Fig. 5 measures)."""
    bits = quantize.tree_bits(state["disc"], pcfg.quantize_bits)
    if fedgan:
        bits += quantize.tree_bits(state["gen"], pcfg.quantize_bits)
    return bits


# ---------------------------------------------------------------------------
# Fused round engine — Step 1 on the device, one captured graph a round
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoundSlots:
    """The fused driver's per-round inputs, at fixed addresses on the
    round's device; filled before each round (`fill_slots`).

    draws:  the round's `RoundDraws` tensors (its drop_u stays None: the
            body takes the dropout uniforms from `drop_u` below)
    drop_u: (K,) float32 dropout uniforms, or None without dropout
    fading: (2, K) float32 Exp(1) Rayleigh fading: row 0 for the
            scheduler's rates, row 1 for the round's timing; None with
            fading off
    perm:   (K,) int64 permutation of the `random` policy, else None
    """
    draws: RoundDraws
    drop_u: Optional[torch.Tensor] = None
    fading: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None

    @classmethod
    def holding(cls, draws: RoundDraws, *, fading: bool,
                random_policy: bool, dropout: bool, n_devices: int, device):
        """Slots that hold `draws` (a round's fresh draws, which become
        the slots' tensors) and empty channel and dropout slots."""
        on = lambda x: None if x is None else x.to(device)
        f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                         device=device)
        return cls(
            RoundDraws(on(draws.z_dev), on(draws.z_srv), on(draws.idx),
                       on(draws.quant_u), None, on(draws.byz_normals)),
            drop_u=f32(n_devices) if dropout else None,
            fading=f32(2, n_devices) if fading else None,
            perm=(torch.empty(n_devices, dtype=torch.int64, device=device)
                  if random_policy else None))


def _to_slot(slot: torch.Tensor, value):
    """Copy `value` (a tensor or a host array) into `slot`, without a
    host sync: host data travels from pinned memory, which the caching
    host allocator keeps until the copy has run."""
    if not torch.is_tensor(value):
        value = torch.tensor(value)
    if slot.is_cuda and value.device.type == "cpu":
        value = value.to(slot.dtype).pin_memory()
    slot.copy_(value, non_blocking=True)


def fill_slots(slots: RoundSlots, sampler: Callable, t: int, *, seed: int,
               draws: Optional[RoundDraws] = None):
    """Write round t's draws into `slots`: the model's draws from
    `sampler` (a `DrawSampler` draws into them in place, any other
    sampler's draws are copied; `draws`, round t's draws that the slots
    hold already, takes the sampler's place), the dropout uniforms,
    and, from a generator seeded from (seed, STREAM_CHANNEL, t), the
    fading exponentials, then the random policy's permutation."""
    if draws is not None:
        pass
    elif isinstance(sampler, DrawSampler):
        draws = sampler(t, out=slots.draws)
    else:
        draws = sampler(t)
        for f in dataclasses.fields(RoundDraws):
            slot = getattr(slots.draws, f.name)
            if slot is not None:
                _to_slot(slot, getattr(draws, f.name))
    if slots.drop_u is not None:
        _to_slot(slots.drop_u, np.asarray(draws.drop_u, np.float32))
    if slots.fading is not None or slots.perm is not None:
        device = (slots.fading if slots.fading is not None
                  else slots.perm).device
        # (a meta draw, a dry run's, takes no generator)
        gen = (None if device.type == "meta"
               else seeded_generator(seed, STREAM_CHANNEL, t, device))
        if slots.fading is not None:
            slots.fading.exponential_(generator=gen)
        if slots.perm is not None:
            torch.randperm(slots.perm.shape[0], generator=gen,
                           device=device, out=slots.perm)


def schedule_and_time(pcfg: ProtocolConfig, channel, scheduler, sched_carry,
                      slots: RoundSlots, *, disc_nparams: int,
                      gen_nparams: int, disc_step_flops: float,
                      gen_step_flops: float, fedgan: bool, uplink_bits,
                      faults=None):
    """Step 1 and the channel's accounting for one round on the device,
    shared by the fused engine's layouts (`rounds` and
    `shard_round.mesh_rounds`): from the same slots every layout and
    every rank computes the same masks, stragglers and weights. Port of
    `repro.core.protocol.schedule_and_time`.

    With a FaultConfig, the round's dropout knocks scheduled devices out
    of the mask before timing, and the program's per-device compute
    multipliers (stragglers slower, free-riders free) feed the timing.
    Returns (mask, new_sched_carry, timing, weights)."""
    fading = slots.fading
    rates = channel.uplink_rates(None if fading is None else fading[0],
                                 scheduler.n_scheduled)
    mask, sched_carry = device_scheduling.schedule_step(
        scheduler, sched_carry, rates, slots.perm)
    prog = faults_lib.fault_program(faults)
    compute_mult = None
    if prog is not None:
        dropped = prog.dropout_mask_device(slots.drop_u)
        if dropped is not None:
            mask = mask & ~dropped
        compute_mult = prog.roles_on(mask.device).compute_mult
    timing = channel.round_timing(
        None if fading is None else fading[1], mask,
        disc_params=disc_nparams, gen_params=gen_nparams,
        disc_step_flops=disc_step_flops, gen_step_flops=gen_step_flops,
        n_d=pcfg.n_d, n_g=pcfg.n_g, fedgan=fedgan, uplink_bits=uplink_bits,
        compute_mult=compute_mult)
    active = mask & ~timing.stragglers
    weights = torch.where(
        active, torch.full((), float(pcfg.sample_size), device=mask.device),
        torch.zeros((), device=mask.device)).float()
    return mask, sched_carry, timing, weights


def _round_body(round_fn, pcfg, channel, scheduler, data, counts, fedgan,
                faults, state, sched_carry, slots):
    """One fused round: Step 1 and timing, Steps 2-5, the wallclock."""
    mask, sched_carry, timing, weights = schedule_and_time(
        pcfg, channel, scheduler, sched_carry, slots, fedgan=fedgan,
        faults=faults, **counts)
    state, metrics = round_fn(state, data, weights, slots.draws)
    wall = device_channel.round_wallclock(timing, mask,
                                          schedule=pcfg.schedule,
                                          fedgan=fedgan)
    return state, sched_carry, {"metrics": metrics, "wallclock_s": wall,
                                "mask": mask, "weights": weights}


def rounds(round_fn, pcfg: ProtocolConfig, state, data_stacked,
           n_rounds: int, *, channel, scheduler, sampler: Callable,
           seed: int, sched_carry=None, start_round: int = 0,
           disc_step_flops: float = 1e9, gen_step_flops: float = 1e9,
           fedgan: bool = False, uplink_bits: Optional[int] = None,
           disc_nparams: Optional[int] = None,
           gen_nparams: Optional[int] = None,
           faults=None, graph: graphs.RoundGraph):
    """The fused round engine: `n_rounds` rounds of ANY round function,
    Step 1 and the wallclock on the device. Port of
    `repro.core.protocol.rounds_scan`.

    round_fn:  (state, data_stacked, weights, draws) -> (state, metrics):
               `gan_round` (via `gan_rounds`) or `fedgan.fedgan_round`
               (via `fedgan.fedgan_rounds`), or a mesh rank's round.
    channel:   a `device_channel.DeviceChannel` on the data's device
    scheduler: a `device_scheduling.DeviceScheduler`
    sampler:   t -> RoundDraws (a `DrawSampler` or an injected sampler)
    seed:      the run's seed: round t's channel draws come from
               (seed, STREAM_CHANNEL, t)
    sched_carry: the scheduler carry (None: a fresh one)
    start_round: the absolute index of the first round
    fedgan:    FedGAN's timing and wallclock composition
    uplink_bits: the per-device upload payload in bits; None computes it
               from the state at `pcfg.quantize_bits`
    disc_nparams, gen_nparams: the parameter counts the channel times;
               None counts the state's (a tensor-parallel rank passes
               the worker's global counts)
    graph:     the `graphs.RoundGraph` that runs the rounds (the
               Trainer's: captured on CUDA on the stacked layout). The
               first call binds it to `state` and the carry, which it
               then updates in place; pass the same graph, state and
               carry to go on in a later chunk.

    Returns (state, sched_carry, out): out stacks per-round
    {"metrics": {...: (R,)}, "wallclock_s": (R,), "mask": (R, K) bool,
    "weights": (R, K)} as numpy arrays, JAX's keys (one copy to the host
    a chunk); state and sched_carry are the graph's static tensors.
    """
    device = data_stacked.device
    first = None          # the first round's draws, when they bind slots
    if graph.bound:
        if state is not graph.state or (sched_carry is not None
                                        and sched_carry is not graph.carry):
            raise ValueError("a bound RoundGraph goes on from its own "
                             "state and carry: pass graph.state and "
                             "graph.carry")
    else:
        if sched_carry is None:
            sched_carry = scheduler.init_carry(device)
        prog = faults_lib.fault_program(faults)
        if prog is not None:
            prog.roles_on(device)          # copied once, before any round
        if uplink_bits is None:
            uplink_bits = uplink_payload_bits(state, pcfg, fedgan=fedgan)
        counts = dict(disc_nparams=(count_params(state["disc"])
                                    if disc_nparams is None
                                    else disc_nparams),
                      gen_nparams=(count_params(state["gen"])
                                   if gen_nparams is None else gen_nparams),
                      disc_step_flops=disc_step_flops,
                      gen_step_flops=gen_step_flops, uplink_bits=uplink_bits)
        first = sampler(start_round)
        slots = RoundSlots.holding(
            first, fading=channel.cfg.fading,
            random_policy=scheduler.policy == "random",
            dropout=prog is not None and prog.cfg.dropout_prob > 0,
            n_devices=scheduler.n_devices, device=device)
        graph.bind(functools.partial(_round_body, round_fn, pcfg, channel,
                                     scheduler, data_stacked, counts, fedgan,
                                     faults),
                   state, sched_carry, slots)
    out = graph.run(n_rounds, lambda i: fill_slots(
        graph.slots, sampler, start_round + i, seed=seed,
        draws=first if i == 0 else None))
    return graph.state, graph.carry, out


def gan_rounds(spec: GanModelSpec, pcfg: ProtocolConfig, state,
               data_stacked, n_rounds: int, *, faults=None, reducer=None,
               **kw):
    """`n_rounds` fused rounds of the PROPOSED protocol (see `rounds`,
    which takes the keyword arguments). Port of
    `repro.core.protocol.gan_rounds_scan`."""
    round_fn = lambda st, d, w, draws: gan_round(
        spec, pcfg, st, d, w, draws, faults=faults, reducer=reducer)
    return rounds(round_fn, pcfg, state, data_stacked, n_rounds,
                  fedgan=False, faults=faults, **kw)
