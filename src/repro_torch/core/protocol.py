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
Algorithm 2 reduces the K uploads in one kernel launch.

RANDOMNESS enters as explicit tensors (`RoundDraws`): the shared noise
per local and server step, the devices' sample indices, the uplink
quantizer's uniforms and, under a fault program (`core.faults`), the
dropout uniforms (on the host) and the byzantine devices' normals.
`DrawSampler` makes them from seeded generators; tests pass the JAX
package's own draws instead, so both packages compute the same round.

HOSTILE WORKERS: `gan_round(faults=, reducer=)` corrupts the uploads
after the quantized uplink (free-riders replay the stale round-start
global, byzantine devices upload scaled noise) and reduces them with a
robust reducer (`kernels/robust_avg`) when one is given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import faults as faults_lib
from repro_torch.core import losses, quantize
from repro_torch.core.averaging import broadcast_like, weighted_average
from repro_torch.device import resolve_device
from repro_torch.optim import apply_updates, make_optimizer
from repro_torch.tree import (tree_index, tree_leaves, tree_map, tree_stack,
                              tree_unflatten)

# Stream tags mixed with the run's seed (`seeded_generator`): one stream
# per round for the model's randomness, one per round for FID noise, one
# per round for the fault program's dropout (a host numpy stream).
STREAM_ROUND = 0
STREAM_FID = 1
STREAM_DROPOUT = 2


@dataclasses.dataclass(frozen=True)
class GanModelSpec:
    """Adapter between the protocol and a concrete (G, D) pair.

    sample_z(generator, n)           -> noise batch on generator.device
    gen_apply(gen_params, z)         -> fake data batch
    disc_real(disc_params, batch)    -> logits (n,) on real data
    disc_fake(disc_params, fake)     -> logits (n,) on generated data
    """
    sample_z: Callable
    gen_apply: Callable
    disc_real: Callable
    disc_fake: Callable
    gen_loss_variant: str = "minimax"


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
    """A generator on `device` seeded from (seed, stream, index)."""
    mixed = np.random.SeedSequence([seed, stream, index]).generate_state(1)
    gen = torch.Generator(device=device)
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

    def __call__(self, t: int) -> RoundDraws:
        pcfg = self.pcfg
        m, big_m = pcfg.sample_size, pcfg.server_sample_size
        gen = seeded_generator(self.seed, STREAM_ROUND, t, self.device)
        z = torch.stack([self.spec.sample_z(gen, max(m, big_m))
                         for _ in range(max(pcfg.n_d, pcfg.n_g))])
        idx = torch.randint(0, self.n_local, (pcfg.n_d, pcfg.n_devices, m),
                            generator=gen, device=self.device)
        quant_u = drop_u = byz = None
        if pcfg.quantize_bits < 32:
            quant_u = torch.rand((pcfg.n_devices, self.n_params),
                                 generator=gen, device=self.device)
        faults = self.faults
        if faults is not None and faults.dropout_prob > 0:
            drop_u = np.random.default_rng(np.random.SeedSequence(
                [self.seed, STREAM_DROPOUT, t])).random(pcfg.n_devices)
        if faults is not None and faults.n_byzantine > 0:
            byz = torch.randn((faults.n_byzantine, self.n_params),
                              generator=gen, device=self.device)
        return RoundDraws(z[:pcfg.n_d, :m], z[:pcfg.n_g, :big_m], idx,
                          quant_u, drop_u, byz)


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
    Returns (stacked discs, stacked opt states, (K,) last objectives).
    """
    n_devices = data_stacked.shape[0]
    opt = make_optimizer(pcfg.optimizer, pcfg.lr_d)
    discs = [disc_params] * n_devices
    opts = [tree_index(disc_opt_stacked, k) for k in range(n_devices)]
    objs = [None] * n_devices
    for j in range(pcfg.n_d):
        with torch.no_grad():
            fake = spec.gen_apply(gen_params, draws.z_dev[j])
        for k in range(n_devices):
            x = data_stacked[k][draws.idx[j, k]]

            def neg_obj(phi):
                return -losses.disc_objective(spec.disc_real(phi, x),
                                              spec.disc_fake(phi, fake))

            loss, grads = _value_and_grad(neg_obj, discs[k])
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
    differentiated."""
    opt = make_optimizer(pcfg.optimizer, pcfg.lr_g)
    gen, obj = gen_params, None
    for j in range(pcfg.n_g):
        z = draws.z_srv[j]

        def objective(theta):
            fake = spec.gen_apply(theta, z)
            return losses.gen_objective(spec.disc_fake(disc_params, fake),
                                        variant=spec.gen_loss_variant)

        obj, grads = _value_and_grad(objective, gen)
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
