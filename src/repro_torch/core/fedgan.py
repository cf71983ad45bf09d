"""FedGAN baseline [9] (Rasouli, Sun, Rajagopal, arXiv:2006.07228).
Port of `repro.core.fedgan` for the stacked layout.

Each device trains BOTH a local generator and a local discriminator for
n_d local iterations (each iteration: one discriminator ascent step,
then one generator descent step against the freshly updated
discriminator, on local data); the server only averages the two
parameter sets. Each device does ~2x the computation of the proposed
framework per round and uploads ~2x the bytes (theta AND phi) — the
asymmetry Fig. 5 measures.

The draws are the proposed round's (`protocol.RoundDraws`): iteration j
of device k uses the shared noise `z_dev[j]` and the sample indices
`idx[j, k]`. Every device has its own generator, so no fake batch is
shared between devices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import losses, quantize
from repro_torch.core.averaging import broadcast_like, weighted_average
from repro_torch.core.protocol import (GanModelSpec, RoundDraws,
                                       _check_draws, _value_and_grad,
                                       corrupt_uploads, rounds)
from repro_torch.device import resolve_device
from repro_torch.optim import apply_updates, make_optimizer
from repro_torch.tree import tree_index, tree_map, tree_stack


def fedgan_device_update(spec: GanModelSpec, pcfg: ProtocolConfig, gen0,
                         disc0, gen_opt, disc_opt, data_local, z_dev, idx):
    """n_d local iterations of (disc step, gen step) on one device's
    shard. z_dev: (n_d, m, nz) shared noise; idx: (n_d, m) this device's
    sample indices. Returns (gen, disc, gen_opt, disc_opt)."""
    d_opt = make_optimizer(pcfg.optimizer, pcfg.lr_d)
    g_opt = make_optimizer(pcfg.optimizer, pcfg.lr_g)
    gen, disc = gen0, disc0
    for j in range(pcfg.n_d):
        x, z = data_local[idx[j]], z_dev[j]

        # discriminator ascent on eq (2)
        with torch.no_grad():
            fake = spec.gen_apply(gen, z)

        def neg_obj(phi):
            return -losses.disc_objective(spec.disc_real(phi, x),
                                          spec.disc_fake(phi, fake))

        _, d_grads = _value_and_grad(neg_obj, disc)
        d_updates, disc_opt = d_opt.update(d_grads, disc_opt)
        disc = apply_updates(disc, d_updates)

        # generator descent on eq (1) against the freshly updated disc
        def gen_obj(theta):
            return losses.gen_objective(
                spec.disc_fake(disc, spec.gen_apply(theta, z)),
                variant=spec.gen_loss_variant)

        _, g_grads = _value_and_grad(gen_obj, gen)
        g_updates, gen_opt = g_opt.update(g_grads, gen_opt)
        gen = apply_updates(gen, g_updates)
    return gen, disc, gen_opt, disc_opt


def fedgan_round(spec: GanModelSpec, pcfg: ProtocolConfig, state,
                 data_stacked, weights, draws: RoundDraws, *, faults=None,
                 reducer=None):
    """One FedGAN communication round: local joint updates on every
    device, then the server averages BOTH nets.

    The uplink quantizer and the fault program act on the combined
    {"gen", "disc"} payload ("disc" first in leaf order, so in the
    quantizer's uniforms and the byzantine normals too). With a reducer
    the combined payload goes through ONE robust reduction; without one
    each net is averaged on its own (two wavg launches). A no-survivor
    round keeps both previous nets. Returns (new_state, metrics) with
    metrics {"participation"}."""
    n_devices = weights.shape[0]
    _check_draws(pcfg, draws, n_devices)
    ups = [fedgan_device_update(
        spec, pcfg, state["gen"], state["disc"],
        tree_index(state["gen_opt"], k), tree_index(state["disc_opt"], k),
        data_stacked[k], draws.z_dev, draws.idx[:, k])
        for k in range(n_devices)]
    new_gens, new_discs, new_gen_opt, new_disc_opt = (
        tree_stack([u[i] for u in ups]) for i in range(4))

    payload = quantize.roundtrip_stacked(
        draws.quant_u, {"gen": new_gens, "disc": new_discs},
        pcfg.quantize_bits)

    payload = corrupt_uploads(payload, draws, state, faults)

    prev = {"gen": state["gen"], "disc": state["disc"]}
    if reducer is not None:
        avg = weighted_average(payload, weights, robust=reducer,
                               fallback=prev)
    else:
        avg = {name: weighted_average(payload[name], weights,
                                      fallback=prev[name])
               for name in ("gen", "disc")}
    new_state = {"gen": avg["gen"], "disc": avg["disc"],
                 "gen_opt": new_gen_opt, "disc_opt": new_disc_opt}
    if "fault" in state:
        new_state["fault"] = {"stale": prev}
    return new_state, {"participation": (weights.float() > 0).float().mean()}


def fedgan_rounds(spec: GanModelSpec, pcfg: ProtocolConfig, state,
                  data_stacked, n_rounds: int, *, faults=None, reducer=None,
                  **kw):
    """`n_rounds` fused FedGAN rounds (see `protocol.rounds`, which takes
    the keyword arguments): the same engine as the proposed protocol,
    with FedGAN's two-net upload payload and its Fig. 5 timing and
    wallclock. Port of `repro.core.fedgan.fedgan_rounds_scan`."""
    round_fn = lambda st, d, w, draws: fedgan_round(
        spec, pcfg, st, d, w, draws, faults=faults, reducer=reducer)
    return rounds(round_fn, pcfg, state, data_stacked, n_rounds,
                  fedgan=True, faults=faults, **kw)


def make_fedgan_state(init_fn, pcfg: ProtocolConfig, n_devices: int, *,
                      seed: int = 0, device=None):
    """init_fn(generator) -> {"gen", "disc"}, called with a
    `torch.Generator` seeded from `seed` on `device` (CUDA unless the
    caller names another). Both optimizer states are per device,
    stacked K."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tree_map(lambda x: x.to(device), init_fn(gen))
    g_opt = make_optimizer(pcfg.optimizer, pcfg.lr_g).init(params["gen"])
    d_opt = make_optimizer(pcfg.optimizer, pcfg.lr_d).init(params["disc"])
    return {"gen": params["gen"], "disc": params["disc"],
            "gen_opt": broadcast_like(g_opt, n_devices),
            "disc_opt": broadcast_like(d_opt, n_devices)}
