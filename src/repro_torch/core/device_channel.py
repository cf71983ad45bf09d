"""The channel simulator as tensor code on the round's device (paper
Section IV wireless system), for the fused driver. Port of
`repro.core.jax_channel`.

The device placement, the path loss and the fading-free downlink rate
come from the numpy `ChannelSimulator` of the same config (host-side,
float64), so a `DeviceChannel(cfg)` sees the exact distances of its
numpy twin. Everything per round is float32 tensor math with no host
sync. Rayleigh fading enters as Exp(1) draws that the caller makes
before the round (`protocol.RoundSlots.fading`): the same marginal as
the numpy stream but other draws, so fading quantities agree in
distribution only. With `fading=False` every output matches the numpy
simulator to float32 round-off, and the JAX package's `JaxChannel` to
its own float32 arithmetic.

Python scalars enter as float32 tensors (as JAX's weakly typed scalars
do): `scalar / tensor` in PyTorch multiplies by a reciprocal, so every
division here is a tensor division.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.channel import ChannelConfig, ChannelSimulator


class DeviceRoundTiming(NamedTuple):
    compute_dev_s: torch.Tensor    # (K,) local discriminator compute
    upload_s: torch.Tensor         # (K,) local model upload
    compute_srv_s: torch.Tensor    # 0-dim: generator update
    broadcast_s: torch.Tensor      # 0-dim: global model broadcast
    stragglers: torch.Tensor       # (K,) bool: missed the deadline


class DeviceChannel:
    """The channel simulator over a fixed device placement, as float32
    tensors on `device`."""

    def __init__(self, cfg: ChannelConfig, device):
        self.cfg, self.device = cfg, torch.device(device)
        sim = ChannelSimulator(cfg)
        self.gain = torch.tensor(10.0 ** (-sim.path_loss_db() / 10.0),
                                 dtype=torch.float32, device=self.device)
        self.downlink_rate_s = sim.downlink_rate()

    def _f32(self, value) -> torch.Tensor:
        """A 0-dim float32 constant, filled on the device (no copy from
        the host, so a captured round may make it)."""
        return torch.full((), value, dtype=torch.float32, device=self.device)

    def uplink_rates(self, fading, n_scheduled):
        """(K,) bits/s under an equal OFDMA split of the band among
        `n_scheduled` (an int or a 0-dim tensor, e.g. mask.sum()).
        `fading`: (K,) Exp(1) draws, or None when cfg.fading is off."""
        cfg = self.cfg
        n = (n_scheduled.float() if torch.is_tensor(n_scheduled)
             else self._f32(n_scheduled))
        bw = self._f32(cfg.bandwidth_hz) / torch.clamp(n, min=1.0)
        noise_w = 10 ** ((cfg.noise_psd_dbm_hz - 30) / 10) * bw
        tx_w = 10 ** ((cfg.device_tx_dbm - 30) / 10)
        gain = self.gain
        if cfg.fading:
            gain = gain * fading
        snr = tx_w * gain / noise_w
        return bw * torch.log2(1.0 + snr)

    def round_timing(self, fading, mask, *, disc_params: int,
                     gen_params: int, disc_step_flops: float,
                     gen_step_flops: float, n_d: int, n_g: int,
                     fedgan: bool = False, uplink_bits=None,
                     compute_mult=None) -> DeviceRoundTiming:
        """Wall-clock pieces of one round, from a fresh fading draw
        (`fading`, the round's second one, as the numpy twin's second
        `uplink_rates` call). `uplink_bits` overrides the per-device
        upload payload; `compute_mult` is the optional (K,) float32
        per-device compute multiplier (core/faults.py)."""
        cfg = self.cfg
        rates = self.uplink_rates(fading, mask.sum())
        up_bits = uplink_bits if uplink_bits is not None else (
            cfg.bits_per_param * (
                disc_params + gen_params if fedgan else disc_params))
        zero = self._f32(0.0)
        upload = torch.where(mask, self._f32(up_bits)
                             / torch.clamp(rates, min=1.0), zero)
        dev_flops = n_d * disc_step_flops + (
            n_g * gen_step_flops if fedgan else 0.0)
        compute_dev = torch.where(
            mask, self._f32(dev_flops / cfg.device_flops), zero)
        if compute_mult is not None:
            compute_dev = compute_dev * compute_mult
        compute_srv = self._f32(
            0.0 if fedgan else n_g * gen_step_flops / cfg.server_flops)
        down_bits = cfg.bits_per_param * (disc_params + gen_params)
        broadcast = self._f32(down_bits / self.downlink_rate_s)
        stragglers = mask & (upload + compute_dev
                             > self._f32(cfg.straggler_deadline_s))
        return DeviceRoundTiming(compute_dev, upload, compute_srv, broadcast,
                                 stragglers)


def round_wallclock(t: DeviceRoundTiming, mask, *, schedule: str,
                    fedgan: bool = False):
    """Fig. 1 / Fig. 2 wall-clock composition of one round, a 0-dim
    float32 tensor (port of `jax_channel.round_wallclock`)."""
    active = mask & ~t.stragglers
    neg_inf = torch.full((), float("-inf"), device=mask.device)

    def masked_max(x):
        return torch.max(torch.where(active, x, neg_inf))

    if fedgan:
        wall = masked_max(t.compute_dev_s + t.upload_s) + t.broadcast_s
    elif schedule == "parallel":
        wall = (torch.maximum(masked_max(t.compute_dev_s), t.compute_srv_s)
                + masked_max(t.upload_s) + t.broadcast_s)
    elif schedule == "serial":
        wall = (masked_max(t.compute_dev_s + t.upload_s)
                + torch.maximum(t.compute_srv_s, t.broadcast_s * 0.5)
                + t.broadcast_s * 0.5)
    else:
        raise ValueError(schedule)
    return torch.where(active.any(), wall, t.broadcast_s).float()
