"""Wireless system simulator (paper Section IV settings).

Small cell of radius 300 m, server at the center, K devices uniformly
placed. Path loss 128.1 + 37.6 log10(d_km) dB, noise PSD -174 dBm/Hz,
device Tx 24 dBm, server Tx 46 dBm, 10 MHz bandwidth, 16 bits per
parameter. Per-round Rayleigh fading gives rate variability; uploads
that exceed the round deadline mark the device a straggler (footnote 1).

This module accounts *wall-clock time* per communication round for both
proposed schedules and for FedGAN — the x-axis of the paper's figures.

A numpy copy of `repro.core.channel`. Keep the order of the generator
calls as it is: `Trainer._run_host` draws `uplink_rates` once for the
scheduler and `round_timing` draws it again, so rates, masks and the
wallclock match the JAX host driver bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ChannelConfig:
    n_devices: int = 10
    cell_radius_m: float = 300.0
    bandwidth_hz: float = 10e6
    noise_psd_dbm_hz: float = -174.0
    device_tx_dbm: float = 24.0
    server_tx_dbm: float = 46.0
    bits_per_param: int = 16
    # compute-speed constants (device vs server), FLOP/s
    device_flops: float = 1e12
    server_flops: float = 10e12
    fading: bool = True
    straggler_deadline_s: float = float("inf")
    seed: int = 0


@dataclasses.dataclass
class RoundTiming:
    compute_dev_s: np.ndarray      # (K,) local discriminator compute
    upload_s: np.ndarray           # (K,) local model upload
    compute_srv_s: float           # generator update
    broadcast_s: float             # global model broadcast
    stragglers: np.ndarray         # (K,) bool — missed the deadline


class ChannelSimulator:
    def __init__(self, cfg: ChannelConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # uniform placement in the disc (radius via sqrt for uniform density)
        r = cfg.cell_radius_m * np.sqrt(rng.uniform(0.05, 1.0, cfg.n_devices))
        self.dist_km = r / 1000.0
        self.rng = rng

    def path_loss_db(self):
        return 128.1 + 37.6 * np.log10(self.dist_km)

    def uplink_rates(self, n_scheduled: int) -> np.ndarray:
        """(K,) bits/s if scheduled now, equal OFDMA split of the band."""
        cfg = self.cfg
        bw = cfg.bandwidth_hz / max(n_scheduled, 1)
        noise_w = 10 ** ((cfg.noise_psd_dbm_hz - 30) / 10) * bw
        tx_w = 10 ** ((cfg.device_tx_dbm - 30) / 10)
        gain = 10 ** (-self.path_loss_db() / 10)
        if cfg.fading:
            gain = gain * self.rng.exponential(1.0, cfg.n_devices)
        snr = tx_w * gain / noise_w
        return bw * np.log2(1.0 + snr)

    def downlink_rate(self) -> float:
        """Broadcast rate, limited by the worst scheduled device."""
        cfg = self.cfg
        noise_w = 10 ** ((cfg.noise_psd_dbm_hz - 30) / 10) * cfg.bandwidth_hz
        tx_w = 10 ** ((cfg.server_tx_dbm - 30) / 10)
        gain = 10 ** (-self.path_loss_db() / 10)
        snr = tx_w * gain / noise_w
        return float(cfg.bandwidth_hz * np.min(np.log2(1.0 + snr)))

    # ------------------------------------------------------------------
    def round_timing(self, *, mask: np.ndarray, disc_params: int,
                     gen_params: int, disc_step_flops: float,
                     gen_step_flops: float, n_d: int, n_g: int,
                     fedgan: bool = False,
                     uplink_bits: float | None = None,
                     compute_mult: np.ndarray | None = None) -> RoundTiming:
        """Wall-clock pieces of one communication round.

        uplink_bits: total per-device upload payload in bits (e.g.
        `quantize.tree_bits` at the protocol's quantization width);
        None falls back to `bits_per_param` x the uploaded param count.
        compute_mult: optional (K,) per-device local-compute multiplier
        (core/faults.py — stragglers > 1, free-riders replaying stale
        uploads spend 0 compute).
        """
        cfg = self.cfg
        rates = self.uplink_rates(int(mask.sum()))
        up_bits = uplink_bits if uplink_bits is not None else (
            cfg.bits_per_param * (
                disc_params + gen_params if fedgan else disc_params))
        upload = np.where(mask, up_bits / np.maximum(rates, 1.0), 0.0)
        dev_flops = n_d * disc_step_flops + (n_g * gen_step_flops if fedgan else 0.0)
        compute_dev = np.where(mask, dev_flops / cfg.device_flops, 0.0)
        if compute_mult is not None:
            compute_dev = compute_dev * np.asarray(compute_mult, np.float64)
        compute_srv = 0.0 if fedgan else n_g * gen_step_flops / cfg.server_flops
        down_bits = cfg.bits_per_param * (disc_params + gen_params)
        broadcast = down_bits / self.downlink_rate()
        stragglers = mask & (upload + compute_dev > cfg.straggler_deadline_s)
        return RoundTiming(compute_dev, upload, compute_srv, broadcast,
                           stragglers)


def round_wallclock(t: RoundTiming, mask: np.ndarray, *, schedule: str,
                    fedgan: bool = False) -> float:
    """Fig. 1 / Fig. 2 composition of one round's wall-clock time."""
    active = mask & ~t.stragglers
    if not active.any():
        return float(t.broadcast_s)
    if fedgan:
        # FedGAN: local G+D compute, upload both, average (negligible), bcast
        return float(np.max((t.compute_dev_s + t.upload_s)[active])
                     + t.broadcast_s)
    if schedule == "parallel":
        # device compute overlaps server's generator compute (Fig. 1)
        dev_phase = np.max(t.compute_dev_s[active])
        return float(max(dev_phase, t.compute_srv_s)
                     + np.max(t.upload_s[active]) + t.broadcast_s)
    if schedule == "serial":
        # devices first; disc broadcast overlaps generator compute (Fig. 2)
        dev_phase = np.max((t.compute_dev_s + t.upload_s)[active])
        return float(dev_phase + max(t.compute_srv_s, t.broadcast_s * 0.5)
                     + t.broadcast_s * 0.5)
    raise ValueError(schedule)
