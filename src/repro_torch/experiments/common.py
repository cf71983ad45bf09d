"""Shared experiment harness for the paper's figures. Port of
`benchmarks/common.py`.

Each figure builds a fleet (DCGAN + synthetic dataset matched to the
paper's three datasets), runs communication rounds through the Trainer
(scheduling + channel timing + FID), and returns convergence curves
(round, wallclock_s, fid).

Scale: the default is a reduced DCGAN (32x32, ngf=ndf=16) and
REPRO_BENCH_ROUNDS rounds (default 12). The paper-faithful full-scale
settings (64x64 DCGAN 3.58M/2.77M params, n_d=n_g=5, m_k=128, K=10) are
selected with REPRO_BENCH_FULL=1. REPRO_BENCH_EVAL_EVERY sets the FID
rounds and REPRO_BENCH_DRIVER the driver ("auto": fused for the
proposed protocol and FedGAN, host for the centralized baseline). The
settings are read when this module is first imported.

FID runs on the host at eval boundaries (the port's `Trainer.run` path
for every fid_fn), through `repro_torch.metrics`, against the real
images' feature statistics computed once. Runs go to the CUDA device
unless `device` names another.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import Trainer
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.engine import FUSED_ALGORITHMS
from repro_torch.data import DATASET_SPECS, make_image_dataset, partition
from repro_torch.device import resolve_device
from repro_torch.metrics import (feature_stats, frechet_distance,
                                 make_feature_extractor)
from repro_torch.models import dcgan
from repro_torch.models.specs import make_dcgan_spec

FULL = os.environ.get("REPRO_BENCH_FULL", "0") == "1"
ROUNDS = int(os.environ.get("REPRO_BENCH_ROUNDS", "60" if FULL else "12"))
EVAL_EVERY = int(os.environ.get("REPRO_BENCH_EVAL_EVERY", "4"))
DRIVER = os.environ.get("REPRO_BENCH_DRIVER", "auto")
# where the figures write their curves (relative to the working directory)
OUT_DIR = os.path.join("results", "torch", "bench")


def dataset_for(name: str):
    """Map the paper's dataset names onto synthetic stand-ins."""
    if FULL:
        return {"celeba": "celeba", "cifar10": "cifar10",
                "rsna": "rsna"}[name]
    return {"celeba": "celeba32", "cifar10": "cifar10",
            "rsna": "rsna32"}[name]


def dcgan_for(dataset: str) -> DCGANConfig:
    spec = DATASET_SPECS[dataset]
    if FULL:
        return DCGANConfig(nz=100, ngf=64, ndf=64, nc=spec.channels,
                           image_size=spec.image_size)
    return DCGANConfig(nz=32, ngf=16, ndf=16, nc=spec.channels,
                       image_size=spec.image_size)


def protocol_for(*, schedule="serial", k=10, scheduler="all", ratio=1.0,
                 optimizer="adam", bits=16) -> ProtocolConfig:
    # paper: n_d = n_g = 5, m_k = 128, 16-bit uplink; reduced keeps the
    # ratio structure
    return ProtocolConfig(
        n_devices=k,
        n_d=5 if FULL else 2,
        n_g=5 if FULL else 2,
        sample_size=128 if FULL else 16,
        server_sample_size=128 if FULL else 16,
        lr_d=2e-4 if optimizer == "adam" else 2e-3,
        lr_g=2e-4 if optimizer == "adam" else 2e-3,
        schedule=schedule,
        scheduler=scheduler,
        scheduling_ratio=ratio,
        quantize_bits=bits,
        optimizer=optimizer,
    )


def make_fid_fn(cfg: DCGANConfig, imgs, device) -> Callable:
    """The Trainer's fid_fn for a DCGAN generator: the FID of 256 z
    draws against the first 512 of `imgs`, whose feature statistics are
    computed once, on `device`."""
    feat = make_feature_extractor(cfg.nc, device=device)
    with torch.no_grad():
        real_mu, real_cov = feature_stats(
            feat(torch.as_tensor(imgs[:512], device=device)))

    def fid_fn(gen_params, generator):
        z = torch.randn((256, cfg.nz), generator=generator, device=device)
        with torch.no_grad():
            mu, cov = feature_stats(feat(dcgan.generator_apply(
                gen_params, cfg, z)))
        return frechet_distance(real_mu, real_cov, mu, cov)
    return fid_fn


@dataclasses.dataclass
class Curve:
    label: str
    rounds: list
    wallclock: list
    fid: list

    def as_dict(self):
        return dataclasses.asdict(self)


def run_experiment(label: str, *, dataset="celeba", algorithm="proposed",
                   schedule="serial", k=10, scheduler="all", ratio=1.0,
                   rounds=None, seed=0, channel_kw=None,
                   gen_loss="nonsaturating", driver=None,
                   bits=16, layout="stacked", faults=None,
                   reducer=None, device=None) -> Curve:
    """One Trainer run of a figure's setting; the arguments are
    `benchmarks.common.run_experiment`'s, plus `device` (CUDA unless it
    names another). The stacked layout only: the mesh figure runs wait
    for ROADMAP A item 6."""
    if layout != "stacked":
        raise ValueError(
            f"layout={layout!r}: the port's figure runs take the stacked "
            f"layout; the mesh figure runs wait for ROADMAP A item 6")
    device = resolve_device(device)
    ds = dataset_for(dataset)
    cfg = dcgan_for(ds)
    spec = make_dcgan_spec(cfg, gen_loss_variant=gen_loss)
    pcfg = protocol_for(schedule=schedule, k=k, scheduler=scheduler,
                        ratio=ratio, bits=bits)
    n = 1280 if FULL else 320
    imgs, _ = make_image_dataset(ds, n, seed=seed)
    shards = partition(imgs, k, seed=seed)
    fid_fn = make_fid_fn(cfg, imgs, device)

    # FLOP estimates for the channel-time model (fwd+bwd ~ 3x fwd; DCGAN
    # fwd ~ 2 * params * pixels_factor — a coarse constant is fine, the
    # figures compare RELATIVE times)
    step_flops = 6.0 * 3.5e6 * (64 if FULL else 16)

    chan = ChannelConfig(n_devices=k, seed=seed, **(channel_kw or {}))
    resolved_driver = driver or DRIVER
    if resolved_driver == "fused" and algorithm not in FUSED_ALGORITHMS:
        # REPRO_BENCH_DRIVER=fused applies to every figure's settings;
        # algorithms without a fused path (centralized) keep the host
        # loop instead of aborting the sweep.
        resolved_driver = "host"
    trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg), shards,
                      seed=seed, algorithm=algorithm, channel_cfg=chan,
                      disc_step_flops=step_flops, gen_step_flops=step_flops,
                      driver=resolved_driver, faults=faults,
                      reducer=reducer, device=device)
    hist = trainer.run(rounds or ROUNDS, eval_every=EVAL_EVERY,
                       fid_fn=fid_fn)
    return Curve(
        label=label,
        rounds=[r.round for r in hist],
        wallclock=[r.cumulative_s for r in hist],
        fid=[r.fid for r in hist],
    )


def last_fid(curve: Curve):
    vals = [f for f in curve.fid if f is not None]
    return vals[-1] if vals else float("nan")


def emit_csv_row(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}")


def device_arg(parser):
    """The figures' --device option: CUDA unless it names another."""
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
