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

layout="mesh" runs a setting on K gloo ranks, one a paper worker
(`run_on_mesh`; on CUDA they share the card, since NCCL needs a card a
rank): every rank builds the same data, fid_fn and Trainer from the
seed, so every rank splits the run into the same chunks and makes the
same collectives, and rank 0's history makes the curve.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable

import torch

from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import Trainer
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.engine import FUSED_ALGORITHMS, LAYOUTS, MESH_ALGORITHMS
from repro_torch.data import DATASET_SPECS, make_image_dataset, partition
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
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
    # the run's `RoundRecord`s (masks, weights, metrics), kept out of
    # the written curve
    records: list = dataclasses.field(default=None, repr=False,
                                      compare=False)

    def as_dict(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "records"}


def _timed(fn, device):
    """(fn(device), the seconds it took)."""
    t0 = time.perf_counter()
    out = fn(device)
    return out, time.perf_counter() - t0


def _mesh_rank(fns, settings, rank, world_size, device):
    """One rank of `run_on_mesh`: the caller's float32 settings, one host
    thread (the ranks share the host's cores), then each `fn(device)`
    in turn, timed."""
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
    torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]
    torch.set_num_threads(1)
    return [_timed(fn, device) for fn in fns]


def run_on_mesh(fns, k: int, device=None, timeout_s: float = 900.0):
    """Each `fn(device)` of `fns`, in turn, on the same k ranks of a gloo
    group, started once by `launch.mesh.spawn` (on CUDA the ranks share
    the card); returns rank 0's [(result, seconds)], start-up excluded.
    Each fn must be picklable (a module-level function or a
    `functools.partial` of one) and build a `Trainer(layout="mesh")`.
    The ranks take the caller's TF32 and cuDNN-determinism settings."""
    settings = dict(matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                    cudnn_tf32=torch.backends.cudnn.allow_tf32,
                    cudnn_deterministic=torch.backends.cudnn.deterministic)
    return mesh.spawn(functools.partial(_mesh_rank, list(fns), settings), k,
                      device=resolve_device(device).type, backend="gloo",
                      timeout_s=timeout_s)[0]


@dataclasses.dataclass(frozen=True)
class Setting:
    """One figure setting: `run_experiment`'s keyword arguments, with
    `benchmarks.common.run_experiment`'s defaults."""
    dataset: str = "celeba"
    algorithm: str = "proposed"
    schedule: str = "serial"
    k: int = 10
    scheduler: str = "all"
    ratio: float = 1.0
    rounds: int | None = None
    seed: int = 0
    channel_kw: dict | None = None
    gen_loss: str = "nonsaturating"
    driver: str | None = None
    bits: int = 16
    layout: str = "stacked"
    faults: object = None
    reducer: object = None

    def resolved(self) -> dict:
        """The setting as a dict, with the module's settings resolved in
        the caller: what every rank of a mesh run builds."""
        driver = self.driver or DRIVER
        if driver == "fused" and self.algorithm not in FUSED_ALGORITHMS:
            # REPRO_BENCH_DRIVER=fused applies to every figure's settings;
            # algorithms without a fused path (centralized) keep the host
            # loop instead of aborting the sweep.
            driver = "host"
        return {**{f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)},
                "rounds": self.rounds or ROUNDS, "driver": driver,
                "eval_every": EVAL_EVERY, "full": FULL}


def _run_setting(setting, device):
    """The Trainer run of one figure setting (`Setting.resolved`) on
    `device`: its history."""
    if setting["full"] != FULL:
        raise RuntimeError("REPRO_BENCH_FULL differs between the caller "
                           "and this rank")
    ds = dataset_for(setting["dataset"])
    cfg = dcgan_for(ds)
    spec = make_dcgan_spec(cfg, gen_loss_variant=setting["gen_loss"])
    k, seed = setting["k"], setting["seed"]
    pcfg = protocol_for(schedule=setting["schedule"], k=k,
                        scheduler=setting["scheduler"],
                        ratio=setting["ratio"], bits=setting["bits"])
    n = 1280 if FULL else 320
    imgs, _ = make_image_dataset(ds, n, seed=seed)
    shards = partition(imgs, k, seed=seed)
    fid_fn = make_fid_fn(cfg, imgs, device)

    # FLOP estimates for the channel-time model (fwd+bwd ~ 3x fwd; DCGAN
    # fwd ~ 2 * params * pixels_factor — a coarse constant is fine, the
    # figures compare RELATIVE times)
    step_flops = 6.0 * 3.5e6 * (64 if FULL else 16)

    chan = ChannelConfig(n_devices=k, seed=seed,
                         **(setting["channel_kw"] or {}))
    trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg), shards,
                      seed=seed, algorithm=setting["algorithm"],
                      channel_cfg=chan, disc_step_flops=step_flops,
                      gen_step_flops=step_flops, driver=setting["driver"],
                      layout=setting["layout"], faults=setting["faults"],
                      reducer=setting["reducer"], device=device)
    return trainer.run(setting["rounds"], eval_every=setting["eval_every"],
                       fid_fn=fid_fn)


def run_experiment(label: str, *, device=None, **kw) -> Curve:
    """One Trainer run of a figure's setting: `Setting`'s fields as
    keywords, plus `device` (CUDA unless it names another).
    layout="mesh" runs it on k gloo ranks (module docstring); the curve
    carries rank 0's records."""
    layout = kw.pop("layout", "stacked")
    return run_experiments([(label, kw)], layout=layout,
                           device=device)[0][0]


def run_experiments(runs, *, layout="stacked", device=None):
    """`run_experiment(label, **kw)` for each (label, kw) of `runs` (kw
    without the layout), in turn, on `layout`; on the mesh layout every
    run takes the same ranks, started once (their k must agree). Returns
    [(Curve, seconds)]: each run's seconds with its set-up and FID (on
    the mesh, rank 0's)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r} is not ported; the port "
                         f"runs {LAYOUTS}")
    settings = [Setting(**kw, layout=layout).resolved() for _, kw in runs]
    if layout == "mesh":
        for setting in settings:
            if setting["algorithm"] not in MESH_ALGORITHMS:
                raise ValueError(
                    f"layout='mesh' is not supported for algorithm "
                    f"{setting['algorithm']!r} (mesh algorithms: "
                    f"{MESH_ALGORITHMS}); use layout='stacked'")
        ks = {setting["k"] for setting in settings}
        if len(ks) != 1:
            raise ValueError(f"the mesh runs of one call share their "
                             f"ranks: k {sorted(ks)}")
        done = run_on_mesh([functools.partial(_run_setting, setting)
                            for setting in settings], ks.pop(), device)
    else:
        device = resolve_device(device)
        done = [_timed(functools.partial(_run_setting, setting), device)
                for setting in settings]
    return [(Curve(label=label, rounds=[r.round for r in hist],
                   wallclock=[r.cumulative_s for r in hist],
                   fid=[r.fid for r in hist], records=hist), secs)
            for (label, _), (hist, secs) in zip(runs, done)]


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
