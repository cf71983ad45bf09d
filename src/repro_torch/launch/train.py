"""Cluster launcher: protocol training rounds through the launch layer's
train step (`launch/steps.py`). Port of `repro.launch.train`, with its
flags, refusals, defaults, resume rules and per-chunk line:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --data-dim 4 --rounds 4 --seq-len 64 --batch 32 --fuse-rounds 2
    # on the CPU, the mesh layout on 2 gloo ranks
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --device cpu --data-dim 2 --batch 4 --seq-len 16 \\
        --layout mesh

Execution layouts (see `launch.steps.build_train_step`):

  --layout stacked  the K = --data-dim workers stacked on one card
                    (default); --fuse-rounds > 1 replays each round of a
                    chunk as one captured CUDA graph (`core/graphs.py`)
  --layout mesh     --data-dim x --tp gloo ranks (`launch.mesh.spawn`,
                    sharing the card, or the CPU), one worker a rank, a
                    model group of --tp ranks a worker at --tp > 1; rank
                    0 prints and checkpoints the global state, which is
                    global-shaped at every --tp, so --resume works
                    across TP widths

Every float leaf of the state is bfloat16 (`steps.COMPUTE_DTYPE`): the
float32 init is cast, as the JAX launcher casts it. Both layouts chunk
--rounds into --fuse-rounds-sized calls, the remainder as a shorter last
chunk (a step of its own length, `chunk_lengths`). Checkpoints
(`--ckpt-dir`, `--ckpt-every`) carry the state, the scheduler carry, the
absolute round index and the simulated wallclock in the JAX package's
format and tree, so `--resume` continues exactly and crosses packages.
A write overlaps the next chunk (`AsyncCheckpointer`).

Port-only: `--device` (default CUDA; the run fails without one unless
`--device cpu` is given). Refused, each with the ROADMAP item that
would bring it: `--model-dim`, the GSPMD model axis of the stacked
layout (item 10c; the mesh layout's model axis is --tp), and
`--distributed`, several machines (item 1).
"""
from __future__ import annotations

import argparse
import functools
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch_config, list_archs
from repro_torch.configs.base import ProtocolConfig, ShapeConfig
from repro_torch.core import engine
from repro_torch.core.device_scheduling import DeviceScheduler
from repro_torch.core.faults import FaultConfig, attach_fault_state
from repro_torch.data import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.robust_avg.ops import RobustConfig
from repro_torch.launch import mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.models import gan as gan_model
from repro_torch.tree import tree_leaves, tree_map


class AsyncCheckpointer:
    """Overlap checkpoint writes with the next training chunk.

    `submit` takes a device-side `clone()` of every tensor of the tree
    (a captured replay updates the live tensors in place,
    `graphs.copy_into`, so the write must not read them) and a copy of
    every host value, returns, and writes the copy from a background
    thread through `repro_torch.checkpoint.save_checkpoint`. One write
    is in flight at a time; `finish()` waits for it and raises a
    RuntimeError from its error, if it failed."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread = None
        self._error = None

    def submit(self, step_index: int, state, metadata=None):
        self.finish()
        snapshot = tree_map(lambda x: x.clone() if torch.is_tensor(x)
                            else np.copy(x), state)

        def _write():
            try:
                save_checkpoint(self.directory, step_index, snapshot,
                                metadata=metadata)
            except BaseException as e:   # re-raised at the next finish()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def finish(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write to {self.directory} failed") from err


def chunk_lengths(rounds: int, fuse: int):
    """`rounds` split into fuse-sized calls and a shorter remainder
    chunk (each distinct length is a step of its own)."""
    chunks = [fuse] * (rounds // fuse)
    if rounds % fuse:
        chunks.append(rounds % fuse)
    return chunks


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Protocol training rounds through the launch layer's "
                    "train step (bfloat16 state).")
    ap.add_argument("--arch", choices=list_archs(), default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU debugging)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--data-dim", type=int, default=4)
    ap.add_argument("--model-dim", type=int, default=None,
                    help="the JAX launcher's GSPMD model axis (layout "
                         "stacked): not ported (ROADMAP item 10c), "
                         "refused; the mesh layout's model axis is --tp")
    ap.add_argument("--tp", type=int, default=1,
                    help="layout mesh only: every worker a model group of "
                         "this many gloo ranks (Megatron feed-forward, "
                         "state sharded, per-rank Algorithm-2 payload "
                         "1/tp); checkpoints are global-shaped, so "
                         "--resume works across --tp widths")
    ap.add_argument("--schedule", choices=["serial", "parallel"],
                    default="serial")
    ap.add_argument("--layout", choices=["stacked", "mesh"],
                    default="stacked",
                    help="stacked = the K workers on one card; mesh = a "
                         "gloo rank a worker")
    ap.add_argument("--algorithm", choices=["proposed", "fedgan"],
                    default="proposed",
                    help="proposed = the paper's protocol; fedgan = the "
                         "two-net FedGAN baseline (layout mesh only on "
                         "this builder)")
    ap.add_argument("--fuse-rounds", type=int, default=1,
                    help="rounds a step call; any --rounds works — the "
                         "remainder runs as a shorter final chunk")
    ap.add_argument("--quantize-bits", type=int, default=16,
                    help="uplink quantization width (paper: 16; >=32 "
                         "disables quantization)")
    ap.add_argument("--avg-impl", choices=["pallas", "jnp", "ring"],
                    default="pallas",
                    help="Algorithm-2 collective (layout mesh only): "
                         "pallas = flat all-gather + the wavg kernel; jnp "
                         "= per-leaf all-reduce; ring = the chunked ring "
                         "with the payload encoded on the wire (the "
                         "ring_accum kernel; tp=1, plain mean, no "
                         "free-riders/byzantine)")
    ap.add_argument("--reducer", default="mean",
                    choices=["mean", "trimmed_mean", "norm_clip", "krum"],
                    help="server aggregation rule (layout mesh only)")
    ap.add_argument("--trim", type=int, default=1,
                    help="--reducer trimmed_mean: extreme pairs removed "
                         "per coordinate")
    ap.add_argument("--clip-factor", type=float, default=2.0,
                    help="--reducer norm_clip: clip uploads to this "
                         "multiple of the median participant norm")
    ap.add_argument("--krum-f", type=int, default=1,
                    help="--reducer krum: assumed byzantine count f")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="fault injection: per-round iid worker dropout "
                         "probability (layout mesh only)")
    ap.add_argument("--free-riders", type=int, default=0,
                    help="fault injection: workers replaying the stale "
                         "round-start global model instead of training")
    ap.add_argument("--byzantine", type=int, default=0,
                    help="fault injection: workers uploading scaled "
                         "Gaussian noise")
    ap.add_argument("--byz-scale", type=float, default=10.0,
                    help="byzantine noise scale (x N(0,1))")
    ap.add_argument("--straggler-factor", type=float, default=1.0,
                    help="fault injection: per-worker compute slowdown "
                         "~ U[1, factor] fed into the wallclock model")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the static fault roles")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N rounds (0 = final only); "
                         "writes overlap the next chunk")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir "
                         "(state + scheduler carry + round index + sim "
                         "wallclock) and continue to --rounds")
    ap.add_argument("--distributed", action="store_true",
                    help="several machines: not ported (ROADMAP item 1), "
                         "refused")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def _checked_args(argv):
    """Parse argv and refuse, in the JAX launcher's order and words,
    what it refuses (exit code 2), then what the port has not ported.
    Returns (args, faults, reducer)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.algorithm != "proposed" and args.layout != "mesh":
        ap.error("--algorithm fedgan requires --layout mesh on this "
                 "builder (stacked FedGAN runs through core.engine.Trainer)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1 and args.layout != "mesh":
        ap.error("--tp applies to --layout mesh (stacked tensor "
                 "parallelism is --model-dim through GSPMD)")
    if args.layout == "mesh" and args.model_dim is not None:
        ap.error("--model-dim applies to --layout stacked; the mesh "
                 "layout's model axis is --tp (refusing to silently "
                 "reinterpret the mesh shape)")

    faults = None
    if (args.dropout > 0.0 or args.free_riders > 0 or args.byzantine > 0
            or args.straggler_factor > 1.0):
        faults = FaultConfig(
            n_devices=args.data_dim, dropout_prob=args.dropout,
            n_free_riders=args.free_riders, n_byzantine=args.byzantine,
            byz_scale=args.byz_scale,
            straggler_factor=args.straggler_factor, seed=args.fault_seed)
    reducer = None
    if args.reducer != "mean":
        reducer = RobustConfig(method=args.reducer, trim=args.trim,
                               clip_factor=args.clip_factor,
                               krum_f=args.krum_f)
    if (faults is not None or reducer is not None) \
            and args.layout != "mesh":
        ap.error("fault injection / robust reducers run on the fused "
                 "mesh engine: use --layout mesh")
    if (faults is not None or reducer is not None) and args.tp > 1:
        ap.error("faults/robust reducers are not supported under tensor "
                 "parallelism yet; use --tp 1")
    if args.avg_impl != "pallas" and args.layout != "mesh":
        ap.error("--avg-impl selects the mesh layout's Algorithm-2 "
                 "collective: use --layout mesh")
    if args.avg_impl == "ring":
        if args.tp > 1:
            ap.error("--avg-impl ring is not supported under tensor "
                     "parallelism; use --tp 1")
        if reducer is not None:
            ap.error("--avg-impl ring does not compose with robust "
                     "reducers; use --avg-impl pallas")
        if args.free_riders > 0 or args.byzantine > 0:
            ap.error("--avg-impl ring does not compose with "
                     "upload-corrupting faults (free-riders/byzantine); "
                     "use --avg-impl pallas")

    # what the port has not ported
    if args.model_dim is not None:
        ap.error("--model-dim is the JAX launcher's GSPMD model axis of "
                 "the stacked layout, which the port does not have "
                 "(ROADMAP item 10c); use --layout mesh --tp N for "
                 "tensor parallelism")
    if args.distributed:
        ap.error("--distributed (several machines, jax.distributed) is not "
                 "ported: the port runs on one machine (ROADMAP item 1); "
                 "use --layout mesh for a rank a worker")
    return args, faults, reducer


def _train(args, faults, reducer, device, rank=None):
    """The training loop of one process: the whole run on the stacked
    layout, a rank's part of it on the mesh, where every rank takes
    part in the collectives and rank 0 prints and writes."""
    fuse = max(1, args.fuse_rounds)
    lead = rank in (None, 0)
    say = (lambda msg: print(msg, flush=True)) if lead else (lambda msg: None)
    cfg = get_arch_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("train_cli", args.seq_len, args.batch, "train")
    k_dev = args.data_dim
    mesh_layout = args.layout == "mesh"

    # a step a chunk length: the remainder chunk is a step of its own
    step_cache: dict = {}

    def get_step(length: int):
        if length not in step_cache:
            step_cache[length] = steps_mod.build_train_step(
                cfg, shape, k_dev, schedule=args.schedule,
                fuse_rounds=length, layout=args.layout,
                algorithm=args.algorithm,
                tp=args.tp if mesh_layout else None,
                pcfg_overrides={"quantize_bits": args.quantize_bits},
                faults=faults, reducer=reducer, avg_impl=args.avg_impl)
        return step_cache[length]

    first_step, abstract_args = get_step(min(fuse, args.rounds) or 1)

    # real inputs matching the abstract ones
    n_k = args.batch // k_dev
    toks, _ = make_token_dataset(args.batch, args.seq_len, cfg.vocab)
    tokens = torch.as_tensor(toks.reshape(k_dev, n_k, args.seq_len))
    batch = {"tokens": tokens}
    state_abs = abstract_args[0]
    if not mesh_layout and "enc_feats" in abstract_args[1]:
        ef = abstract_args[1]["enc_feats"]
        batch["enc_feats"] = torch.zeros(ef.shape, dtype=ef.dtype,
                                         device=device)

    pcfg = ProtocolConfig(n_devices=k_dev, n_d=2, n_g=2, sample_size=n_k,
                          server_sample_size=k_dev, schedule=args.schedule)
    weights = torch.full((k_dev,), float(n_k), device=device)
    seed = 0
    sched_carry = DeviceScheduler(policy="all",
                                  n_devices=k_dev).init_carry(device)

    def cast_like(ref, x):
        return torch.as_tensor(x).to(device, ref.dtype)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    since_ckpt = 0
    wall_total = 0.0
    start_round = 0
    if args.resume:
        tree, _, meta = load_checkpoint(args.ckpt_dir)
        # tp is not checked: checkpoints are global-shaped, so a run may
        # resume at another TP width
        for field, want in (("algorithm", args.algorithm),
                            ("layout", args.layout)):
            got = meta.get(field)
            if got is not None and got != want:
                raise SystemExit(
                    f"checkpoint {args.ckpt_dir} was saved with "
                    f"{field}={got}; refusing to resume with "
                    f"--{field.replace('_', '-')} {want}")
        if not (isinstance(tree, dict) and "state" in tree
                and "trainer" in tree):
            raise SystemExit(
                f"checkpoint {args.ckpt_dir} predates --resume support "
                f"(raw state, no trainer record); it cannot restore the "
                f"round index/scheduler carry — restart without --resume")
        # the checkpoint replaces the init: cast against the abstract
        # state instead of drawing one to throw away
        state = tree_map(cast_like, state_abs, tree["state"])
        extra = tree["trainer"]
        start_round = int(extra["round_index"])
        wall_total = float(extra["sim_wall"])
        sched_carry = tree_map(cast_like, sched_carry, extra["sched_carry"])
        say(f"resumed {args.ckpt_dir} at round {start_round} "
            f"(sim_wall={wall_total:.1f}s)")
        if start_round >= args.rounds:
            say(f"checkpoint already at round {start_round} >= "
                f"--rounds {args.rounds}; nothing to do")
            return
    else:
        algo = engine._ALGORITHMS[args.algorithm]
        state = algo.make_state(lambda g: gan_model.gan_init(g, cfg), pcfg,
                                k_dev, seed=0, device=device)
        # free-rider programs carry a stale-upload cache in the state
        state = attach_fault_state(state, faults, algo.payload)
        state = tree_map(lambda x, a: x.to(a.dtype), state, state_abs)
    if mesh_layout:
        state = first_step.rank_state(state)

    def ckpt_tree(state):
        # scheduler carry + round index + sim wallclock ride along, so a
        # resumed run continues masks and the wallclock curve exactly
        if mesh_layout:
            state = first_step.global_state(state)
        return {"state": state,
                "trainer": {"round_index": np.int64(r),
                            "sim_wall": np.float64(wall_total),
                            "sched_carry": sched_carry}}

    meta = {"layout": args.layout, "algorithm": args.algorithm,
            "tp": args.tp}
    r = start_round
    for chunk in chunk_lengths(args.rounds - start_round, fuse):
        t0 = time.time()
        step, _ = get_step(chunk)
        if mesh_layout:
            state, sched_carry, out = step(state, sched_carry, tokens,
                                           seed, r)
            metrics = out["metrics"]
            wall_total += float(np.asarray(out["wallclock_s"]).sum())
        else:
            state, metrics = step(state, batch, weights, r)
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        dt = time.time() - t0
        # metric keys are per-algorithm (FedGAN's server only averages,
        # so it reports participation, not objectives)
        stats = " ".join(
            f"{k}={np.atleast_1d(np.asarray(v))[-1]:+.4f}"
            for k, v in sorted(metrics.items()))
        label = (f"round {r}" if chunk == 1 else
                 f"rounds {r}..{r + chunk - 1}")
        extra = f" sim_wall={wall_total:.1f}s" if mesh_layout else ""
        say(f"{label}: {stats} ({dt:.2f}s, {chunk / dt:.1f} rounds/s)"
            f"{extra}")
        r += chunk
        since_ckpt += chunk
        if ckpt and args.ckpt_every and since_ckpt >= args.ckpt_every \
                and r < args.rounds:
            # a device copy now, written while the next chunk runs
            tree = ckpt_tree(state)
            if lead:
                ckpt.submit(r, tree, metadata=meta)
            since_ckpt = 0

    if ckpt:
        tree = ckpt_tree(state)
        if lead:
            ckpt.finish()
            ckpt.submit(args.rounds, tree, metadata=meta)
            ckpt.finish()
            say(f"saved {args.ckpt_dir}")
        if mesh_layout:
            # every rank returns once rank 0 has written
            torch.distributed.barrier()


def _train_rank(args, faults, reducer, rank, world_size, device):
    torch.set_num_threads(1)      # ranks that share a host
    _train(args, faults, reducer, device, rank=rank)


def main(argv=None):
    args, faults, reducer = _checked_args(argv)
    device = resolve_device(args.device)
    if args.layout == "mesh":
        # a gloo rank a worker (x tp), sharing the card or the CPU
        mesh.spawn(functools.partial(_train_rank, args, faults, reducer),
                   args.data_dim * args.tp, device=device.type,
                   backend="gloo", tp=args.tp)
    else:
        _train(args, faults, reducer, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
