"""Dry run of every (architecture x input shape): one call of the step on
the meta device, counted op by op, for the roofline's inputs and the
peak memory a card. The port's counterpart of `repro.launch.dryrun`.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

Needs no card: every tensor of the step is a meta tensor, so nothing is
allocated. The JAX package lowers and compiles each combination on 512
placeholder devices; the port has no compiled artifact, and one call of
the step, dispatched op by op, stands for it (`launch.hlo_costs`).

What the two meshes mean in the port, which places no global program on
a device mesh (no GSPMD, ROADMAP item 10c):
  single  the stacked train step: K = 16 workers on one card (n_chips
          1); 16 is the data axis of the JAX package's 16 x 16 mesh.
  multi   rank 0 of the mesh layout, one rank per worker, K = 32 (the
          JAX package's pod x data axes), tp 1; its counts are scaled by
          n_chips = 32, as the JAX package scales its per-device module.
          The ranks are a fake process group inside this process: no
          process starts and nothing is sent, the collectives count
          their bytes. The encoder-fed families (encdec, vlm) have no
          mesh layout (the JAX package's mesh builder refuses them too),
          so their train shape is skipped under multi.
Prefill and decode are one-card programs under both (n_chips 1).

Where a value depends on data, the dry run takes every worker as
scheduled (the stacked step's weights are not read on the host), as
XLA's traced program computes those masks as tensors too.

Beyond the JAX package's flags, a combination can be cut to size (the
configurations that wait for a smaller round or more cards, ROADMAP):
--layers and --vocab replace the architecture's depth and vocabulary,
--workers the train step's K, --seq-len and --global-batch the shape's
(give a --tag, so the JSON does not take the full size's name).

Outputs one JSON per combination under results/torch/dryrun/: the JAX
package's `roofline`, `collectives` and `memory` entries and keys,
`kernels` (each hand-written kernel's calls, flops and bytes by its
formula), and the host seconds to build the step (`lower_s`) and to run
it on the meta device (`run_s`). There is no HLO file to keep.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_arch_config, list_archs
from repro_torch.launch import analysis, hlo_costs, mesh, variants
from repro_torch.launch import steps as steps_mod

# long_500k needs sub-quadratic attention / bounded state (the JAX
# package's dry run runs it for these):
LONG_OK = {"mamba2-130m", "zamba2-2.7b", "mixtral-8x22b", "gemma3-12b"}

# Workers of each mesh (module docstring) and the cards they stand for.
SINGLE_K, MULTI_K = 16, 32


def combos():
    for arch in list_archs():
        for shape in INPUT_SHAPES.values():
            if shape.name == "long_500k" and arch not in LONG_OK:
                continue
            yield arch, shape.name


def mesh_skip(arch: str, shape_name: str, multi_pod: bool):
    """Why the combination has no port counterpart, or None."""
    if (multi_pod and INPUT_SHAPES[shape_name].kind == "train"
            and steps_mod.needs_enc(get_arch_config(arch))):
        return ("the mesh layout takes no encoder-fed family (the JAX "
                "package's mesh builder refuses them too)")
    return None


@contextlib.contextmanager
def fake_group(world_size: int, tp: int = 1):
    """A process group of `world_size` ranks in which this process is
    rank 0, with no other process and no transport (torch's fake
    backend), and at tp > 1 the data and model groups of
    `launch.mesh.spawn(..., tp=tp)`: enough for a dry run's collectives,
    which count their bytes on meta tensors and send nothing. Destroyed
    on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        if tp > 1:
            mesh._build_tp_groups(world_size, tp)
        yield
    finally:
        mesh._AXES.clear()
        dist.destroy_process_group()


def _fname(arch, shape_name, multi_pod, tag=""):
    suffix = f"_{tag}" if tag else ""
    return (f"{arch.replace('.', '_')}__{shape_name}__"
            f"{'multi' if multi_pod else 'single'}{suffix}.json")


def dry_call(step, args):
    """One call of `step` on its meta arguments under a cost counter,
    which must see no tensor made on a device: the step's tensors are
    meta tensors, and only the host's constants (the channel's path
    gains, a learning rate rounded to a dtype through a 0-dim tensor)
    are real, on the CPU (`memory["host_bytes"]`). Returns the
    counter."""
    _, counter = hlo_costs.count_costs(step, *args)
    devices = set(counter.made_on) - {"cpu"}
    if devices:
        raise RuntimeError(f"the dry run made tensors on {sorted(devices)}")
    return counter


def step_costs(cfg, shape, multi_pod: bool, *, n_devices=None, tp: int = 1,
               schedule: str = "serial", **step_kw):
    """Build the step of (cfg, shape) on the mesh's terms and run it once
    on the meta device: the train step of `n_devices` workers (by default
    the mesh's, module docstring), each of `tp` ranks under multi.
    Returns (counter, n_chips, the build's host seconds); n_chips is the
    ranks of the mesh layout, 1 for a one-card program."""
    t0 = time.time()
    if shape.kind != "train":
        step, args = steps_mod.build_step(cfg, shape, 1)
        build_s = time.time() - t0
        if shape.kind == "decode":
            # the decoded token's cache slot is a host integer: the last
            # one, with every earlier slot filled
            args = (*args[:3], shape.seq_len - 1)
        return dry_call(step, args), 1, build_s
    kw = {"schedule": schedule, **step_kw}
    if not multi_pod:
        step, args = steps_mod.build_step(cfg, shape, n_devices or SINGLE_K,
                                          **kw)
        build_s = time.time() - t0
        # the round's seed is a host integer (it keys the draws)
        return dry_call(step, (*args[:3], 0)), 1, build_s
    k = n_devices or MULTI_K
    step, args = steps_mod.build_step(cfg, shape, k, layout="mesh", tp=tp,
                                      **kw)
    build_s = time.time() - t0
    with fake_group(k * tp, tp=tp):
        state, carry, tokens = step.rank_state(args[0]), args[1], args[2]
        return (dry_call(step, (state, carry, tokens, 0, 0)), k * tp,
                build_s)


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            schedule: str = "serial", tag: str = "",
            variant: str = "", cuts=None) -> dict:
    """One combination; `cuts` ({"layers", "vocab", "workers",
    "seq_len", "global_batch"}: None keeps the full size) cuts it to
    size (module docstring)."""
    cuts = {k: v for k, v in (cuts or {}).items() if v is not None}
    cfg = get_arch_config(arch)
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], **{
        k: cuts[k] for k in ("seq_len", "global_batch") if k in cuts})
    cfg = dataclasses.replace(cfg, **{
        field: cuts[k] for k, field in (("layers", "n_layers"),
                                        ("vocab", "vocab")) if k in cuts})
    cfg, var_kw = variants.apply(cfg, variant)
    if shape.kind != "train":
        var_kw = {}
    t0 = time.time()
    counter, n_chips, build_s = step_costs(
        cfg, shape, multi_pod, n_devices=cuts.get("workers"),
        schedule=schedule, **var_kw)
    run_s = time.time() - t0 - build_s
    result = analysis.analyze(counter.totals(), counter.memory(), n_chips)
    result["memory"]["host_bytes"] = counter.made_on.get("cpu", 0)
    result.update({
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_chips": n_chips,
        "schedule": schedule if shape.kind == "train" else None,
        "lower_s": round(build_s, 1), "run_s": round(run_s, 1),
    })
    if cuts:
        result["cuts"] = cuts
    peak = result["memory"]["peak_bytes"]
    roof = result["roofline"]
    print(f"[dryrun] {arch} x {shape_name} x "
          f"{'multi' if multi_pod else 'single'}: "
          f"dominant={roof['dominant']} "
          f"compute={roof['compute_s']:.3e}s "
          f"memory={roof['memory_s']:.3e}s "
          f"collective={roof['collective_s']:.3e}s "
          f"peak/dev={peak / 1e9:.2f}GB "
          f"(build {build_s:.0f}s run {run_s:.0f}s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, _fname(arch, shape_name, multi_pod,
                                               tag)), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input-shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--schedule", default="serial",
                    choices=["serial", "parallel"])
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--tag", default="", help="suffix for output files")
    ap.add_argument("--variant", default="",
                    help="perf variant (see repro_torch.launch.variants)")
    ap.add_argument("--skip-existing", action="store_true")
    for flag, what in (("--layers", "the architecture's depth"),
                       ("--vocab", "its vocabulary"),
                       ("--workers", "the train step's K workers"),
                       ("--seq-len", "the shape's sequence length"),
                       ("--global-batch", "the shape's global batch")):
        ap.add_argument(flag, type=int, default=None,
                        help=f"cut {what} to this (default: the full size)")
    args = ap.parse_args(argv)
    cuts = dict(layers=args.layers, vocab=args.vocab, workers=args.workers,
                seq_len=args.seq_len, global_batch=args.global_batch)

    pairs = [(a, s) for a, s in combos()
             if (args.arch in ("all", a)) and (args.shape in ("all", s))]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.time()
    failures = []
    for arch, shape_name in pairs:
        for multi in meshes:
            fname = _fname(arch, shape_name, multi, args.tag)
            why = mesh_skip(arch, shape_name, multi)
            if why:
                print(f"[dryrun] skip {arch} x {shape_name} x multi: {why}",
                      flush=True)
                continue
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, fname)):
                print(f"[dryrun] skip existing {fname}", flush=True)
                continue
            try:
                run_one(arch, shape_name, multi, args.out,
                        schedule=args.schedule, tag=args.tag,
                        variant=args.variant, cuts=cuts)
            except Exception:
                print(f"[dryrun] FAILED {arch} x {shape_name} x "
                      f"{'multi' if multi else 'single'}", flush=True)
                traceback.print_exc()
                failures.append((arch, shape_name, multi))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}", flush=True)
        sys.exit(1)
    print(f"[dryrun] all combinations ran on the meta device in "
          f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
