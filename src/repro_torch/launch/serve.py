"""Serve a trained generator: the continuous-batching decode CLI (port of
`repro.launch.serve`).

Loads a training checkpoint in the JAX package's layout (written by
either package's `save_checkpoint` or Trainer) and serves its generator
through `repro_torch.serving.ServingEngine`, with the paged cache on by
default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --ckpt-dir runs/q17 --demo 8 --max-new 16
    # on the CPU, dense caches
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --reduced --device cpu --block-size 0

Without `--ckpt-dir` the generator is randomly initialised (a smoke run
or a latency measurement). `--block-size 0` turns paging off and
reserves dense per-slot `max_len` caches; otherwise the block pool
defaults to the worst case (`batch * ceil(max_len/block) + 1` blocks)
and `--n-blocks` caps it (admission then waits for blocks). `--device`
defaults to CUDA and fails without it.

The encoder-decoder and vision families (whisper-base,
llama-3.2-vision-90b) are refused with a ValueError: their cross caches
need frontend features, which this CLI does not pass (nor does the JAX
package's, whose engine then refuses them).

`--tp N` (N > 1) spawns N gloo ranks, a model group of N
(`launch.mesh.spawn(..., tp=N)`, sharing the card, or the CPU); every
rank loads the same GLOBAL-shaped checkpoint, whatever tp it was
trained at, cuts its shards of the feed-forward from it, and serves the
same requests; rank 0 prints. Greedy tokens equal tp=1's up to a near
tie, since tp changes only the order of the w_out reduction:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --tp 2 --block-size 0 --device cpu
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_arch_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.models import gan
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_map


def load_generator_params(ckpt_dir: str, step=None, device="cpu"):
    """The generator parameters of a training checkpoint, as tensors on
    `device`: the Trainer layout ({"state": {"gen": ...}}), a bare
    {"gen": ...} tree, or raw generator parameters. Returns (params,
    step)."""
    tree, step, _ = load_checkpoint(ckpt_dir, step)
    if "state" in tree and "gen" in tree["state"]:
        params = tree["state"]["gen"]
    elif "gen" in tree:
        params = tree["gen"]
    else:
        params = tree
    return tree_map(lambda x: torch.as_tensor(x).to(device), params), step


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced (test-size) config")
    ap.add_argument("--ckpt-dir", default="",
                    help="load the generator from this checkpoint directory "
                         "(global-shaped; any training tp width)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width: spawns this many gloo "
                         "ranks")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slots (max concurrent requests)")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-cache block size; 0 = dense caches")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="cap the paged block pool (default worst-case)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--demo", type=int, default=4,
                    help="serve N random demo prompts and print tokens")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap


def _serve(args, device):
    """Load (or initialise) the generator, serve the demo requests on
    `device` at `args.tp`; returns the lines to print (model rank 0's
    requests; the other ranks return the engine's line only)."""
    lines = []
    cfg = get_arch_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.ckpt_dir:
        # on the CPU first: at tp > 1 the engine moves only its shards
        params, step = load_generator_params(
            args.ckpt_dir, args.step, "cpu" if args.tp > 1 else device)
        lines.append(f"loaded generator from {args.ckpt_dir} @ step {step}")
    else:
        params = gan.generator_init(
            torch.Generator(device).manual_seed(args.seed), cfg)
        lines.append("no --ckpt-dir: serving a randomly initialised "
                     "generator")

    block = args.block_size if args.block_size > 0 else None
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           max_len=args.max_len, block_size=block,
                           n_blocks=args.n_blocks,
                           prefill_chunk=args.prefill_chunk,
                           seed=args.seed, tp=args.tp, device=device)
    del params
    lines.append(f"engine: arch={args.arch} tp={args.tp} slots={args.batch} "
                 f"max_len={args.max_len} "
                 f"cache={'paged/' + str(block) if block else 'dense'} "
                 f"({engine.cache_bytes()} bytes) on {device}")

    rng = np.random.default_rng(args.seed)
    for i in range(args.demo):
        prompt = rng.integers(1, cfg.vocab, rng.integers(4, 17))
        engine.submit(Request(rid=i, prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new,
                              temperature=args.temperature))
    t0 = time.perf_counter()
    finished = engine.run()
    wall = time.perf_counter() - t0
    if engine.tp_rank != 0:
        return lines
    n_tok = sum(len(r.out_tokens) for r in finished)
    for req in sorted(finished, key=lambda r: r.rid):
        lines.append(f"  rid={req.rid}: {req.out_tokens}")
    for req in engine.rejected:
        lines.append(f"  rid={req.rid}: REJECTED ({req.failed})")
    lines.append(f"{len(finished)} requests, {n_tok} tokens in {wall:.2f}s "
                 f"({n_tok / wall:.1f} tok/s), {engine.dispatch_count} "
                 f"steps, {engine.compile_count} compiles")
    return lines


def _serve_rank(args, rank, world_size, device):
    torch.set_num_threads(1)      # ranks that share a host
    return _serve(args, device)


def main(argv=None):
    args = _parser().parse_args(argv)
    family = get_arch_config(args.arch).family
    if family in ("encdec", "vlm"):
        # JAX's CLI builds its engine without enc_feats_fn, so its engine
        # refuses these families too
        raise ValueError(
            f"{args.arch}: the serve CLI passes no frontend features "
            f"(enc_feats_fn), as the JAX package's CLI passes none, and the "
            f"{family} family's cross caches need them; serve it with "
            f"ServingEngine(cfg, params, enc_feats_fn=repro_torch.models."
            f"specs.make_stub_enc_feats(cfg))")
    device = resolve_device(args.device)
    if args.tp > 1:
        # one gloo rank a model shard (ranks may share a card)
        per_rank = mesh.spawn(functools.partial(_serve_rank, args),
                              args.tp, device=device.type, backend="gloo",
                              tp=args.tp)
        lines = per_rank[0]
    else:
        lines = _serve(args, device)
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
