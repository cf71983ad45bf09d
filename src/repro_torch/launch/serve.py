"""Serve a trained generator: the continuous-batching decode CLI (port of
`repro.launch.serve` at tp=1).

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
defaults to CUDA and fails without it. `--tp` above 1 raises (ROADMAP
A12).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_arch_config, list_archs
from repro_torch.device import resolve_device
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced (test-size) config")
    ap.add_argument("--ckpt-dir", default="",
                    help="load the generator from this checkpoint directory")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width (only 1 is ported)")
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.ckpt_dir:
        params, step = load_generator_params(args.ckpt_dir, args.step,
                                             device)
        print(f"loaded generator from {args.ckpt_dir} @ step {step}")
    else:
        params = gan.generator_init(
            torch.Generator(device).manual_seed(args.seed), cfg)
        print("no --ckpt-dir: serving a randomly initialised generator")

    block = args.block_size if args.block_size > 0 else None
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           max_len=args.max_len, block_size=block,
                           n_blocks=args.n_blocks,
                           prefill_chunk=args.prefill_chunk,
                           seed=args.seed, tp=args.tp, device=device)
    print(f"engine: arch={args.arch} tp={args.tp} slots={args.batch} "
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
    n_tok = sum(len(r.out_tokens) for r in finished)
    for req in sorted(finished, key=lambda r: r.rid):
        print(f"  rid={req.rid}: {req.out_tokens}")
    for req in engine.rejected:
        print(f"  rid={req.rid}: REJECTED ({req.failed})")
    print(f"{len(finished)} requests, {n_tok} tokens in {wall:.2f}s "
          f"({n_tok / wall:.1f} tok/s), {engine.dispatch_count} steps, "
          f"{engine.compile_count} compiles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
