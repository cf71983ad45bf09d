"""Serve a generator as a causal LM with batched requests through the
slot-based continuous-batching engine. Twin of
`examples/serve_generator.py`.

    python -m repro_torch.examples.serve_generator --arch mamba2-130m
    python -m repro_torch.examples.serve_generator --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import gan
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="mamba2-130m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch_config(args.arch).reduced()
    print(f"[serve] {cfg.name} reduced variant, "
          f"batch={args.batch_size}, requests={args.requests}")
    params = gan.generator_init(torch.Generator(device).manual_seed(0), cfg)
    engine = ServingEngine(cfg, params, batch_size=args.batch_size,
                           max_len=64, device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              rng.integers(3, 10)).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new,
                              temperature=args.temperature))
    finished = engine.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in finished)
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.out_tokens}")
    print(f"[serve] {len(finished)} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s on {device})")


if __name__ == "__main__":
    main()
