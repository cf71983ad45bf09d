"""End-to-end driver: the distributed GAN protocol on a backbone
architecture over synthetic token data. Twin of
`examples/train_distgan.py`.

By default it trains the reduced variant of the chosen architecture;
--full-scale builds the full config (at most the smaller configs fit one
card). The conditioned families (whisper-base, llama-3.2-vision-90b)
take the stub frontend's features (`make_stub_enc_feats`).

    python -m repro_torch.examples.train_distgan --arch whisper-base \\
        --rounds 4 --devices 2 --seq-len 16
    python -m repro_torch.examples.train_distgan --arch qwen3-1.7b \\
        --device cpu --rounds 2 --driver host

--driver host and --driver fused print the same D objective and FID
round for round. --device defaults to CUDA and fails without it.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ProtocolConfig, get_arch_config, list_archs
from repro_torch.core import Trainer
from repro_torch.data import make_token_dataset, partition
from repro_torch.device import resolve_device
from repro_torch.metrics import fid_score
from repro_torch.metrics.fid import make_token_feature_extractor
from repro_torch.models import gan
from repro_torch.models.specs import make_backbone_spec, make_stub_enc_feats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-1.7b")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--schedule", choices=["serial", "parallel"],
                    default="serial")
    ap.add_argument("--driver", choices=["fused", "host"], default="fused",
                    help="fused = each round a captured CUDA graph on the "
                         "card; host = one round at a time (the oracle)")
    ap.add_argument("--full-scale", action="store_true",
                    help="build the full config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch_config(args.arch)
    if not args.full_scale:
        cfg = cfg.reduced()
    print(f"[train_distgan] {cfg.name} ({cfg.family}), "
          f"{args.devices} devices, schedule={args.schedule}, "
          f"driver={args.driver}, on {device}")

    pcfg = ProtocolConfig(n_devices=args.devices, n_d=2, n_g=2,
                          sample_size=4, server_sample_size=4,
                          lr_d=1e-3, lr_g=1e-3, schedule=args.schedule,
                          optimizer="adam")
    enc_fn = make_stub_enc_feats(cfg, device=device)
    spec = make_backbone_spec(cfg, args.seq_len, enc_feats_fn=enc_fn,
                              remat=False, gen_loss_variant="nonsaturating")

    toks, _ = make_token_dataset(args.devices * 32, args.seq_len, cfg.vocab)
    shards = partition(toks, args.devices)

    feat = make_token_feature_extractor(cfg.vocab, device=device)
    real_feats = feat(torch.from_numpy(np.asarray(toks[:128])))

    def fid_fn(gen_params, generator):
        with torch.no_grad():
            fake = spec.gen_apply(gen_params, spec.sample_z(generator, 64))
        return fid_score(real_feats, feat(fake))

    trainer = Trainer(spec, pcfg, lambda g: gan.gan_init(g, cfg), shards,
                      seed=0, driver=args.driver, device=device)
    t0 = time.time()
    history = trainer.run(args.rounds, eval_every=max(args.rounds // 4, 1),
                          fid_fn=fid_fn, verbose=True)
    print(f"[train_distgan] {args.rounds} rounds in {time.time()-t0:.1f}s")

    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.rounds, trainer.state,
                        metadata={"arch": cfg.name})
        print(f"checkpoint saved to {args.ckpt_dir}")
    return history


if __name__ == "__main__":
    main()
