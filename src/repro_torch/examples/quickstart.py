"""Quickstart: train a DCGAN with the paper's distributed protocol on the
card. Twin of `examples/quickstart.py`.

10 simulated devices, serial update schedule, synthetic CelebA-like
data, FID evaluation — a miniature of the paper's Section IV setup.

    python -m repro_torch.examples.quickstart --rounds 20
    python -m repro_torch.examples.quickstart --device cpu --rounds 2

--ckpt-dir writes the trained raw state (`Trainer.state`) as checkpoint
`--rounds` in the JAX package's format, as the JAX quickstart does;
`Trainer.save_checkpoint` writes the resumable one.
"""
import argparse

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import Trainer
from repro_torch.data import make_image_dataset, partition
from repro_torch.device import resolve_device
from repro_torch.experiments.common import make_fid_fn
from repro_torch.models import dcgan
from repro_torch.models.specs import make_dcgan_spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--schedule", choices=["serial", "parallel"],
                    default="serial")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = DCGANConfig(nz=32, ngf=16, ndf=16, nc=3, image_size=32)
    spec = make_dcgan_spec(cfg, gen_loss_variant="nonsaturating")
    pcfg = ProtocolConfig(n_devices=args.devices, n_d=2, n_g=2,
                          sample_size=16, server_sample_size=16,
                          lr_d=2e-4, lr_g=2e-4, schedule=args.schedule,
                          optimizer="adam")

    imgs, _ = make_image_dataset("celeba32", 640)
    shards = partition(imgs, args.devices)
    trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg), shards,
                      seed=0, device=device)
    trainer.run(args.rounds, eval_every=5,
                fid_fn=make_fid_fn(cfg, imgs, device), verbose=True)

    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.rounds, trainer.state,
                        metadata={"schedule": args.schedule})
        print(f"checkpoint saved to {args.ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
