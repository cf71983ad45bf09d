"""Head-to-head: the proposed framework (serial schedule) vs FedGAN [9]
on the same fleet, data, and channel — miniature of the paper's Fig. 5.
Twin of `examples/fedgan_compare.py`.

Both algorithms run the fused driver (Step 1 on the card, each round
after the first replayed as one captured CUDA graph, FID on the host at
the last round) with the paper's 16-bit quantized uplink; --bits
ablates the uplink width, --driver pins a driver, and --layout selects
the execution layout for both algorithms ("mesh": one gloo rank a
device, `experiments.common.run_on_mesh`; on CUDA the ranks share the
card; mesh rounds run uncaptured).

    python -m repro_torch.examples.fedgan_compare --rounds 12
    python -m repro_torch.examples.fedgan_compare --device cpu --rounds 1
    python -m repro_torch.examples.fedgan_compare --layout mesh --rounds 2
"""
import argparse
import functools

from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import Trainer, protocol
from repro_torch.data import make_image_dataset, partition
from repro_torch.device import resolve_device
from repro_torch.experiments import common
from repro_torch.models import dcgan
from repro_torch.models.specs import make_dcgan_spec


def runs(algorithms, schedule, rounds, driver, bits, layout="stacked",
         devices=10, data_size=640, device=None):
    """Each algorithm's run, in turn: (its last RoundRecord, the resolved
    driver, the upload in Mbit a device a round); on the mesh layout all
    on the same ranks, started once."""
    jobs = [functools.partial(_run, algorithm, schedule, rounds, driver,
                              bits, layout, devices, data_size)
            for algorithm in algorithms]
    if layout == "mesh":
        return [out for out, _ in common.run_on_mesh(jobs, devices, device)]
    device = resolve_device(device)
    return [job(device) for job in jobs]


def _run(algorithm, schedule, rounds, driver, bits, layout, devices,
         data_size, device):
    cfg = DCGANConfig(nz=32, ngf=16, ndf=16, nc=3, image_size=32)
    spec = make_dcgan_spec(cfg, gen_loss_variant="nonsaturating")
    pcfg = ProtocolConfig(n_devices=devices, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=2e-4, lr_g=2e-4,
                          schedule=schedule, optimizer="adam",
                          quantize_bits=bits)
    imgs, _ = make_image_dataset("celeba32", data_size)
    shards = partition(imgs, devices)
    tr = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg), shards,
                 seed=0, algorithm=algorithm, disc_step_flops=1e10,
                 gen_step_flops=1e10, driver=driver, layout=layout,
                 device=device)
    hist = tr.run(rounds, eval_every=rounds,
                  fid_fn=common.make_fid_fn(cfg, imgs, device))
    payload_mbit = protocol.uplink_payload_bits(
        tr.state, pcfg, fedgan=algorithm == "fedgan") / 1e6
    return hist[-1], tr.driver, payload_mbit


def main(argv=None):
    """The comparison; returns the two runs' last RoundRecords (proposed,
    FedGAN)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--driver", choices=["auto", "fused", "host"],
                    default="auto")
    ap.add_argument("--bits", type=int, default=16,
                    help="uplink quantization width (paper: 16; >=32 "
                         "disables quantization)")
    ap.add_argument("--layout", choices=["stacked", "mesh"],
                    default="stacked",
                    help="execution layout for both algorithms (mesh: "
                         "one gloo rank a device)")
    ap.add_argument("--devices", type=int, default=10,
                    help="fleet size K (the paper's 10)")
    ap.add_argument("--data", type=int, default=640,
                    help="dataset size (shrink for smoke runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    (prop, d1, mb1), (fed, d2, mb2) = runs(
        ["proposed", "fedgan"], "serial", args.rounds, args.driver,
        args.bits, args.layout, args.devices, args.data, args.device)
    print(f"proposed-serial : FID={prop.fid:8.2f}  "
          f"wallclock={prop.cumulative_s:8.2f}s  "
          f"uplink={mb1:6.2f} Mbit/round/device  [{d1}]")
    print(f"fedgan          : FID={fed.fid:8.2f}  "
          f"wallclock={fed.cumulative_s:8.2f}s  "
          f"uplink={mb2:6.2f} Mbit/round/device  [{d2}]")
    speedup = fed.cumulative_s / prop.cumulative_s
    print(f"-> proposed finishes the same number of rounds "
          f"{speedup:.2f}x faster in simulated wall-clock "
          f"({mb2 / mb1:.1f}x fewer upload bits, half the device compute)")
    return prop, fed


if __name__ == "__main__":
    main()
