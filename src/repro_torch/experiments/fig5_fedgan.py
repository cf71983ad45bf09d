"""Fig. 5 — comparison with FedGAN [9]. Paper claims: proposed-serial
converges faster in wall-clock than FedGAN (half the upload bytes, half
the device compute); proposed-parallel ~ FedGAN. Port of
`benchmarks/fig5_fedgan.py`.

Both algorithms run the fused driver with the paper's 16-bit quantized
uplink; the trailing rows ablate the uplink bit width, which shrinks
simulated upload time for both algorithms. --layout selects the
execution layout for every setting: "mesh" runs each on --devices gloo
ranks, one a worker (`common.run_on_mesh`; on CUDA they share the
card). --smoke shrinks to one proposed + one FedGAN setting (round
count still via REPRO_BENCH_ROUNDS).

    python -m repro_torch.experiments.fig5_fedgan [--smoke] [--device cpu]
    python -m repro_torch.experiments.fig5_fedgan --layout mesh --smoke
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.experiments.common import (OUT_DIR, device_arg,
                                            emit_csv_row, last_fid,
                                            run_experiments)

SETTINGS = [("proposed-serial", "proposed", "serial", 16),
            ("proposed-parallel", "proposed", "parallel", 16),
            ("fedgan", "fedgan", "serial", 16),
            ("proposed-serial-8bit", "proposed", "serial", 8),
            ("fedgan-8bit", "fedgan", "serial", 8)]


def main(out_dir=OUT_DIR, layout="stacked", k=10, smoke=False, device=None):
    os.makedirs(out_dir, exist_ok=True)
    settings = SETTINGS
    if smoke:   # one setting per algorithm
        settings = [SETTINGS[0], SETTINGS[2]]
    # on the mesh layout every setting runs on the same K ranks
    runs = run_experiments(
        [(f"fig5/{label}", dict(dataset="celeba", algorithm=algorithm,
                                schedule=schedule, bits=bits, k=k))
         for label, algorithm, schedule, bits in settings],
        layout=layout, device=device)
    curves = []
    for (label, *_), (c, secs) in zip(settings, runs):
        dt = secs * 1e6 / max(len(c.rounds), 1)
        curves.append(c)
        emit_csv_row(f"fig5_{label}_{layout}", dt,
                     f"final_fid={last_fid(c):.2f};"
                     f"wallclock={c.wallclock[-1]:.1f}s")
    with open(os.path.join(out_dir, f"fig5_fedgan_{layout}.json"),
              "w") as f:
        json.dump([c.as_dict() for c in curves], f, indent=2)
    return curves


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--layout", choices=["stacked", "mesh"],
                    default="stacked",
                    help="execution layout for every setting (mesh: "
                         "one gloo rank a device)")
    ap.add_argument("--devices", type=int, default=10,
                    help="fleet size K (the paper's 10)")
    ap.add_argument("--smoke", action="store_true",
                    help="one proposed + one FedGAN setting only")
    device_arg(ap)
    args = ap.parse_args()
    main(args.out_dir, layout=args.layout, k=args.devices, smoke=args.smoke,
         device=args.device)
