"""Fig. 4 — device-count scaling vs centralized training (serial
schedule, CelebA). Paper claim: with the same per-iteration data budget,
K-device training converges to the same FID as centralized, slightly
faster. Port of `benchmarks/fig4_devices.py`.

    python -m repro_torch.experiments.fig4_devices [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.experiments.common import (OUT_DIR, device_arg,
                                            emit_csv_row, last_fid,
                                            run_experiment)

SETTINGS = [("centralized", "centralized", 10),
            ("K=5", "proposed", 5),
            ("K=10", "proposed", 10)]


def main(out_dir=OUT_DIR, device=None):
    os.makedirs(out_dir, exist_ok=True)
    curves = []
    for label, algorithm, k in SETTINGS:
        t0 = time.time()
        c = run_experiment(f"fig4/{label}", dataset="celeba",
                           algorithm=algorithm, k=k, device=device)
        dt = (time.time() - t0) * 1e6 / max(len(c.rounds), 1)
        curves.append(c)
        emit_csv_row(f"fig4_{label}", dt, f"final_fid={last_fid(c):.2f}")
    with open(os.path.join(out_dir, "fig4_devices.json"), "w") as f:
        json.dump([c.as_dict() for c in curves], f, indent=2)
    return curves


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    device_arg(ap)
    args = ap.parse_args()
    main(args.out_dir, device=args.device)
