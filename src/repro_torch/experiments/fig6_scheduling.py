"""Fig. 6 — scheduling-ratio trade-off under heterogeneous channels with
variable upload times. Paper claim: scheduling 100% of devices performs
WORST (stragglers dominate the round time); 50% / 20% best-channel
scheduling wins in wall-clock. Port of `benchmarks/fig6_scheduling.py`.

    python -m repro_torch.experiments.fig6_scheduling [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.experiments.common import (OUT_DIR, device_arg,
                                            emit_csv_row, last_fid,
                                            run_experiment)

# a tight per-round deadline makes bad-channel devices stragglers
CHANNEL = dict(fading=True, straggler_deadline_s=60.0)
RATIOS = (1.0, 0.5, 0.2)


def main(out_dir=OUT_DIR, driver=None, device=None):
    # driver=None falls through to run_experiment's REPRO_BENCH_DRIVER default
    os.makedirs(out_dir, exist_ok=True)
    curves = []
    for ratio in RATIOS:
        t0 = time.time()
        c = run_experiment(f"fig6/ratio={ratio}", dataset="celeba",
                           scheduler="best_channel", ratio=ratio,
                           channel_kw=CHANNEL, driver=driver, device=device)
        dt = (time.time() - t0) * 1e6 / max(len(c.rounds), 1)
        curves.append(c)
        emit_csv_row(f"fig6_ratio{int(ratio * 100)}", dt,
                     f"final_fid={last_fid(c):.2f};"
                     f"wallclock={c.wallclock[-1]:.1f}s")
    with open(os.path.join(out_dir, "fig6_scheduling.json"), "w") as f:
        json.dump([c.as_dict() for c in curves], f, indent=2)
    return curves


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    device_arg(ap)
    args = ap.parse_args()
    main(args.out_dir, device=args.device)
