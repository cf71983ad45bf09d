"""Fig. 3 — learning performance of the two update schedules on the
three datasets. Paper claims: (i) both converge; (ii) serial needs fewer
rounds and less wall-clock than parallel under limited bandwidth. Port
of `benchmarks/fig3_schedules.py`.

    python -m repro_torch.experiments.fig3_schedules [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.experiments.common import (OUT_DIR, device_arg,
                                            emit_csv_row, last_fid,
                                            run_experiment)


def main(out_dir=OUT_DIR, driver=None, device=None):
    # driver=None falls through to run_experiment's REPRO_BENCH_DRIVER default
    os.makedirs(out_dir, exist_ok=True)
    curves = []
    for dataset in ("celeba", "cifar10", "rsna"):
        for schedule in ("serial", "parallel"):
            t0 = time.time()
            c = run_experiment(f"{dataset}/{schedule}", dataset=dataset,
                               schedule=schedule, driver=driver,
                               device=device)
            dt = (time.time() - t0) * 1e6 / max(len(c.rounds), 1)
            curves.append(c)
            emit_csv_row(f"fig3_{dataset}_{schedule}", dt,
                         f"final_fid={last_fid(c):.2f};"
                         f"wallclock={c.wallclock[-1]:.1f}s")
    with open(os.path.join(out_dir, "fig3_schedules.json"), "w") as f:
        json.dump([c.as_dict() for c in curves], f, indent=2)
    return curves


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    device_arg(ap)
    args = ap.parse_args()
    main(args.out_dir, device=args.device)
