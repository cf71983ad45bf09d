"""Robustness figure: FID under hostile workers, with and without the
robust reducers. Port of `benchmarks/fig_robust.py`.

Two sweeps through the shared figure harness (`common`), both on the
fused stacked driver at K=8 workers:

  free-rider sweep — n_free_riders in {0, 2, 4} (0% / 25% / 50% of the
      fleet replaying the stale global model instead of training) x
      reducer in {mean, trimmed_mean, krum}: final FID per cell.
  honest-majority recovery — 3-of-8 byzantine workers uploading
      10x-scaled Gaussian noise: full FID-vs-round curves for the plain
      mean vs trimmed_mean vs krum.

Every run merges its curves into the JSON file given by --json (default
results/torch/BENCH_robust.json; re-running one sweep preserves the
other's entry). It never writes the JAX package's BENCH_robust.json at
the repository root.

`--smoke` shrinks both sweeps and gates on correctness rather than FID
quality: (a) every FID in every cell is finite; (b) with ZERO faults the
identity-regime reducers (trimmed_mean trim=0, krum f=0) reproduce the
plain-mean FID. Exit 2 on violation.

    python -m repro_torch.experiments.fig_robust            # full
    python -m repro_torch.experiments.fig_robust --smoke    # the gate
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.faults import FaultConfig
from repro_torch.experiments.common import (ROUNDS, device_arg,
                                            emit_csv_row, last_fid,
                                            run_experiment)
from repro_torch.kernels.robust_avg.ops import RobustConfig

K = 8
JSON_PATH = os.path.join("results", "torch", "BENCH_robust.json")
# the JAX package's output, which the port's sweep leaves alone
_JAX_JSON = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "BENCH_robust.json"))

REDUCERS = {
    "mean": None,
    "trimmed_mean": RobustConfig(method="trimmed_mean", trim=1),
    "krum": RobustConfig(method="krum", krum_f=2),
}


def _faults(**kw):
    return FaultConfig(n_devices=K, **kw) if kw else None


def free_rider_sweep(rounds: int, fractions, reducers, device=None) -> dict:
    """final FID per (n_free_riders x reducer) cell."""
    out = {}
    for n_fr in fractions:
        faults = _faults(n_free_riders=n_fr) if n_fr else None
        for name in reducers:
            c = run_experiment(
                f"robust_fr{n_fr}_{name}", k=K, rounds=rounds,
                faults=faults, reducer=REDUCERS[name], device=device)
            fid = last_fid(c)
            emit_csv_row(f"fig_robust_fr{n_fr}_{name}", 0.0,
                         f"final_fid={fid:.2f}")
            out[f"fr{n_fr}/{name}"] = {
                "n_free_riders": n_fr, "reducer": name,
                "curve": c.as_dict(), "final_fid": fid}
    return out


def recovery_sweep(rounds: int, reducers, device=None) -> dict:
    """honest-majority recovery: 3-of-8 byzantine, curve per reducer."""
    faults = _faults(n_byzantine=3, byz_scale=10.0)
    out = {}
    for name in reducers:
        c = run_experiment(
            f"robust_byz3_{name}", k=K, rounds=rounds,
            faults=faults, reducer=REDUCERS[name], device=device)
        fid = last_fid(c)
        emit_csv_row(f"fig_robust_byz3_{name}", 0.0,
                     f"final_fid={fid:.2f}")
        out[f"byz3/{name}"] = {"n_byzantine": 3, "reducer": name,
                               "curve": c.as_dict(), "final_fid": fid}
    return out


def identity_gate(rounds: int, device=None):
    """Zero faults: identity-regime reducers must match the plain mean.

    trim=0 / krum f=0 make the robust weight vectors those of the plain
    mean, so the FID curves agree to round-off (same masks). A loose
    relative tolerance absorbs the float32 round-off amplified through
    training + FID."""
    base = run_experiment("robust_identity_mean", k=K, rounds=rounds,
                          device=device)
    failures = []
    for name, cfg in (
            ("trimmed_mean", RobustConfig(method="trimmed_mean", trim=0)),
            ("krum", RobustConfig(method="krum", krum_f=0)),
    ):
        c = run_experiment(f"robust_identity_{name}", k=K, rounds=rounds,
                           reducer=cfg, device=device)
        ref, got = last_fid(base), last_fid(c)
        tol = max(0.05 * abs(ref), 0.5)
        emit_csv_row(f"fig_robust_identity_{name}", 0.0,
                     f"fid={got:.3f};mean_fid={ref:.3f}")
        if not abs(got - ref) <= tol:
            failures.append(
                f"identity-regime {name} FID {got:.3f} departs from the "
                f"plain mean {ref:.3f} (tol {tol:.3f}) with zero faults")
    return failures


def write_json(path: str, section: str, data: dict):
    payload = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            payload = {}
    payload.setdefault("sweeps", {})[section] = data
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced run; exit non-zero if a FID is "
                         "non-finite or the zero-fault identity regimes "
                         "depart from the plain mean")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--json", default=JSON_PATH)
    device_arg(ap)
    args = ap.parse_args(argv)
    if os.path.abspath(args.json) == _JAX_JSON:
        ap.error(f"--json {args.json} is the JAX package's robustness "
                 f"output; give the port's sweep another path")
    rounds = args.rounds or (4 if args.smoke else ROUNDS)

    if args.smoke:
        fractions, reducers = (0, 4), ("mean", "trimmed_mean")
        rec_reducers = ("mean", "krum")
    else:
        fractions, reducers = (0, 2, 4), tuple(REDUCERS)
        rec_reducers = tuple(REDUCERS)

    fr = free_rider_sweep(rounds, fractions, reducers, device=args.device)
    rec = recovery_sweep(rounds, rec_reducers, device=args.device)
    write_json(args.json, "free_riders", fr)
    write_json(args.json, "byz_recovery", rec)

    failures = []
    for label, cell in {**fr, **rec}.items():
        fid = cell["final_fid"]
        if not (fid == fid and abs(fid) != float("inf")):
            failures.append(f"{label}: non-finite final FID {fid}")
    if args.smoke:
        failures += identity_gate(rounds, device=args.device)

    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    return 2 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
