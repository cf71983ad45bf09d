"""Sections of an experiments report from the port's results/torch/
artifacts. Port of the JAX package's `benchmarks/experiments_report.py`.

    python -m repro_torch.experiments.experiments_report

  §Dry-run           from results/torch/dryrun/*.json (memory and the
                     collective schedule, `repro_torch.launch.dryrun`)
  §Roofline          three-term table + dominant bottleneck + useful ratio
  §Paper-validation  from the figure curves in results/torch/bench/*.json
                     (`repro_torch.experiments.fig*`)
  §Perf              from results/torch/perf/*.json hillclimb records
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.experiments.common import OUT_DIR as BENCH_DIR
from repro_torch.experiments.roofline_report import DRY_DIR, load_rows
from repro_torch.launch.analysis import HBM_BW, NVLINK_BW, PEAK_FLOPS

PERF_DIR = os.path.join("results", "torch", "perf")


def fmt_dryrun_section():
    out = ["## §Dry-run\n"]
    out.append("Every (architecture × input shape) run once on the meta "
               "device, with nothing allocated: `single` is the stacked "
               "step of K = 16 workers on one card, `multi` rank 0 of the "
               "mesh layout, one rank per worker, K = 32 (the encoder-fed "
               "families have no mesh layout). Memory a card is the "
               "largest sum of live storages during the call, each "
               "rounded to the caching allocator's 512 bytes, and the "
               "collective schedule is counted at the port's collective "
               "call sites (`repro_torch.launch.hlo_costs`). Reckoned, "
               "not measured: the step keeps its dtypes on the meta "
               "device (bf16 stays 2 bytes).\n")
    out.append("| arch | shape | mesh | peak GB/dev | collectives "
               "(AG/AR/RS/A2A/CP) |")
    out.append("|---|---|---|---|---|")
    for p in sorted(glob.glob(os.path.join(DRY_DIR, "*.json"))):
        if os.path.basename(p).count("__") != 2:
            continue
        with open(p) as f:
            d = json.load(f)
        counts = d["collectives"]["counts"]
        cstr = "/".join(str(counts.get(k, 0)) for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"))
        peak = (d["memory"].get("peak_bytes") or 0) / 1e9
        out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                   f"{peak:.2f} | {cstr} |")
    return "\n".join(out)


def fmt_roofline_section():
    rows = load_rows()
    out = ["## §Roofline\n"]
    out.append(f"Terms against the H100 SXM's published peaks at 700 W: "
               f"compute = FLOPs/(cards·{PEAK_FLOPS / 1e12:.0f} TF/s "
               f"bf16 dense; a lower bound for the float32 work), memory = "
               f"bytes/(cards·{HBM_BW / 1e12:.2f} TB/s), collective = "
               f"coll_bytes/(cards·{NVLINK_BW / 1e9:.0f} GB/s NVLink). "
               f"FLOPs and bytes are counted op by op over one call of the "
               f"step (every loop trip runs, so every trip counts); the "
               f"hand-written kernels count by their own formulas; "
               f"MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D "
               f"(serve); useful = MODEL_FLOPS/counted FLOPs.\n")
    out.append("| arch | shape | mesh | compute_s | memory_s | "
               "collective_s | dominant | useful | peak GB |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['peak_gb']:.2f} |")
    return "\n".join(out)


def fmt_bench_section():
    out = ["## §Paper-validation\n"]
    files = {
        "fig3_schedules": "Fig. 3 — serial vs parallel schedule, 3 datasets",
        "fig4_devices": "Fig. 4 — device count vs centralized",
        # fig5 writes one curves file per execution layout
        "fig5_fedgan_stacked": "Fig. 5 — proposed vs FedGAN (stacked)",
        "fig5_fedgan_mesh": "Fig. 5 — proposed vs FedGAN (mesh)",
        "fig6_scheduling": "Fig. 6 — scheduling ratio under stragglers",
    }
    for stem, title in files.items():
        path = os.path.join(BENCH_DIR, f"{stem}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            curves = json.load(f)
        out.append(f"### {title}\n")
        out.append("| setting | final FID | wall-clock (s) |")
        out.append("|---|---|---|")
        for c in curves:
            fids = [f for f in c["fid"] if f is not None]
            fid = fids[-1] if fids else float("nan")
            wall = c["wallclock"][-1] if c["wallclock"] else 0.0
            out.append(f"| {c['label']} | {fid:.2f} | {wall:.1f} |")
        out.append("")
    return "\n".join(out)


def fmt_perf_section():
    out = ["## §Perf\n"]
    files = sorted(glob.glob(os.path.join(PERF_DIR, "*.json")))
    if not files:
        out.append("(hillclimb records pending)")
    for p in files:
        with open(p) as f:
            d = json.load(f)
        out.append(f"### {d['pair']}\n")
        for it in d["iterations"]:
            out.append(f"- **{it['name']}** — hypothesis: {it['hypothesis']}")
            out.append(f"  - change: {it['change']}")
            out.append(f"  - before: {it['before']}  after: {it['after']}")
            out.append(f"  - verdict: {it['verdict']}")
        out.append("")
    return "\n".join(out)


def main():
    print(fmt_dryrun_section())
    print()
    print(fmt_roofline_section())
    print()
    print(fmt_bench_section())
    print()
    print(fmt_perf_section())


if __name__ == "__main__":
    main()
