"""Roofline table from the dry-run JSONs (results/torch/dryrun/*.json,
written by `python -m repro_torch.launch.dryrun`). Port of the JAX
package's `benchmarks/roofline_report.py`.

    python -m repro_torch.experiments.roofline_report

Per (arch x shape x mesh): the three roofline terms (against the H100's
published peaks, `launch.analysis`), the dominant bottleneck,
MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (serve), the
useful-compute ratio MODEL_FLOPS / counted FLOPs, and the reckoned peak
memory a card. Every figure is reckoned on the meta device, none
measured on a card.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import INPUT_SHAPES, get_arch_config

DRY_DIR = os.path.join("results", "torch", "dryrun")


def active_params(cfg) -> int:
    """Active (per-token) parameter count, MoE uses top_k experts. The
    JAX package's arithmetic line for line, so that both reports give
    the same figure: it counts the hybrid family's attention blocks as
    `(cfg.n_layers // cfg.attn_every) * 0` beside the one shared block,
    and computes the vlm family's `n_cross` without using it."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    if cfg.moe:
        ff = 3 * d * cfg.moe.d_ff_expert * cfg.moe.top_k + d * cfg.moe.n_experts
    elif cfg.family == "ssm":
        ff = 0
    else:
        ff = 3 * d * cfg.d_ff
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        per = d * (2 * d_in + 2 * s.n_groups * s.d_state
                   + d_in // s.head_dim) + d_in * d
        return cfg.n_layers * per + 2 * cfg.vocab * d
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        per = d * (2 * d_in + 2 * s.n_groups * s.d_state
                   + d_in // s.head_dim) + d_in * d
        shared = attn + 3 * d * cfg.d_ff
        return (cfg.n_layers * per
                + (cfg.n_layers // cfg.attn_every) * 0 + shared
                + 2 * cfg.vocab * d)
    per_layer = attn + ff
    n_cross = 0
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // (cfg.cross_attn_every + 1)  # noqa: F841
    return cfg.n_layers * per_layer + 2 * cfg.vocab * d


def tokens_processed(cfg, shape, pcfg_nd=5, pcfg_ng=5, k_dev=16) -> float:
    """Token-steps consumed by one step of this shape's kind."""
    if shape.kind == "train":
        n_k = shape.global_batch // k_dev
        disc_tokens = k_dev * pcfg_nd * n_k * shape.seq_len * 2  # real+fake
        gen_fwd_for_fakes = k_dev * pcfg_nd * n_k * shape.seq_len
        gen_tokens = pcfg_ng * k_dev * shape.seq_len
        return disc_tokens + gen_fwd_for_fakes + gen_tokens
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per sequence


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS of one step: 6 N_active D training, 2 N_active D
    serving."""
    n_active = active_params(cfg)
    if shape.kind != "train":
        return 2.0 * n_active * tokens_processed(cfg, shape)
    return 6.0 * n_active * tokens_processed(cfg, shape)


def load_rows(dry_dir=DRY_DIR, tag=""):
    rows = []
    suffix = f"_{tag}.json" if tag else ".json"
    for path in sorted(glob.glob(os.path.join(dry_dir, f"*{suffix}"))):
        base = os.path.basename(path)
        if tag == "" and base.count("__") != 2:
            continue
        with open(path) as f:
            d = json.load(f)
        cfg = get_arch_config(d["arch"])
        flops = model_flops(cfg, INPUT_SHAPES[d["shape"]])
        r = d["roofline"]
        rows.append({
            "arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "model_flops": flops,
            "useful_ratio": flops / r["flops"] if r["flops"] else 0.0,
            "peak_gb": (d["memory"].get("peak_bytes") or 0) / 1e9,
        })
    return rows


def table_lines(rows):
    """The report's table, a line a row, the JAX report's columns."""
    lines = [f"{'arch':24s} {'shape':12s} {'mesh':6s} {'compute_s':>10s} "
             f"{'memory_s':>10s} {'collect_s':>10s} {'dominant':>10s} "
             f"{'useful':>7s} {'peak_GB':>8s}"]
    for r in rows:
        lines.append(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
                     f"{r['compute_s']:10.3e} {r['memory_s']:10.3e} "
                     f"{r['collective_s']:10.3e} {r['dominant']:>10s} "
                     f"{r['useful_ratio']:7.2f} {r['peak_gb']:8.2f}")
    return lines


def main():
    rows = load_rows()
    if not rows:
        print("no dry-run results found — run repro_torch.launch.dryrun "
              "first")
        return
    print("\n".join(table_lines(rows)))


if __name__ == "__main__":
    main()
