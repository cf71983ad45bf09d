"""Roofline terms and memory from a dry run's counts: the port's
counterpart of `repro.launch.analysis`.

Hardware constants: the NVIDIA H100 SXM at its 700 W limit, from its
published figures:
  989e12 FLOP/s dense bfloat16 (tensor cores), 3.35e12 B/s HBM3, and
  450e9 B/s NVLink each way.
There is one FLOP rate, the bfloat16 peak, so `compute_s` is a lower
bound on the compute time: float32 work (the port's norms, softmaxes,
quantizer and flat payload, and the kernels' three-pass TF32 products)
runs slower than that peak, and nothing runs faster.

The counts come from `launch.hlo_costs`, one call of the step on the
meta device (or on real tensors): loop trips are counted because eager
dispatch runs them. The JAX package's `parse_collective_bytes` (a
regex scan of the HLO text) and `xla_cost_analysis_raw` (XLA's own
cost analysis, loop bodies counted once) have no counterpart: the port
has no compiled artifact to scan or to ask, and its collectives report
their bytes at their call sites.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12         # bf16 dense / card
HBM_BW = 3.35e12            # bytes/s / card
NVLINK_BW = 450e9           # bytes/s / card, each way


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / (self.n_chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.n_chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.n_chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
        }


def analyze(costs: dict, memory: dict, n_chips: int) -> dict:
    """The counterpart of `analyze_compiled`: `costs` (a `CostCounter`'s
    `totals()`) are one card's or one rank's program, so they are scaled
    by `n_chips` to global quantities for the roofline, as the JAX
    package scales its per-device SPMD module; `memory` (the counter's
    `memory()`) stays per card. Returns the JAX package's roofline /
    collectives / memory dict, with the kernels' counts beside it
    (unscaled)."""
    coll = {"bytes_by_kind": {k: v * n_chips
                              for k, v in costs["bytes_by_kind"].items()},
            "counts": dict(costs["counts"]),
            "total_bytes": costs["collective_bytes"] * n_chips}
    roof = Roofline(flops=costs["flops"] * n_chips,
                    hbm_bytes=costs["hbm_bytes"] * n_chips,
                    collective_bytes=costs["collective_bytes"] * n_chips,
                    n_chips=n_chips)
    return {"roofline": roof.as_dict(), "collectives": coll,
            "memory": dict(memory), "kernels": costs.get("kernels", {})}


def model_flops_per_round(n_params_active: int, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) with N = active params."""
    return 6.0 * n_params_active * tokens
