"""Device scheduling (paper Step 1 / Section IV Fig. 6).

The server selects S ⊆ K devices each round. Implemented policies:

  all           every device, every round
  round_robin   a rotating window of ceil(ratio*K) devices
  best_channel  the ceil(ratio*K) devices with the best instantaneous
                channel (what Fig. 6 uses: "devices with the best channels")
  prop_fair     proportional fair: rank by instantaneous rate divided by
                an exponentially-averaged historical rate
  random        uniform random subset (ablation)

All policies are host-side (numpy) — they produce a boolean mask that
feeds the round step as the weight vector. Stragglers (footnote 1)
are excluded downstream by the channel simulator. A copy of
`repro.core.scheduling`: the same calls on the same numpy generator give
the same masks bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class SchedulerState:
    policy: str
    n_devices: int
    ratio: float = 1.0
    rr_cursor: int = 0
    ewma_rate: np.ndarray | None = None   # for prop_fair
    ewma_alpha: float = 0.2

    def __post_init__(self):
        if self.ewma_rate is None:
            self.ewma_rate = np.ones(self.n_devices)

    @property
    def n_scheduled(self) -> int:
        return max(1, math.ceil(self.ratio * self.n_devices))


def schedule_round(state: SchedulerState, rates: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """rates: (K,) instantaneous uplink rates from the channel simulator.
    Returns boolean mask (K,) of scheduled devices and advances state."""
    k, n = state.n_devices, state.n_scheduled
    mask = np.zeros(k, dtype=bool)
    if state.policy == "all":
        mask[:] = True
    elif state.policy == "round_robin":
        idx = (state.rr_cursor + np.arange(n)) % k
        mask[idx] = True
        state.rr_cursor = (state.rr_cursor + n) % k
    elif state.policy == "best_channel":
        mask[np.argsort(rates)[-n:]] = True
    elif state.policy == "prop_fair":
        priority = rates / np.maximum(state.ewma_rate, 1e-12)
        mask[np.argsort(priority)[-n:]] = True
    elif state.policy == "random":
        mask[rng.choice(k, size=n, replace=False)] = True
    else:
        raise ValueError(f"unknown scheduling policy {state.policy!r}")

    served = np.where(mask, rates, 0.0)
    state.ewma_rate = ((1 - state.ewma_alpha) * state.ewma_rate
                       + state.ewma_alpha * served)
    return mask
