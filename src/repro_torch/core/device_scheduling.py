"""Device scheduling (paper Step 1 / Fig. 6) as tensor code on the round's
device, for the fused driver. Port of `repro.core.jax_scheduling`.

The same five policies as `core.scheduling`, as one step whose mutable
pieces, the round-robin cursor and the proportional-fair EWMA rates,
travel in an explicit carry of tensors instead of a host dataclass, so
a captured round schedules with no host sync.

Equivalence with the numpy twin and with the JAX package's
`schedule_step`:

  * `all`, `round_robin`, `best_channel`, `prop_fair` select the SAME
    device sets under identical rates (the top n by a STABLE ascending
    argsort, as `jnp.argsort` and numpy's for distinct values),
    including the cursor's wrap-around and the EWMA's evolution (float32
    here and in JAX, float64 in numpy).
  * `random` takes a permutation drawn before the round (the caller's
    stream), so it matches the others in distribution only.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class DeviceScheduler:
    """Static scheduling configuration. The per-round mutable state lives
    in the carry from `init_carry`: {"rr_cursor": int32 0-dim,
    "ewma_rate": float32 (K,)}."""
    policy: str
    n_devices: int
    ratio: float = 1.0
    ewma_alpha: float = 0.2

    @property
    def n_scheduled(self) -> int:
        return max(1, math.ceil(self.ratio * self.n_devices))

    def init_carry(self, device):
        return {"rr_cursor": torch.zeros((), dtype=torch.int32,
                                         device=device),
                "ewma_rate": torch.ones(self.n_devices, dtype=torch.float32,
                                        device=device)}


def _mask_of(idx, k: int, device):
    return torch.zeros(k, dtype=torch.bool, device=device).index_fill(
        0, idx, True)


def _top_n_mask(scores, n: int):
    """Boolean mask of the n highest-scoring devices: the tail of a
    stable ascending argsort, as the numpy twin's `argsort(x)[-n:]`."""
    k = scores.shape[0]
    idx = torch.argsort(scores, stable=True)[k - n:]
    return _mask_of(idx, k, scores.device)


def schedule_step(sched: DeviceScheduler, carry, rates, perm=None):
    """One scheduling decision: (carry, rates (K,), perm) -> (mask,
    new_carry). `perm`: a (K,) permutation of the devices, drawn before
    the round; the `random` policy schedules its first n."""
    k, n = sched.n_devices, sched.n_scheduled
    device = rates.device
    cursor = carry["rr_cursor"]
    if sched.policy == "all":
        mask = torch.ones(k, dtype=torch.bool, device=device)
    elif sched.policy == "round_robin":
        idx = (cursor + torch.arange(n, device=device)) % k
        mask = _mask_of(idx, k, device)
        cursor = ((cursor + n) % k).to(torch.int32)
    elif sched.policy == "best_channel":
        mask = _top_n_mask(rates, n)
    elif sched.policy == "prop_fair":
        priority = rates / torch.clamp(carry["ewma_rate"], min=1e-12)
        mask = _top_n_mask(priority, n)
    elif sched.policy == "random":
        if perm is None:
            raise ValueError("the random policy takes the round's "
                             "permutation")
        mask = _mask_of(perm[:n], k, device)
    else:
        raise ValueError(f"unknown scheduling policy {sched.policy!r}")

    served = torch.where(mask, rates, torch.zeros_like(rates)).float()
    ewma = ((1.0 - sched.ewma_alpha) * carry["ewma_rate"]
            + sched.ewma_alpha * served)
    return mask, {"rr_cursor": cursor, "ewma_rate": ewma}
