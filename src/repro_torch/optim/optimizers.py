"""Minimal functional optimizers over parameter trees.

`Optimizer.update(grads, state)` returns `(updates, new_state)` where
`updates` are ADDED to params to descend `grads` — the interface of
`repro.optim.optimizers`, so a step is the same arithmetic in both
packages. The paper's Algorithms 1 and 3 use plain mini-batch SGD;
momentum and Adam are the practical variants.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _add_keeping_dtype(p, u):
    if u.dtype != p.dtype and torch.result_type(p, u) != p.dtype:
        raise TypeError(
            f"an update of dtype {u.dtype} would turn a {p.dtype} parameter "
            f"{tuple(p.shape)} into {torch.result_type(p, u)}; the JAX "
            f"package's local and server steps are lax.scan loops, which "
            f"refuse a carry whose dtype changes (Adam's float32 update on a "
            f"bfloat16 state): use an optimizer that keeps the parameters' "
            f"dtype (sgd, momentum) or float32 parameters")
    return torch.add(p, u)


def apply_updates(params, updates):
    """params + updates, leaf by leaf. Raises TypeError where an update
    would change a parameter's dtype, as the JAX package's scans over
    the local and server steps do."""
    return tree_map(_add_keeping_dtype, params, updates)


def _weak(c: float, x: torch.Tensor) -> float:
    """The Python scalar `c` rounded to x's dtype, as the JAX package's
    weakly typed scalars take the array's dtype (a bfloat16 gradient is
    scaled by bfloat16(lr)); the identity in float32."""
    return float(torch.tensor(c, dtype=x.dtype))


def sgd(lr: float) -> Optimizer:
    def init(_params):
        return {}

    def update(grads, state):
        return tree_map(lambda g: _weak(-lr, g) * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state):
        mu = tree_map(lambda m, g: _weak(beta, m) * m + g, state["mu"],
                      grads)
        return tree_map(lambda m: _weak(-lr, m) * m, mu), {"mu": mu}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with float32 moments and an int32 step count; the bias
    corrections are computed in float32, as in the JAX package."""
    def init(params):
        zeros = lambda: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()
        updates = tree_map(
            lambda mi, vi: -lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps),
            m, v)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
