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


def apply_updates(params, updates):
    return tree_map(torch.add, params, updates)


def sgd(lr: float) -> Optimizer:
    def init(_params):
        return {}

    def update(grads, state):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state):
        mu = tree_map(lambda m, g: beta * m + g, state["mu"], grads)
        return tree_map(lambda m: -lr * m, mu), {"mu": mu}

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
