"""GAN objectives — the paper's equations (1) and (2), in softplus form.

  g_theta(theta, phi, z)    = grad_theta log(1 - D(phi, G(theta, z)))      (1)
  g_phi(theta, phi, z, x)   = grad_phi [log D(phi, x)
                                        + log(1 - D(phi, G(theta, z)))]    (2)

Algorithm 1 *ascends* g_phi; Algorithm 3 *descends* g_theta (minimax
default) or the non-saturating -log D(G(z)). With logits l:
log D = -softplus(-l), log(1 - D) = -softplus(l).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def log_d(logits):
    return -F.softplus(-logits)


def log_one_minus_d(logits):
    return -F.softplus(logits)


def disc_objective(real_logits, fake_logits):
    """Paper eq (2) objective (to MAXIMIZE): E[log D(x)] + E[log(1-D(G(z)))]."""
    return torch.mean(log_d(real_logits)) + torch.mean(
        log_one_minus_d(fake_logits))


def gen_objective_minimax(fake_logits):
    """Paper eq (1) objective (to MINIMIZE): E[log(1-D(G(z)))]."""
    return torch.mean(log_one_minus_d(fake_logits))


def gen_objective_nonsaturating(fake_logits):
    """-E[log D(G(z))] (to MINIMIZE) — Goodfellow's practical variant."""
    return -torch.mean(log_d(fake_logits))


def gen_objective(fake_logits, *, variant: str = "minimax"):
    if variant == "minimax":
        return gen_objective_minimax(fake_logits)
    if variant == "nonsaturating":
        return gen_objective_nonsaturating(fake_logits)
    raise ValueError(f"unknown generator loss variant {variant!r}")
