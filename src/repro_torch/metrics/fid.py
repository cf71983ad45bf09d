"""Fréchet inception distance (paper's metric, [11]).

The exact Fréchet formula, in float64 numpy as in `repro.metrics.fid`:
    FID = |mu1 - mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^{1/2})
with the matrix square root computed via the symmetric eigensystem of
sqrt(S1) S2 sqrt(S1).

InceptionV3 weights are not available offline, so the features come
from a FIXED random convolutional network (3 strided conv stages + tanh
+ global average pool), as in the JAX package. Its three weights are
drawn from a seeded `torch.Generator` unless the caller passes them, so
the port's FID values are NOT comparable with the JAX package's unless
both use the same weights (tests pass the JAX package's).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def make_feature_extractor(channels: int, *, feat_dim: int = 64,
                           seed: int = 42, weights=None, device=None):
    """Fixed random conv feature extractor: images (b,H,W,C) -> (b, feat).

    weights: optional three HWIO arrays (4, 4, channels, 16),
    (4, 4, 16, 32), (4, 4, 32, feat_dim); by default they are drawn from
    a CPU generator seeded with `seed`, so every device gets the same.
    """
    device = resolve_device(device)
    if weights is None:
        gen = torch.Generator().manual_seed(seed)
        shapes = [(4, 4, channels, 16), (4, 4, 16, 32), (4, 4, 32, feat_dim)]
        weights = [torch.randn(s, generator=gen) / d
                   for s, d in zip(shapes, (4.0, 8.0, 16.0))]
    ws = [torch.as_tensor(np.asarray(w), dtype=torch.float32)
          .to(device).permute(3, 2, 0, 1) for w in weights]   # HWIO -> OIHW

    @torch.no_grad()
    def features(images):
        x = images.float().permute(0, 3, 1, 2)
        for w in ws:
            x = torch.tanh(F.conv2d(x, w, stride=2, padding=1))
        return x.mean(dim=(2, 3))

    return features


def make_token_feature_extractor(vocab: int, *, feat_dim: int = 64,
                                 seed: int = 42, weights=None, device=None):
    """Fixed random features for token/embedding sequences, as in the
    JAX package: (b, s) integer tokens -> rows of a (vocab, feat_dim)
    table; (b, s, d) embeddings -> tanh(x @ proj) with a (d, feat_dim)
    projection; then the sequence mean and the population std (ddof 0,
    as `jnp.std`) of tanh of those, (b, 2 * feat_dim).

    weights: optional {"table": (vocab, feat_dim), "proj": (d, feat_dim)}
    (proj already scaled by d ** -0.5); by default the table is
    0.3 * N(0, 1) and proj N(0, 1) * d ** -0.5, drawn from CPU generators
    seeded with `seed`, so every device gets the same.
    """
    device = resolve_device(device)
    if weights is None:
        gen = torch.Generator().manual_seed(seed)
        table = torch.randn((vocab, feat_dim), generator=gen) * 0.3
        proj = None
    else:
        table = torch.tensor(np.asarray(weights["table"]))
        proj = torch.tensor(np.asarray(weights["proj"]))
    table = table.float().to(device)
    projs = {} if proj is None else {proj.shape[0]: proj.float().to(device)}

    def projection(d):
        if d not in projs:
            gen = torch.Generator().manual_seed(seed + 1)
            projs[d] = (torch.randn((d, feat_dim), generator=gen)
                        * d ** -0.5).to(device)
        return projs[d]

    @torch.no_grad()
    def features(x):
        if x.dim() == 2:                      # token ids
            e = table[x.to(device).long()]
        else:
            e = torch.tanh(x.float() @ projection(x.shape[-1]))
        # first + second order sequence statistics
        return torch.cat([e.mean(1), torch.tanh(e).std(1, correction=0)],
                         dim=-1)

    return features


def _as_numpy(feats) -> np.ndarray:
    if isinstance(feats, torch.Tensor):
        feats = feats.detach().cpu().numpy()
    return np.asarray(feats, dtype=np.float64)


def feature_stats(feats) -> tuple[np.ndarray, np.ndarray]:
    f = _as_numpy(feats)
    mu = f.mean(0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    s1_half = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1_half @ cov2 @ s1_half)
    d2 = float(np.sum((mu1 - mu2) ** 2)
               + np.trace(cov1 + cov2 - 2.0 * inner))
    return max(d2, 0.0)


def fid_score(real_feats, fake_feats) -> float:
    mu1, c1 = feature_stats(real_feats)
    mu2, c2 = feature_stats(fake_feats)
    return frechet_distance(mu1, c1, mu2, c2)
