"""Robust Algorithm 2 reducers over the flat (K, N) payload, for hostile
worker populations (`repro_torch.core.faults`). Port of
`repro.kernels.robust_avg.ops`.

Every method is ONE kernel launch on the (K, N) payload:

  trimmed_mean — the hand-written Hopper kernel in
      `repro_torch/csrc/trimmed_wavg.cu` (wrapper `trimmed_average`).
  norm_clip    — per-row L2 norms and the median-norm clip threshold
      (O(K) work on the payload) give EFFECTIVE WEIGHTS that the wavg
      kernel reduces.
  krum         — multi-Krum scores from one (K, K) Gram product; the
      selected set's weights go to the wavg kernel.

Weights are RAW participation-aware weights (0 = dropped worker). In the
identity regimes (trim=0, a clip_factor no row reaches, krum_f=0) the
result is the plain weighted average. On a CPU tensor `trimmed_average`
takes its plain version (`ref.trimmed_mean_ref`), and only because the
tensor lies on the CPU; on a CUDA tensor it launches the kernel or
raises; on a meta tensor (a dry run) it returns the kernel's output,
empty, and launches nothing. `launches` counts its kernel launches; a
launch and a meta call report the kernel's work (`cost`) to an open
`launch.hlo_costs` counter.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.robust_avg.ref import trimmed_mean_ref
from repro_torch.kernels.wavg import ops as wavg_ops
from repro_torch.launch import hlo_costs

ROBUST_METHODS = ("trimmed_mean", "norm_clip", "krum")

# trimmed_wavg kernel launches since import (or since a caller reset it).
launches = 0

# The kernel keeps a column's inclusion set in one 64-bit mask.
MAX_K = 64


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Robust-reducer selection and parameters."""
    method: str = "trimmed_mean"
    trim: int = 1                       # (max, min) pairs per coordinate
    clip_factor: float = 2.0            # tau = factor x median norm
    krum_f: int = 1                     # assumed byzantine count
    krum_m: Optional[int] = None        # multi-Krum size (None: n_part - f)

    def __post_init__(self):
        if self.method not in ROBUST_METHODS:
            raise ValueError(f"unknown robust method {self.method!r} "
                             f"(have {ROBUST_METHODS})")
        if self.trim < 0:
            raise ValueError(f"trim must be >= 0 (got {self.trim})")
        if self.clip_factor <= 0:
            raise ValueError(
                f"clip_factor must be > 0 (got {self.clip_factor})")
        if self.krum_f < 0:
            raise ValueError(f"krum_f must be >= 0 (got {self.krum_f})")


@functools.cache
def _kernel():
    fn = load_library("trimmed_wavg", ("trimmed_wavg.cu",)).trimmed_wavg_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Compile (if needed) and load the kernel library."""
    _kernel()


def _check(x, w, trim):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(f"trimmed_wavg takes x (K, N) and w (K,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"trimmed_wavg takes float32; got {x.dtype} and "
                         f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("trimmed_wavg takes contiguous x and w")
    k, n = x.shape
    if not 1 <= k <= MAX_K or n < 1:
        raise ValueError(f"trimmed_wavg takes 1 <= K <= {MAX_K} and N >= 1;"
                         f" got K={k}, N={n}")
    if not 0 <= trim < 2 ** 31:
        raise ValueError(f"trim must be a non-negative int32 (got {trim})")


def cost(k: int, n: int):
    """(flops, bytes) of one launch on a (K, N) payload: the bytes of
    PERF.md section 6's bound (row 3; x and w read once, the mean
    written once) and a multiply-add an element for the weighted sum
    (the selection's comparisons are not products, which is all the
    counter counts as flops)."""
    return 2 * k * n, (k * n + k + n) * 4


def trimmed_average(x, w, *, trim: int):
    """Coordinate trimmed mean of x (K, N) float32 with RAW float32
    weights w (K,) -> (N,) float32."""
    global launches
    trim = int(trim)
    _check(x, w, trim)
    if x.device.type == "cpu":
        with hlo_costs.plain_call("trimmed_wavg"):
            return trimmed_mean_ref(x, w, trim)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"trimmed_wavg runs on CUDA, CPU or meta tensors, "
                         f"not {x.device}")
    k, n = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        hlo_costs.record_kernel("trimmed_wavg", *cost(k, n))
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
                        trim, stream)
    if err != 0:
        raise RuntimeError(f"trimmed_wavg kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    hlo_costs.record_kernel("trimmed_wavg", *cost(k, n))
    return out


def _masked_median(v, mask):
    """Median of v[mask] (mean of the two middle order statistics, as
    np.median), 0 when the mask is empty. No host sync: the order
    statistics are gathered by 0-dim index tensors (`torch.take`; an
    index `s[lo]` would read `lo` on the host)."""
    k = v.shape[0]
    s = torch.sort(torch.where(mask, v, torch.inf)).values
    n_part = mask.sum()
    lo = torch.clamp((n_part - 1) // 2, 0, k - 1)
    hi = torch.clamp(n_part // 2, 0, k - 1)
    return torch.where(n_part > 0,
                       0.5 * (torch.take(s, lo) + torch.take(s, hi)), 0.0)


def clip_weights(x, w, *, clip_factor: float):
    """Norm clipping as an effective-weight transform: row k scaled by
    s_k = min(1, clip_factor * median participant norm / ||x_k||), the
    mean normalized by the ORIGINAL weight total (clipped rows shrink
    toward zero). Returns the normalized weights for the wavg kernel."""
    part = w > 0
    norms = torch.sqrt(torch.sum(x * x, dim=1))
    tau = clip_factor * _masked_median(norms, part)
    scale = torch.clamp(tau / torch.clamp(norms, min=1e-12), max=1.0)
    w_eff = torch.where(part, w * scale, 0.0)
    return w_eff / torch.clamp(w.sum(), min=1e-12)


def krum_weights(x, w, *, f: int, m: Optional[int] = None):
    """Multi-Krum selection as an effective-weight transform: score by
    the sum of the q = clamp(n_part - f - 2, 1, K-1) smallest squared
    distances to other participants (one Gram product), keep the
    m = max(n_part - f, 1) lowest scores (ties by lowest index, a
    stable sort), and return the selected weights normalized."""
    k = x.shape[0]
    part = w > 0
    n_part = part.sum()
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    d2 = torch.where(~part[:, None] | ~part[None, :] | eye, torch.inf, d2)
    q = torch.clamp(n_part - f - 2, 1, k - 1)
    ds = torch.sort(d2, dim=1).values
    take = torch.arange(k, device=x.device)[None, :] < q
    score = torch.sum(torch.where(take & torch.isfinite(ds), ds, 0.0), dim=1)
    score = torch.where(part, score, torch.inf)
    m_sel = (torch.clamp(n_part - f, min=1) if m is None
             else torch.full((), m, device=x.device))
    m_sel = torch.minimum(torch.clamp(m_sel, min=1),
                          torch.clamp(n_part, min=1))
    order = torch.argsort(score, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k, device=x.device)
    sel = (rank < m_sel) & part
    w_eff = torch.where(sel, w, 0.0)
    return w_eff / torch.clamp(w_eff.sum(), min=1e-12)


def robust_average(x, w, cfg: RobustConfig):
    """Robust weighted aggregate of the payload x (K, N) with raw
    weights w (K,) -> (N,) float32, in one kernel launch."""
    x, w = x.float(), w.float()
    if cfg.method == "trimmed_mean":
        return trimmed_average(x, w, trim=cfg.trim)
    if cfg.method == "norm_clip":
        v = clip_weights(x, w, clip_factor=cfg.clip_factor)
    elif cfg.method == "krum":
        v = krum_weights(x, w, f=cfg.krum_f, m=cfg.krum_m)
    else:
        raise ValueError(cfg.method)
    return wavg_ops.weighted_average(x, v)


__all__ = ["ROBUST_METHODS", "RobustConfig", "trimmed_average",
           "trimmed_mean_ref", "clip_weights", "krum_weights",
           "robust_average", "build", "cost", "MAX_K"]
