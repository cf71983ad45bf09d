"""Wrapper of the hand-written Hopper wavg kernel (Algorithm 2).

    out[n] = sum_k w[k] * x[k, n]        (weights pre-normalized)

A CUDA tensor launches the kernel in `repro_torch/csrc/wavg.cu` or
raises; a CPU tensor takes the plain version (`ref.wavg_ref`), and only
because it lies on the CPU; a meta tensor (a dry run) gets the kernel's
output, empty, and launches nothing. `launches` counts kernel launches,
so a run can show that its Algorithm 2 went through the kernel. A launch
and a meta call report the kernel's work (`cost`) to an open
`launch.hlo_costs` counter.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import load_library
from repro_torch.launch import hlo_costs
from repro_torch.kernels.wavg.ref import wavg_ref

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

# The kernel keeps w in 48 KiB of shared memory.
MAX_K = 12288


@functools.cache
def _kernel():
    fn = load_library("wavg", ("wavg.cu",)).wavg_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Compile (if needed) and load the kernel library."""
    _kernel()


def _check(x, w):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(f"wavg takes x (K, N) and w (K,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"wavg takes float32; got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("wavg takes contiguous x and w")
    k, n = x.shape
    if not 1 <= k <= MAX_K or n < 1:
        raise ValueError(f"wavg takes 1 <= K <= {MAX_K} and N >= 1; "
                         f"got K={k}, N={n}")


def cost(k: int, n: int):
    """(flops, bytes) of one launch on a (K, N) payload: a multiply-add
    an element; x and w read once, the mean written once (the bound of
    PERF.md section 6, row 1)."""
    return 2 * k * n, (k * n + k + n) * 4


def weighted_average(x, w):
    """x: (K, N) float32 stacked payload; w: (K,) normalized float32
    weights -> (N,) float32."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        with hlo_costs.plain_call("wavg"):
            return wavg_ref(x, w)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"wavg runs on CUDA, CPU or meta tensors, not "
                         f"{x.device}")
    k, n = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        hlo_costs.record_kernel("wavg", *cost(k, n))
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
                        stream)
    if err != 0:
        raise RuntimeError(f"wavg kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    hlo_costs.record_kernel("wavg", *cost(k, n))
    return out


__all__ = ["weighted_average", "wavg_ref", "build", "cost", "MAX_K"]
