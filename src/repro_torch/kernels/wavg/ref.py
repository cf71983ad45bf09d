"""Plain PyTorch version of the wavg kernel (the CPU path and the oracle)."""
import torch


def wavg_ref(x, w):
    """x: (K, N), w: (K,) normalized -> (N,) float32, f32 accumulate."""
    return (w.float()[:, None] * x.float()).sum(0)
