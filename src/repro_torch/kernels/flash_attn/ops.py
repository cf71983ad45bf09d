"""Wrapper of the hand-written Hopper flash_attn kernel: causal (or
sliding-window, or bidirectional) grouped-query attention forward with
an online softmax, s queries against t keys, the counterpart of
`repro.kernels.flash_attn.kernel.flash_attention_pallas` and of the JAX
attention's flash branch (self-attention, the encoder's bidirectional
self-attention and cross-attention).

A CUDA tensor launches the kernel in `repro_torch/csrc/flash_attn.cu` or
raises; a CPU tensor takes the plain version (`ref.
flash_attention_plain`), and only because it lies on the CPU; a meta
tensor (a dry run) takes the kernel's path up to the launch, and gets
its outputs, empty. `launches` counts kernel launches, so a run can show
that its attention went through the kernel. A launch and a meta call
report the kernel's work (`cost`) to an open `launch.hlo_costs` counter.

The gradient: the JAX package has no backward kernel (its `custom_vjp`
runs the blockwise FlashAttention-2 backward of `repro.nn.flash_ref` on
the forward's residuals). `FlashAttention`, a `torch.autograd.Function`,
runs the forward (the kernel, or the plain version passed in by a test),
saves q, k, v, out and the row log-sum-exp, and runs the port of that
backward (`nn.flash_ref.flash_backward`) on them: the forward kernel is
not launched again.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.flash_attn.ref import (flash_attention_plain,
                                                fold_queries,
                                                folded_positions,
                                                unfold_queries)
from repro_torch.launch import hlo_costs
from repro_torch.nn.flash_ref import flash_backward

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

# head_dim values the kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 128, 256)

# The C entry point's parameters: q, k, v, out, lse, stream; b, s, t, H,
# KV, D, causal, window (0: none), bf16; the strides of q, k and v over
# (batch, sequence, head).
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 9


@functools.cache
def _kernel():
    fn = load_library("flash_attn", ("flash_attn.cu",)).flash_attn
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def build():
    """Compile (if needed) and load the kernel library."""
    _kernel()


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (b, s, H, D) and k, v "
                         "(b, t, KV, D)")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or h % kv:
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k "
                         f"and v of one dtype, not {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v on several devices")
    if min(b, s, t, h, d) < 1:
        raise ValueError("empty input")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1 leaves queries no key")
    if window is not None and t + window <= s:
        # query i sees keys (i - window, i] (causal) or (i - window, t)
        # (not causal), so the last s - t - window + 1 queries see none
        raise ValueError(
            f"window {window} over t={t} keys leaves queries "
            f"{t + window - 1}..{s - 1} of s={s} no key (needs t + window "
            f"> s)")
    return b, s, t, h, kv, d


def key_pairs(s: int, t: int, causal: bool = True, window=None) -> int:
    """The (query, key) pairs a call computes: query i sees the keys j
    with lo_i <= j <= hi_i, hi_i = min(i, t - 1) (causal) or t - 1, lo_i
    = max(i - window + 1, 0) (window set) or 0; a call that `_check`
    takes leaves no query without a key, so the pairs are the sums
    of hi_i - lo_i + 1 over the s queries. A causal call over s = t
    positions has s (s + 1) / 2, or w (w + 1) / 2 + (s - w) w with a
    window w; a bidirectional one s t."""
    last = t - 1
    if causal:
        n = min(s, t)                     # the queries with hi_i = i
        hi = n * (n - 1) // 2 + (s - n) * last
    else:
        hi = s * last
    lo = 0
    if window is not None and s > window:
        lo = (s - window) * (s - window + 1) // 2
    return hi - lo + s


def cost(b: int, s: int, t: int, h: int, kv: int, d: int, *,
         causal: bool = True, window=None, itemsize: int = 4):
    """(flops, bytes) of one launch, PERF.md section 6's formulas (row
    4): 2 D flops each of q.k and of p.v for every pair it computes,
    4 b H D pairs; q, k and v read once (`itemsize` bytes an element),
    the float32 out and lse written once."""
    pairs = key_pairs(s, t, causal, window)
    n_bytes = (itemsize * (b * s * h * d + 2 * b * t * kv * d)
               + 4 * (b * s * h * d + b * h * s))
    return 4 * b * h * d * pairs, n_bytes


def _readable(t):
    """t itself where the kernel can read it through its strides (unit
    stride in D, a 16-byte aligned start, strides of whole 16 bytes),
    else a contiguous copy."""
    step = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % step == 0 for st in t.stride()[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_forward(q, k, v, causal, window):
    """Launch the kernel: out (b, s, H, D) float32, contiguous, and lse
    (b, H, s) float32. On meta tensors the same outputs, empty, and no
    launch."""
    global launches
    b, s, t, h, kv, d = _check(q, k, v, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the flash_attn kernel runs on CUDA tensors, not "
                         f"{q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash_attn kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {d}")
    q, k, v = (_readable(t) for t in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    work = cost(b, s, t, h, kv, d, causal=causal, window=window,
                itemsize=q.element_size())
    if q.device.type == "meta":
        hlo_costs.record_kernel("flash_attn", *work)
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), stream, b, s, t, h, kv, d, int(causal),
            0 if window is None else window, int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    hlo_costs.record_kernel("flash_attn", *work)
    return out, lse


def _plain_forward(q, k, v, causal, window):
    _check(q, k, v, window)
    with hlo_costs.plain_call("flash_attn"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """forward(fwd, q, k, v, causal, window): `fwd` computes (out, lse);
    the backward runs `nn.flash_ref.flash_backward` on the saved q, k,
    v, out and lse, with the group folded into the query axis and k, v
    not repeated."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, causal, window):
        out, lse = fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        b, s, h, d = q.shape
        t, kv = k.shape[1], k.shape[2]
        # a named range, so a profile can attribute the backward's device
        # time
        with torch.profiler.record_function("FlashAttention.backward"):
            q_pos, k_pos = folded_positions(s, t, h // kv, q.device)
            dq, dk, dv = flash_backward(
                fold_queries(q, kv), k.transpose(1, 2), v.transpose(1, 2),
                q_pos, k_pos, d ** -0.5, fold_queries(out, kv),
                lse.reshape(b, kv, -1), fold_queries(dout, kv), ctx.causal,
                ctx.window)
        return (None, unfold_queries(dq, s), dk.transpose(1, 2),
                dv.transpose(1, 2), None, None)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention of q (b, s, H, D) over k, v (b, t, KV, D), any t >= 1,
    query i at position i and key j at position j, scale D ** -0.5; key
    j is seen by query i when j <= i (causal) and j > i - window (window
    set); bidirectional (causal=False, no window) every query sees all t
    keys (the encoder's self-attention, cross-attention). Returns
    (b, s, H, D) float32.

    A call in which some query sees no key (a window with t + window <=
    s, causal or not) raises a ValueError on the CPU and the card alike:
    the JAX kernel returns the mean of the values there, which depends
    on the padding, and no model call asks for such a row."""
    if q.device.type == "cpu":
        fwd = _plain_forward
    elif q.device.type in ("cuda", "meta"):
        fwd = _kernel_forward
    else:
        raise ValueError(f"flash_attention runs on CUDA, CPU or meta "
                         f"tensors, not {q.device}")
    return FlashAttention.apply(fwd, q, k, v, causal, window)


__all__ = ["flash_attention", "FlashAttention", "flash_attention_plain",
           "build", "cost", "key_pairs"]
