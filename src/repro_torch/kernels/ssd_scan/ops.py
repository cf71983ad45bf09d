"""Wrapper of the hand-written Hopper ssd_scan kernel (the Mamba-2 SSD
chunked scan), a drop-in for `repro_torch.nn.ssm.ssd_scan_ref` through
the mixer's `scan_impl` hook, as `repro.kernels.ssd_scan.ops.ssd_scan`
is for the JAX package.

A CUDA tensor launches the kernel in `repro_torch/csrc/ssd_scan.cu` or
raises; a CPU tensor takes the plain version (`ref.ssd_scan_plain`), and
only because it lies on the CPU; a meta tensor (a dry run) takes the
kernel's path up to the launch, and gets its outputs, empty. `launches`
counts scans launched (each is four CUDA kernels: C.B^T per group, the
chunk states, the pass across chunks and the outputs), so a run can show
that its mixers went through the kernel. A launch and a meta call report
the scan's work (`cost`) to an open `launch.hlo_costs` counter.

The gradient: the JAX package has no backward kernel for the scan (its
training gradient is autodiff of `repro.nn.ssm.ssd_scan_ref`). Here
`SSDScan`, a `torch.autograd.Function`, runs the kernel forward, saves
its inputs, and back-propagates through a recomputation of the port's
`nn.ssm.ssd_scan_ref`. Its forward is a parameter, so a CPU test runs
the same Function with the plain forward in place of the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain
from repro_torch.launch import hlo_costs

# Scans launched since import (or since a caller reset it to 0).
launches = 0

# What the kernel takes: a chunk of at most MAX_CHUNK tokens (the wrapper
# rounds it up to a multiple of CHUNK_STEP, the height of its mma tiles:
# the chunk does not change the result), d_state n a multiple of 4 (16
# bytes of float32), head_dim p = 32 or a multiple of 64 (one p tile of
# 32 or 64 columns a block).
MAX_CHUNK, CHUNK_STEP, P_TILE = 128, 16, 64


# The C entry point's parameters: x, dt, A, B, C, y, state, the scratch
# cb, states and tot, stream; b, s, h, p, g, n, chunk, bf16; the strides
# of x, dt, B and C over (batch, sequence, head or group).
ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 12)


@functools.cache
def _kernel():
    fn = load_library("ssd_scan", ("ssd_scan.cu",)).ssd_scan
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def build():
    """Compile (if needed) and load the kernel library."""
    _kernel()


def _check(x, dt, A, B, C, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError("ssd_scan takes x (b, s, h, p), dt (b, s, h), "
                         "A (h,), B and C (b, s, g, n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, g, n) or C.shape != B.shape):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x, not "
                         f"{x.dtype}")
    devices = {t.device for t in (x, dt, A, B, C)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if min(b, s, h, p, g, n) < 1 or chunk < 1:
        raise ValueError("empty input")
    return b, s, h, p, g, n


def cost(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int, *,
         x_itemsize: int = 4, bc_itemsize: int = 4,
         final_state: bool = False):
    """(flops, bytes) of one scan, PERF.md section 6's formulas (row 5)
    in general form, at the kernel's chunk (`chunk` after the wrapper's
    rounding). Flops: the least the call needs: for every chunk the
    causal triangle of C.B^T once a group and of the score-times-x
    product a head; a head's C.state for every chunk but the first (its
    state is zero) and its state update for every chunk but the last,
    whose state only the final state reads. Bytes: x and y (x's dtype),
    dt and A (float32), B and C (`bc_itemsize`) once each, and the final
    state (float32) when asked."""
    n_chunks = -(-s // chunk)
    tri = chunk * (chunk + 1) // 2
    updates = n_chunks if final_state else n_chunks - 1
    flops = b * (n_chunks * (2 * tri * n * g + h * 2 * tri * p)
                 + h * 2 * chunk * n * p * ((n_chunks - 1) + updates))
    n_bytes = (2 * x_itemsize * b * s * h * p + 4 * (b * s * h + h)
               + 2 * bc_itemsize * b * s * g * n
               + (4 * b * h * n * p if final_state else 0))
    return flops, n_bytes


def _aligned(t):
    """`t` when the kernel can copy its rows in 16-byte pieces (unit
    stride in the last dimension, a 16-byte aligned start and strides of
    whole 16 bytes), else a contiguous copy."""
    step = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % step == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_forward(x, dt, A, B, C, chunk, return_final_state):
    """Launch the kernel: y (b, s, h, p) in x's dtype and, when asked,
    the final state (b, h, n, p) float32. On meta tensors the same
    outputs (and scratch), empty, and no launch."""
    global launches
    b, s, h, p, g, n = _check(x, dt, A, B, C, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the ssd_scan kernel runs on CUDA tensors, not "
                         f"{x.device}")
    # no longer than the padded sequence, a whole number of mma rows
    chunk = min(chunk, s + (-s) % CHUNK_STEP)
    chunk += (-chunk) % CHUNK_STEP
    if chunk > MAX_CHUNK or n % 4 or not (p == 32 or p % P_TILE == 0):
        raise ValueError(f"the ssd_scan kernel takes chunk <= {MAX_CHUNK}, "
                         f"n % 4 == 0, and p == 32 or p % {P_TILE} == 0; "
                         f"got chunk={chunk}, n={n}, p={p}")
    # The kernel reads x, B and C through their strides, so the mixer's
    # slices of one projection need no copy; dt, A, B and C are read as
    # float32.
    x = _aligned(x)
    dt, A = dt.float(), A.float().contiguous()
    B, C = (_aligned(t.float()) for t in (B, C))
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
             if return_final_state else None)
    # scratch: C.B^T per (batch, chunk, group); the chunk states and the
    # chunks' decay totals (the last chunk's only with a final state)
    n_chunks = -(-s // chunk)
    n_states = n_chunks if return_final_state else n_chunks - 1
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((b, n_chunks, g, chunk, chunk), **f32)
    states = torch.empty((b, h, n_states, n, p), **f32)
    tot = torch.empty((b, h, n_states), **f32)
    work = cost(b, s, h, p, g, n, chunk, x_itemsize=x.element_size(),
                bc_itemsize=B.element_size(),
                final_state=return_final_state)
    if x.device.type == "meta":
        hlo_costs.record_kernel("ssd_scan", *work)
        return y, state
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None, cb.data_ptr(),
            states.data_ptr(), tot.data_ptr(), stream,
            b, s, h, p, g, n, chunk, int(x.dtype == torch.bfloat16),
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3])
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    hlo_costs.record_kernel("ssd_scan", *work)
    return y, state


def _plain_forward(x, dt, A, B, C, chunk, return_final_state):
    _check(x, dt, A, B, C, chunk)
    with hlo_costs.plain_call("ssd_scan"):
        y, state = ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                  return_final_state=True)
    return y, (state if return_final_state else None)


class SSDScan(torch.autograd.Function):
    """forward(fwd, x, dt, A, B, C, chunk, return_final_state): `fwd`
    computes (y, final state or None); the backward recomputes
    `nn.ssm.ssd_scan_ref` on the saved inputs and back-propagates
    through it."""

    @staticmethod
    def forward(ctx, fwd, x, dt, A, B, C, chunk, return_final_state):
        y, state = fwd(x, dt, A, B, C, chunk, return_final_state)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk, ctx.return_final_state = chunk, return_final_state
        return (y, state) if return_final_state else y

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.nn.ssm import ssd_scan_ref
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        # a named range, so a profile can attribute the backward's device
        # time
        with (torch.profiler.record_function("SSDScan.backward"),
              torch.enable_grad()):
            out = ssd_scan_ref(*inputs, chunk=ctx.chunk,
                               return_final_state=ctx.return_final_state)
            outs = out if ctx.return_final_state else (out,)
            need = [t for t, want in zip(inputs, ctx.needs_input_grad[1:6])
                    if want]
            got = iter(torch.autograd.grad(outs, need, grads)
                       if need else ())
        return (None, *(next(got) if want else None
                        for want in ctx.needs_input_grad[1:6]), None, None)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, initial_state=None,
             return_final_state: bool = False):
    """Drop-in for `nn.ssm.ssd_scan_ref`: x (b, s, h, p); dt (b, s, h);
    A (h,); B, C (b, s, g, n). The scan starts from a zero state
    (`initial_state` is not supported, as in the JAX kernel); a sequence
    that is not a multiple of `chunk` runs as if padded with dt = 0
    steps, which leave the state unchanged."""
    if initial_state is not None:
        raise ValueError("the ssd_scan kernel starts from a zero state")
    if x.device.type == "cpu":
        fwd = _plain_forward
    elif x.device.type in ("cuda", "meta"):
        fwd = _kernel_forward
    else:
        raise ValueError(f"ssd_scan runs on CUDA, CPU or meta tensors, not "
                         f"{x.device}")
    return SSDScan.apply(fwd, x, dt, A, B, C, chunk, return_final_state)


__all__ = ["ssd_scan", "SSDScan", "ssd_scan_plain", "build", "cost"]
