"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060] (port of
`repro.nn.ssm`): training, prefill and decode.

`ssd_scan_ref` is the plain chunked scan: the mixer's scan on a CPU
tensor, the recomputation that gives the ssd_scan kernel its gradient
(`repro_torch.kernels.ssd_scan.ops`), and, as in the JAX package, the
scan of every state-carrying serving chunk. On a CUDA tensor the
training and prefill scan is that kernel.

One deliberate difference from the JAX package: `repro.nn.ssm.
ssd_scan_ref` takes `exp(seg)` over the whole (l, l) block and zeroes
the upper triangle afterwards. There `seg = cs_i - cs_l > 0` can pass
88.7 at chunk 128 (dt 0.05, A -16 reach it), `exp` overflows to inf and
autodiff gives 0 * inf = NaN in the dt- and A-gradients. Here `seg` is
set to -inf above the diagonal BEFORE `exp`: the forward values are the
same and the gradient stays finite.

Layout conventions (as in the JAX package):
  x   (b, s, h, p)   per-head inputs, p = head_dim
  dt  (b, s, h)      softplus-processed step sizes
  A   (h,)           negative per-head decay rates
  B,C (b, s, g, n)   per-group input/output projections, n = d_state
  state (b, h, n, p)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init


# ---------------------------------------------------------------------------
# Chunked SSD scan (plain)
# ---------------------------------------------------------------------------

def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 128, initial_state=None,
                 return_final_state: bool = False):
    """Chunked SSD scan: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t, from `initial_state` (b, h, n, p) or zeros. All math
    in float32; y takes x's dtype.

    Group j of B and C serves heads [j*h/g, (j+1)*h/g), as the JAX
    package's repeat does, here by a reshape of the heads into
    (g, h/g) instead of a copy."""
    in_dtype = x.dtype
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    r = h // g
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    A = A.float()

    chunk = min(chunk, s)
    orig_s = s
    if s % chunk:
        # pad with dt=0 steps: decay exp(0)=1, no input — state unchanged
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // chunk
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None, None]

    if initial_state is None:
        state = torch.zeros((b, g, r, n, p), dtype=torch.float32,
                            device=x.device)
    else:
        state = initial_state.float().reshape(b, g, r, n, p)

    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xk = x[:, sl].reshape(b, chunk, g, r, p)
        dtk = dt[:, sl]                                       # (b, l, h)
        Bk, Ck = B[:, sl], C[:, sl]                           # (b, l, g, n)
        xdt = xk * dtk.reshape(b, chunk, g, r)[..., None]     # (b, l, g, r, p)
        cs = torch.cumsum(dtk * A, dim=1).reshape(b, chunk, g, r)
        seg = cs[:, :, None] - cs[:, None, :]                 # (b, l, s, g, r)
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        scores = torch.einsum("blgn,bsgn->blsg", Ck, Bk)      # (b, l, s, g)
        y_diag = torch.einsum("blsgr,bsgrp->blgrp",
                              scores[..., None] * decay, xdt)
        # carried-state contribution
        y_off = torch.einsum("blgn,bgrnp->blgrp", Ck,
                             state) * torch.exp(cs)[..., None]
        # state update
        decay_states = torch.exp(cs[:, -1:] - cs)            # (b, l, g, r)
        total = torch.exp(cs[:, -1])                         # (b, g, r)
        state = (total[..., None, None] * state
                 + torch.einsum("bsgn,bsgrp->bgrnp", Bk,
                                decay_states[..., None] * xdt))
        ys.append((y_diag + y_off).reshape(b, chunk, h, p))
    y = torch.cat(ys, dim=1)[:, :orig_s].to(in_dtype)
    if return_final_state:
        return y, state.reshape(b, h, n, p)
    return y


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrent update. x: (b, h, p); dt: (b, h); B, C:
    (b, g, n); state: (b, h, n, p). Returns (y in x's dtype, new state
    float32)."""
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    Bh = B.float().repeat_interleave(h // g, dim=1)         # (b, h, n)
    Ch = C.float().repeat_interleave(h // g, dim=1)
    dt = dt.float()
    decay = torch.exp(dt * A.float())                       # (b, h)
    xdt = x.float() * dt[..., None]
    new_state = (decay[..., None, None] * state.float()
                 + torch.einsum("bhn,bhp->bhnp", Bh, xdt))
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


def default_scan(device: torch.device):
    """The mixer's scan on `device`: the ssd_scan kernel on CUDA (and on
    the meta device, where a dry run stands in for the card), the plain
    chunked scan on the CPU."""
    if device.type in ("cuda", "meta"):
        from repro_torch.kernels.ssd_scan import ops
        return ops.ssd_scan
    if device.type == "cpu":
        return ssd_scan_ref
    raise ValueError(f"the SSD scan runs on CUDA, CPU or meta tensors, not "
                     f"{device}")


# ---------------------------------------------------------------------------
# Full Mamba-2 mixer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def ssd_mixer_init(generator: torch.Generator, d_model: int, *, d_state: int,
                   head_dim: int = 64, expand: int = 2, n_groups: int = 1,
                   d_conv: int = 4):
    d_inner = expand * d_model
    if d_inner % head_dim:
        raise ValueError(f"d_inner {d_inner} is not a multiple of "
                         f"head_dim {head_dim}")
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    device = generator.device
    in_proj = initializers.lecun_normal(generator, (d_model, d_in_proj))
    conv_w = initializers.lecun_normal(generator, (d_conv, conv_dim),
                                       fan_in=d_conv)
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    u = torch.rand((n_heads,), generator=generator, device=device)
    dt0 = torch.exp(lo.to(device) + (hi - lo).to(device) * u)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_dim, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=device)),
        "D": torch.ones(n_heads, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm": rmsnorm_init(d_inner, device=device),
        "out_proj": initializers.lecun_normal(generator, (d_inner, d_model),
                                              fan_in=d_inner),
    }


def _causal_conv(seq, w, b):
    """Depthwise causal conv. seq: (b, s, c); w: (k, c)."""
    k = w.shape[0]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + seq.shape[1], :] * w[i].to(seq.dtype)
              for i in range(k))
    return out + b.to(seq.dtype)


def ssd_mixer_apply(params, x, *, d_state: int, head_dim: int = 64,
                    expand: int = 2, n_groups: int = 1, chunk: int = 128,
                    state=None, token_mask=None, scan_impl=None,
                    return_state: bool = False):
    """Mamba-2 mixer. x: (b, s, d) -> (b, s, d).

    state: None for training and prefill from scratch. For decode pass
    {"ssm": (b, h, n, p), "conv": (b, k-1, conv_dim)}; s = 1 is the
    single-token step, s > 1 a state-carrying chunk (chunked prefill),
    which always runs the plain scan, as in the JAX package.
    token_mask: optional (b, s) bool; masked tokens are exact state
    no-ops (dt set to 0, so the decay is exp(0) = 1 with no input, and
    the conv window advances only past valid tokens, which must be a
    prefix of the chunk).
    return_state: prefill; also return the decode state (the scan's
    final state and the conv tail), which needs s >= k - 1.
    Returns y, or (y, new state) when `state` or `return_state` is given.
    scan_impl: optional override of the training and prefill scan (same
    signature as `ssd_scan_ref`); by default the ssd_scan kernel on a
    CUDA tensor and `ssd_scan_ref` on a CPU tensor."""
    b, s, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    gn = n_groups * d_state
    kw = params["conv_w"].shape[0]
    if state is None and return_state and s < kw - 1:
        # the JAX package's tail conv_in[:, s - (k - 1):] starts before
        # the sequence here and comes out shorter than the cache's rows
        raise ValueError(f"a prefill that returns the decode state needs "
                         f"at least d_conv - 1 = {kw - 1} tokens, not {s}")

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xr, B, C, dt_raw = torch.split(
        zxbcdt, [d_inner, d_inner, gn, gn, n_heads], dim=-1)
    conv_in = torch.cat([xr, B, C], dim=-1)              # (b, s, conv_dim)
    if state is not None:
        window = torch.cat([state["conv"].to(conv_in.dtype), conv_in], dim=1)
        if token_mask is None:
            # the carry is the last k-1 rows: every token advances it
            new_conv = window[:, s:]
        else:
            # valid tokens sit at window rows [k-1, k-1+n_valid), so the
            # carry is rows [n_valid, n_valid+k-1); n_valid = 0 gives the
            # old carry bit for bit (an inactive decode slot)
            n_valid = token_mask.to(torch.int64).sum(dim=1)
            idx = n_valid[:, None] + torch.arange(kw - 1, device=x.device)
            new_conv = torch.gather(
                window, 1, idx[:, :, None].expand(-1, -1, window.shape[2]))
        # the causal conv continued across the carried window
        conv_out = sum(window[:, i:i + s] * params["conv_w"][i].to(x.dtype)
                       for i in range(kw)) + params["conv_b"].to(x.dtype)
    else:
        conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    conv_out = F.silu(conv_out)
    xr, B, C = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    xh = xr.reshape(b, s, n_heads, head_dim)
    Bh = B.reshape(b, s, n_groups, d_state)
    Ch = C.reshape(b, s, n_groups, d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    if token_mask is not None:
        dt = dt * token_mask.to(dt.dtype)[:, :, None]
    A = -torch.exp(params["A_log"].float())

    new_state = None
    if state is not None and s == 1:
        y1, new_ssm = ssd_decode_step(state["ssm"], xh[:, 0], dt[:, 0], A,
                                      Bh[:, 0], Ch[:, 0])
        y = y1[:, None]
        new_state = {"ssm": new_ssm, "conv": new_conv}
    elif state is not None:
        y, new_ssm = ssd_scan_ref(xh, dt, A, Bh, Ch, chunk=chunk,
                                  initial_state=state["ssm"],
                                  return_final_state=True)
        new_state = {"ssm": new_ssm, "conv": new_conv}
    else:
        scan = scan_impl if scan_impl is not None else default_scan(x.device)
        if return_state:
            y, final_ssm = scan(xh, dt, A, Bh, Ch, chunk=chunk,
                                return_final_state=True)
            new_state = {"ssm": final_ssm, "conv": conv_in[:, s - (kw - 1):]}
        else:
            y = scan(xh, dt, A, Bh, Ch, chunk=chunk)

    y = y.float() + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_inner)
    y = rmsnorm_apply(params["norm"], y.to(x.dtype) * F.silu(z))
    y = y @ params["out_proj"].to(y.dtype)
    if state is not None or return_state:
        return y, new_state
    return y
