"""Plain PyTorch version of the ssd_scan kernel: the oracle the kernel is
held to, twin of `repro.kernels.ssd_scan.ref.ssd_ref`.

A sequential recurrence, one step per token, in the kernel layout
(BH, S, ...) with a = dt * A already folded:

    state_t = exp(a_t) state_{t-1} + B_t (x_t dt_t)^T,   y_t = C_t state_t
"""
import torch


def ssd_ref(x, dt, a, B, C):
    """x (BH, S, P); dt, a (BH, S); B, C (BH, S, N) -> (y (BH, S, P) in
    x's dtype, final state (BH, N, P) float32). All math in float32."""
    bh, s, p = x.shape
    n = B.shape[-1]
    xf, dtf, af, Bf, Cf = (t.float() for t in (x, dt, a, B, C))
    state = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        outer = Bf[:, t, :, None] * (xf[:, t] * dtf[:, t, None])[:, None, :]
        state = torch.exp(af[:, t])[:, None, None] * state + outer
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def to_kernel_layout(x, dt, A, B, C):
    """Mixer layout -> the kernel layout of `ssd_ref`: x (b, s, h, p),
    dt (b, s, h), A (h,), B/C (b, s, g, n) -> x (b*h, s, p), dt and
    a = dt * A (b*h, s), B/C (b*h, s, n) with group h // (H/G) of each
    head repeated (this plain version may copy; the kernel does not)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    xk = x.permute(0, 2, 1, 3).reshape(b * h, s, p)
    dtk = dt.permute(0, 2, 1).reshape(b * h, s)
    ak = dtk.float() * A.float().repeat(b)[:, None]
    Bk, Ck = (t.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              .reshape(b * h, s, t.shape[-1]) for t in (B, C))
    return xk, dtk, ak, Bk, Ck


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128,
                   return_final_state: bool = False):
    """`ssd_ref` behind the mixer-layout signature of the kernel wrapper
    (`ops.ssd_scan`). `chunk` does not change the result: the recurrence
    is per token."""
    del chunk
    b, s, h, p = x.shape
    y, state = ssd_ref(*to_kernel_layout(x, dt, A, B, C))
    y = y.reshape(b, h, s, p).permute(0, 2, 1, 3)
    if return_final_state:
        return y, state.reshape(b, h, *state.shape[1:])
    return y
