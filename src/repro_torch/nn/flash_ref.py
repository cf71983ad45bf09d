"""Memory-efficient (flash) attention in plain PyTorch (port of
`repro.nn.flash_ref`).

The forward scans blocks of keys with an online softmax and returns the
output and the log-sum-exp of every query row; the backward
(FlashAttention-2) rescans the blocks, recomputing each block's scores
from the saved (q, k, v, out, lse). Neither materialises the (s_q, s_k)
score matrix. Exact, not an approximation.

Layout: q (..., sq, d); k, v (..., sk, d). A grouped-query caller folds
the group into the query-length axis, so k and v are never repeated.
Masking is positional: causal and sliding window, computed per block
from integer positions. Keys are padded to a multiple of the 512-key
block with position INT32_MAX and marked invalid, as in the JAX
package. The JAX package's key-validity argument is left out: attention
takes the flash path only without a cache, where no key is invalid.

`repro_torch.kernels.flash_attn` holds the Hopper kernel of the forward;
its autograd Function back-propagates through `flash_backward`.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
INT32_MAX = 2**31 - 1
BLOCK_K = 512   # keys per block, as the JAX package's callers pass


def _block_bias(q_pos, k_pos, causal: bool, window: Optional[int], k_valid):
    """(..., sq, bk) additive float32 bias for one block of keys."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    if k_valid is not None:
        allowed &= k_valid[..., None, :]
    return torch.where(allowed, 0.0, NEG_INF).float()


def _blocks(k, v, k_pos):
    """k, v and k_pos padded to whole blocks (zero keys at position
    INT32_MAX), the validity of each key (None without padding), and
    the block length."""
    sk = k.shape[-2]
    bk = min(BLOCK_K, sk)
    pad = (-sk) % bk
    if not pad:
        return k, v, k_pos, None, bk

    def padded(t, dim, value):
        shape = list(t.shape)
        shape[dim] = pad
        return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                        device=t.device)], dim=dim)

    valid = torch.arange(sk + pad, device=k.device) < sk
    return (padded(k, -2, 0), padded(v, -2, 0),
            padded(k_pos, -1, INT32_MAX), valid, bk)


def flash_forward(q, k, v, q_pos, k_pos, scale: float, causal: bool = True,
                  window: Optional[int] = None):
    """(out in q's dtype, lse float32 (..., sq)), as `_flash_fwd_inner`."""
    k, v, k_pos, valid, bk = _blocks(k, v, k_pos)
    qf = q.float() * scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m_run = torch.full(q.shape[:-1], float("-inf"), device=q.device)
    l_run = torch.zeros(q.shape[:-1], device=q.device)
    for i in range(k.shape[-2] // bk):
        blk = slice(i * bk, (i + 1) * bk)
        s = torch.einsum("...qd,...kd->...qk", qf, k[..., blk, :].float())
        s = s + _block_bias(q_pos, k_pos[..., blk], causal, window,
                            None if valid is None else valid[blk])
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "...qk,...kd->...qd", p, v[..., blk, :].float())
        m_run = m_new
    l_safe = torch.clamp(l_run, min=1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype)
    return out, m_run + torch.log(l_safe)


def flash_backward(q, k, v, q_pos, k_pos, scale: float, out, lse, dout,
                   causal: bool = True, window: Optional[int] = None):
    """(dq, dk, dv) in the dtypes of q, k, v, as `_flash_bwd`: per block
    p = exp(s - lse), dp = dout v^T, ds = p (dp - rowsum(dout * out)),
    dq += ds k scale, dk = ds^T q scale, dv = p^T dout. Padding keys are
    masked here too; `_flash_bwd` leaves them unmasked, which gives the
    same gradients (they are zero keys, and their dk, dv are cut)."""
    sk = k.shape[-2]
    kp, vp, kpos_p, valid, bk = _blocks(k, v, k_pos)
    qf = q.float() * scale
    dof = dout.float()
    delta = torch.sum(dof * out.float(), dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(kp.shape[-2] // bk):
        blk = slice(i * bk, (i + 1) * bk)
        kb, vb = kp[..., blk, :].float(), vp[..., blk, :].float()
        s = torch.einsum("...qd,...kd->...qk", qf, kb)
        s = s + _block_bias(q_pos, kpos_p[..., blk], causal, window,
                            None if valid is None else valid[blk])
        p = torch.exp(s - lse[..., None])                 # exact probs
        dp = torch.einsum("...qd,...kd->...qk", dof, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("...qk,...kd->...qd", ds, kb) * scale
        dks.append(torch.einsum("...qk,...qd->...kd", ds, qf))
        dvs.append(torch.einsum("...qk,...qd->...kd", p, dof))
    dk = torch.cat(dks, dim=-2)[..., :sk, :]
    dv = torch.cat(dvs, dim=-2)[..., :sk, :]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
