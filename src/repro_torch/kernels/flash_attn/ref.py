"""Plain PyTorch version of the flash_attn kernel, in the kernel's
layout: the oracle the kernel is held to, built on
`repro_torch.nn.flash_ref` (the port of the JAX package's
`flash_attention_ref`, the oracle of `flash_attention_pallas`).

q (b, s, H, D); k, v (b, t, KV, D), query i at position i and key j at
position j, kv head h // (H / KV) serving query head h. The group is folded into the
query-length axis, (b, KV, g*s, D), as the JAX package's attention does,
so k and v are not repeated (this plain version may copy q; the kernel
does not).
"""
import torch

from repro_torch.nn.flash_ref import flash_forward


def fold_queries(t, n_kv_heads):
    """(b, s, H, D) -> (b, KV, g*s, D): row j*s + i of kv head n is query
    i of head n*g + j."""
    b, s, h, d = t.shape
    g = h // n_kv_heads
    return (t.reshape(b, s, n_kv_heads, g, d).permute(0, 2, 3, 1, 4)
            .reshape(b, n_kv_heads, g * s, d))


def unfold_queries(t, s):
    """The inverse of `fold_queries`."""
    b, kv, gs, d = t.shape
    g = gs // s
    return (t.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)
            .reshape(b, s, kv * g, d))


def folded_positions(s, t, g, device):
    """Query positions of the folded rows (0..s-1, g times) and the t
    key positions."""
    return (torch.arange(s, device=device).repeat(g),
            torch.arange(t, device=device))


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """(out (b, s, H, D) float32, lse (b, H, s) float32), all math in
    float32 from the inputs' values, as the kernel computes them."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    q_pos, k_pos = folded_positions(s, t, h // kv, q.device)
    out, lse = flash_forward(
        fold_queries(q.float(), kv), k.float().transpose(1, 2),
        v.float().transpose(1, 2), q_pos, k_pos, d ** -0.5, causal, window)
    return unfold_queries(out, s), lse.reshape(b, h, s)
