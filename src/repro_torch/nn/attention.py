"""Grouped-query attention with RoPE, qk-norm, sliding windows,
cross-attention and KV caches (port of `repro.nn.attention`).

The dispatch is the JAX package's: without a cache or an extra mask,
when s * t reaches _FLASH_THRESHOLD, the blockwise flash path runs (on
a CUDA tensor the Hopper kernel of `repro_torch.kernels.flash_attn`, on
a CPU tensor its plain version); otherwise the naive softmax over the
full (s, t) scores. The flash kernel takes s queries at positions
0..s-1 against t keys at 0..t-1: it takes every flash-sized call whose
mask does not depend on positions (bidirectional: the encoder's
self-attention and cross-attention, with `kv_x`, `kv_override` or
explicit positions), and causal or windowed self-attention at the
default positions. A causal or windowed flash-sized call with explicit
positions, `kv_x` or `kv_override` raises.

Caches are updated in place where the JAX package returns a new
(donated) cache, and a write that JAX drops (`mode="drop"`: a masked
token, a paged write into the null block, an index past the cache)
leaves every leaf bit for bit unchanged, with no data-dependent shape,
so a serving step can be captured in a CUDA graph (`_write_rows`).

`fuse_qkv` (leaf `wqkv`, bias `bqkv`) projects q, k and v with one
matmul, [q | k | v] on the output dim. `flash_repeat_kv` repeats k and v
to all H heads before the flash path, so the kernel runs with KV = H
(the JAX package's head-shardable layout); without it the kernel takes
the unrepeated KV heads. Attention replicates under tensor parallelism,
as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.nn import initializers
from repro_torch.nn.flash_ref import NEG_INF
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rope import apply_rope

# from this (s_q * s_k) product on, attention goes through the blockwise
# flash path (the naive path materialises b*h*s*t float32 scores)
_FLASH_THRESHOLD = 512 * 512 + 1


def attention_init(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: Optional[int] = None, *,
                   qk_norm: bool = False, use_bias: bool = False,
                   fuse_qkv: bool = False):
    if head_dim is None:
        head_dim = d_model // n_heads
    if n_heads % n_kv_heads:
        raise ValueError("GQA requires n_heads % n_kv_heads == 0")
    device = generator.device
    if fuse_qkv:
        # one fused projection: one matmul forward, one dx all-reduce
        # backward under tensor parallelism
        width = (n_heads + 2 * n_kv_heads) * head_dim
        params = {
            "wqkv": initializers.lecun_normal(generator, (d_model, width)),
            "wo": initializers.lecun_normal(generator,
                                            (n_heads * head_dim, d_model),
                                            fan_in=n_heads * head_dim),
        }
        if use_bias:
            params["bqkv"] = torch.zeros(width, device=device)
            params["bo"] = torch.zeros(d_model, device=device)
        if qk_norm:
            params["q_norm"] = rmsnorm_init(head_dim, device=device)
            params["k_norm"] = rmsnorm_init(head_dim, device=device)
        return params
    params = {
        "wq": initializers.lecun_normal(generator,
                                        (d_model, n_heads * head_dim)),
        "wk": initializers.lecun_normal(generator,
                                        (d_model, n_kv_heads * head_dim)),
        "wv": initializers.lecun_normal(generator,
                                        (d_model, n_kv_heads * head_dim)),
        "wo": initializers.lecun_normal(generator,
                                        (n_heads * head_dim, d_model),
                                        fan_in=n_heads * head_dim),
    }
    if use_bias:
        for name, width in (("bq", n_heads * head_dim),
                            ("bk", n_kv_heads * head_dim),
                            ("bv", n_kv_heads * head_dim), ("bo", d_model)):
            params[name] = torch.zeros(width, device=device)
    if qk_norm:
        params["q_norm"] = rmsnorm_init(head_dim, device=device)
        params["k_norm"] = rmsnorm_init(head_dim, device=device)
    return params


def _project(params, name, x, n_heads, head_dim):
    y = x @ params[f"w{name}"].to(x.dtype)
    bias = params.get(f"b{name}")
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.reshape(x.shape[:-1] + (n_heads, head_dim))


def build_mask(q_positions, k_positions, *, causal: bool,
               window: Optional[int], k_valid=None):
    """Additive float32 bias (..., q, k): 0 where query position i may
    see key position j (j <= i if causal; j > i - window if windowed;
    k_valid[..., j] if given: populated cache slots), NEG_INF
    elsewhere."""
    qp = q_positions[..., :, None]
    kp = k_positions[..., None, :]
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    if k_valid is not None:
        allowed &= k_valid[..., None, :]
    return torch.where(allowed, 0.0, NEG_INF).float()


def attention_kv(params, kv_x, *, n_kv_heads: int, qk_norm: bool = False):
    """Project cross-attention keys and values once (no RoPE), as the
    cross prefill path does: {"k", "v"} (b, t, kv, hd)."""
    head_dim = params["wk"].shape[1] // n_kv_heads
    k = _project(params, "k", kv_x, n_kv_heads, head_dim)
    v = _project(params, "v", kv_x, n_kv_heads, head_dim)
    if qk_norm:
        k = rmsnorm_apply(params["k_norm"], k)
    return {"k": k, "v": v}


def _dedup_ring_slots(slots, positions, mask):
    """Last-write-wins for scatter inserts into a ring buffer: when two
    tokens of one chunk map to the same ring slot (a chunk longer than
    the window), keep only the latest position per slot."""
    later_same = ((slots[:, :, None] == slots[:, None, :])
                  & mask[:, None, :]
                  & (positions[:, None, :] > positions[:, :, None]))
    return mask & ~later_same.any(dim=-1)


def _write_rows(leaves, rows, values, mask, positions):
    """Scatter into flat leaves in place: row `rows[j]` of every leaf
    (R, ...) takes `values[..][j]` where mask[j]; a row that several
    tokens write takes the token of the latest position (then the
    latest index); a row that no unmasked token writes keeps its bits.

    rows: (N,) in [0, R). Each of the N writes puts the row's final
    value, so duplicate indices write equal values and the in-place
    `index_put_` is deterministic, and a dropped write costs a write of
    the old bits instead of a data-dependent shape."""
    n = rows.shape[0]
    order = positions.long() * n + torch.arange(n, device=rows.device)
    same = (rows[:, None] == rows[None, :]) & mask[None, :]
    winner = torch.where(same, order[None, :], -1).argmax(dim=1)
    has = same.any(dim=1)
    for leaf, val in zip(leaves, values):
        take = has.reshape((n,) + (1,) * (leaf.dim() - 1))
        new = torch.where(take, val[winner].to(leaf.dtype), leaf[rows])
        leaf.index_put_((rows,), new)


def attention_apply(params, x, *, n_heads: int, n_kv_heads: int,
                    inv_freq=None, q_positions=None, kv_positions=None,
                    causal: bool = True, window: Optional[int] = None,
                    kv_x=None, cache=None, cache_index=None,
                    cache_write_mask=None, paged_table=None,
                    qk_norm: bool = False, extra_mask=None,
                    return_kv: bool = False, kv_override=None,
                    flash_repeat_kv: bool = False):
    """Attention forward. x: (b, s, d) queries source.

    kv_x: optional (b, t, d) keys/values source (cross attention);
        defaults to x.
    q_positions, kv_positions: (b, s) / (b, t) absolute positions;
        default 0..s-1 (0..t-1 for kv_x and kv_override).
    kv_override: pre-projected {"k", "v"[, "pos"]} (cross-attention
        decode); the k/v projections are skipped.
    cache: {"k": (b, L, kv, hd), "v": ..., "pos": (b, L) int32,
        "valid": (b, L) bool}, updated in place:
      * with `cache_index` (an int or 0-d tensor): all rows insert at
        that slot (mod L with a window), and attention runs over the
        whole cache;
      * without it: each token inserts at its absolute position (mod L
        with a window); `cache_write_mask` (b, s) drops writes. A chunk
        longer than a window attends over the pre-write ring plus the
        fresh chunk, since its writes evict keys its earlier queries
        still need;
      * with `paged_table` (b, max_blocks): the leaves are a shared block
        pool {"k": (n_blocks, bs, kv, hd), ..., "pos"/"valid":
        (n_blocks, bs)}, positions map through the slot's block table
        into pool rows, and attention runs over the table-gathered
        per-slot view. Block 0 is the null block: never written.
    extra_mask: additive float32 bias (b, s, t).
    Returns y (b, s, d); (y, cache) with a cache; (y, {"k", "v"}) with
    return_kv."""
    b, s, _ = x.shape
    fused_proj = "wqkv" in params
    head_dim = (params["wqkv"].shape[1] // (n_heads + 2 * n_kv_heads)
                if fused_proj else params["wq"].shape[1] // n_heads)
    kv_src = x if kv_x is None else kv_x
    explicit_positions = q_positions is not None or kv_positions is not None

    if fused_proj:
        if kv_x is not None:
            raise ValueError("the fused qkv projection is self-attention "
                             "only (kv_x given)")
        fused = x @ params["wqkv"].to(x.dtype)
        if "bqkv" in params:
            fused = fused + params["bqkv"].to(x.dtype)
        nq, nkv = n_heads * head_dim, n_kv_heads * head_dim
        q = fused[..., :nq].reshape(x.shape[:-1] + (n_heads, head_dim))
        k = fused[..., nq:nq + nkv].reshape(
            x.shape[:-1] + (n_kv_heads, head_dim))
        v = fused[..., nq + nkv:].reshape(
            x.shape[:-1] + (n_kv_heads, head_dim))
    else:
        q = _project(params, "q", x, n_heads, head_dim)
    if kv_override is not None:
        # pre-projected keys/values (cross-attention decode)
        k = kv_override["k"].to(x.dtype)
        v = kv_override["v"].to(x.dtype)
        if kv_positions is None and "pos" in kv_override:
            kv_positions = kv_override["pos"]
    elif not fused_proj:
        k = _project(params, "k", kv_src, n_kv_heads, head_dim)
        v = _project(params, "v", kv_src, n_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm_apply(params["q_norm"], q)
        if kv_override is None:
            k = rmsnorm_apply(params["k_norm"], k)

    if q_positions is None:
        q_positions = torch.arange(s, device=x.device).expand(b, s)
    if kv_positions is None:
        if kv_override is None and kv_x is None:
            kv_positions = q_positions
        else:
            t = k.shape[1]
            kv_positions = torch.arange(t, device=x.device).expand(b, t)

    if inv_freq is not None:
        q = apply_rope(q, q_positions, inv_freq)
        if kv_override is None:     # an override carries its rotation
            k = apply_rope(k, kv_positions, inv_freq)

    k_valid = None
    if cache is not None and paged_table is not None:
        n_blocks, blk = cache["k"].shape[0], cache["k"].shape[1]
        table = paged_table.long()
        pos = kv_positions.long()
        blk_idx = torch.clamp(pos // blk, 0, table.shape[1] - 1)
        block_ids = torch.gather(table, 1, blk_idx)              # (b, s)
        rows = torch.clamp(block_ids * blk + pos % blk, 0,
                           n_blocks * blk - 1)
        mask = (torch.ones((b, s), dtype=torch.bool, device=x.device)
                if cache_write_mask is None else cache_write_mask)
        mask = mask & (block_ids > 0)     # block 0 is never written
        flat = [cache[name].view((n_blocks * blk,) + cache[name].shape[2:])
                for name in ("k", "v", "pos", "valid")]
        _write_rows(flat, rows.reshape(-1),
                    [k.reshape((b * s,) + k.shape[2:]),
                     v.reshape((b * s,) + v.shape[2:]), pos.reshape(-1),
                     torch.ones(b * s, dtype=torch.bool, device=x.device)],
                    mask.reshape(-1), pos.reshape(-1))
        # the gathered per-slot view (b, max_blocks * bs, ...)
        view = table.shape[1] * blk
        k = cache["k"][table].reshape((b, view) + cache["k"].shape[2:])
        v = cache["v"][table].reshape((b, view) + cache["v"].shape[2:])
        k, v = k.to(q.dtype), v.to(q.dtype)
        kv_positions = cache["pos"][table].reshape(b, view)
        k_valid = cache["valid"][table].reshape(b, view)
    elif cache is not None and cache_index is None:
        L = cache["k"].shape[1]
        pos = kv_positions.long()
        slots = pos % L if window is not None else pos
        wmask = (torch.ones((b, s), dtype=torch.bool, device=x.device)
                 if cache_write_mask is None else cache_write_mask)
        mask = wmask
        if window is not None and s > 1:
            mask = _dedup_ring_slots(slots, pos, mask)
            # the ring eviction hazard: attend over the PRE-write ring
            # plus the fresh chunk (torch.cat copies before the writes)
            k_att = torch.cat([cache["k"].to(q.dtype), k.to(q.dtype)], 1)
            v_att = torch.cat([cache["v"].to(q.dtype), v.to(q.dtype)], 1)
            pos_att = torch.cat([cache["pos"].long(), pos], dim=1)
            valid_att = torch.cat([cache["valid"], wmask], dim=1)
        mask = mask & (slots >= 0) & (slots < L)
        rows = (torch.arange(b, device=x.device)[:, None] * L
                + torch.clamp(slots, 0, L - 1))
        flat = [cache[name].view((b * L,) + cache[name].shape[2:])
                for name in ("k", "v", "pos", "valid")]
        _write_rows(flat, rows.reshape(-1),
                    [k.reshape((b * s,) + k.shape[2:]),
                     v.reshape((b * s,) + v.shape[2:]), pos.reshape(-1),
                     torch.ones(b * s, dtype=torch.bool, device=x.device)],
                    mask.reshape(-1), pos.reshape(-1))
        if window is not None and s > 1:
            k, v, kv_positions, k_valid = k_att, v_att, pos_att, valid_att
        else:
            k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
            kv_positions, k_valid = cache["pos"], cache["valid"]
    elif cache is not None:
        # the scalar-index insert: every row at one slot (a ring slot
        # with a window), clamped into the cache as
        # lax.dynamic_update_slice clamps
        L = cache["k"].shape[1]
        slot = int(cache_index)
        if window is not None:
            slot %= L
        start = min(max(slot, 0), L - s)
        cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
        cache["pos"][:, start:start + s] = kv_positions.to(
            cache["pos"].dtype)
        cache["valid"][:, start:start + s] = True
        k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        kv_positions, k_valid = cache["pos"], cache["valid"]

    group = n_heads // n_kv_heads
    t = k.shape[1]
    scale = head_dim ** -0.5
    if extra_mask is None and cache is None and s * t >= _FLASH_THRESHOLD:
        if (causal or window is not None) and (
                explicit_positions or kv_x is not None
                or kv_override is not None):
            raise NotImplementedError(
                "the flash path's causal and window masks take query i and "
                "key j at positions i and j; a causal or windowed call with "
                "explicit positions, kv_x or kv_override runs below the "
                "flash threshold")
        if flash_repeat_kv and group > 1:
            # k/v repeated to all H heads: the kernel runs with KV = H
            ctx = flash_ops.flash_attention(
                q, k.repeat_interleave(group, dim=2),
                v.repeat_interleave(group, dim=2), causal=causal,
                window=window)
        else:
            # (b, s, H, hd) queries against the unrepeated (b, t, KV, hd)
            ctx = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window)
    else:
        mask = build_mask(q_positions, kv_positions, causal=causal,
                          window=window, k_valid=k_valid)      # (b, s, t)
        if extra_mask is not None:
            mask = mask + extra_mask
        qg = q.reshape(b, s, n_kv_heads, group, head_dim)
        logits = torch.einsum("bsngh,btnh->bnsgt", qg.float(),
                              k.float()) * scale
        logits = logits + mask[:, None, :, None, :]
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bnsgt,btnh->bsngh", probs, v.float())
    ctx = ctx.reshape(b, s, n_heads * head_dim).to(x.dtype)

    y = ctx @ params["wo"].to(x.dtype)
    if "bo" in params:
        y = y + params["bo"].to(x.dtype)
    if cache is not None:
        return y, cache
    if return_kv:
        return y, {"k": k, "v": v}
    return y
