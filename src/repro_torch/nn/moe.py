"""Mixture-of-experts feed-forward with top-k routing (port of
`repro.nn.moe`).

The dispatches are the JAX package's, with the same discrete outcome:
which (token, slot) pairs win a place in their expert's buffer, and at
which position, bit for bit.

  einsum  GShard's: tokens in groups of `group_size`; within a group the
          cumulative count over the (slot, token) order (slot-major, so
          first choices win) gives each pair its position in its
          expert's queue, and at most `capacity` pairs an expert stay.
  sort    a stable sort of the pairs by expert, i.e. the count over the
          (token, slot) order, into one fixed buffer an expert; a pair
          past it is dropped.

`moe_apply(dropless=True)` (serving) routes every pair: the sort
dispatch with a buffer of every pair when b * s * top_k is at most
_DROPLESS_EXACT_LIMIT, else the einsum dispatch with a capacity factor
of at least 2.

The JAX package computes the einsum dispatch with one-hot einsums. Each
one-hot sum there has one non-zero term, so the port gathers instead:
the expert buffers from the tokens, and every token's outputs from its
slots, summed over the slots in order. The gathers' backwards are
gathers too (`_Gather`), never an atomic `index_add_` or
`scatter_add_`, so two runs give the same bits; and no step reads a
device value on the host (the positions come from cumulative sums of
one-hots of a fixed width, not from `bincount` or `nonzero`), so an MoE
round or serving step can be captured in a CUDA graph.
"""
from __future__ import annotations

import math

import torch

from repro_torch.nn import initializers
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.tree import tree_stack

# the most b * s * top_k of the exact (worst-case buffer) dropless sort
# dispatch
_DROPLESS_EXACT_LIMIT = 4096


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int):
    """{"router": (d_model, E), "experts": gated MLP leaves stacked on a
    leading (E,) axis}, the JAX package's tree."""
    router = initializers.lecun_normal(generator, (d_model, n_experts))
    return {"router": router,
            "experts": tree_stack([mlp_init(generator, d_model, d_ff,
                                            gated=True)
                                   for _ in range(n_experts)])}


def _one_hot(index, n: int, dtype):
    """One-hot rows of a fixed width `n` (no range check on the host)."""
    return (index[..., None] == torch.arange(n, device=index.device)
            ).to(dtype)


def _route(params, x2d, n_experts: int, top_k: int):
    """Router logits -> (probs (T, E), gates (T, K), expert indices
    (T, K), their one-hots (T, K, E), the Switch load-balance loss).
    The top k by a stable descending sort: of equal probabilities the
    lower expert wins, as with `jax.lax.top_k`."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = ranked[:, :top_k], order[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    chosen = _one_hot(expert_idx, n_experts, torch.float32)
    frac = chosen.sum(1).mean(0)
    aux = n_experts * torch.sum(frac * probs.mean(0))
    return probs, gates, expert_idx, chosen, aux


class _Gather(torch.autograd.Function):
    """out = src[idx], row `len(src)` reading zeros. The backward gathers
    too: row j of the gradient sums the rows of `inv[j]` (at most R
    positions of out that read row j, padded with len(out)), in order."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return torch.cat([src, src.new_zeros(1, src.shape[1])])[idx]

    @staticmethod
    def backward(ctx, dout):
        inv, = ctx.saved_tensors
        # a named range, so a profile can attribute the backward's time
        with torch.profiler.record_function("moe.gather.backward"):
            padded = torch.cat([dout, dout.new_zeros(1, dout.shape[1])])
            return padded[inv].sum(1), None, None


def _experts(params, expert_in):
    """Every expert's gated MLP on its buffer: (E, n, d) -> (E, n, d), a
    batched product over E."""
    return mlp_apply(params, expert_in)


def _run(params, x2d, gates, pair_slot, n_slots: int, n_experts: int):
    """The experts on the buffers that `pair_slot` fills, combined back.

    pair_slot (T, K): each (token, slot) pair's row of the flat
    (E, n_slots / E) buffer, or n_slots where the pair is dropped.
    Returns y2d (T, d): each token's kept slots' outputs times their
    gates, summed over the slots in order."""
    t, k = pair_slot.shape
    flat = pair_slot.reshape(-1)
    pair = torch.arange(t * k, device=x2d.device)
    # the inverse maps: the pair and the token in each buffer row (the
    # kept pairs' rows are distinct; the dropped ones all write the
    # spare last row, which is cut off)
    slot_pair = torch.full((n_slots + 1,), t * k, dtype=torch.long,
                           device=x2d.device).scatter_(0, flat, pair)[:-1]
    slot_token = torch.where(slot_pair < t * k, slot_pair // k, t)
    with torch.profiler.record_function("moe.dispatch"):
        expert_in = _Gather.apply(x2d, slot_token, pair_slot)
    with torch.profiler.record_function("moe.experts"):
        expert_out = _experts(params["experts"], expert_in.view(
            n_experts, n_slots // n_experts, -1)).reshape(n_slots, -1)
    with torch.profiler.record_function("moe.combine"):
        gathered = _Gather.apply(expert_out, flat, slot_pair[:, None])
        y = (gathered.view(t, k, -1) * gates[..., None].to(gathered.dtype)
             ).sum(1)
    return y.to(x2d.dtype)


def _dispatch_einsum(params, x2d, gates, chosen, n_groups: int, gs: int,
                     n_experts: int, top_k: int, capacity: int):
    """GShard's dispatch: within each group of gs tokens, a pair's
    position in its expert's queue is its count over the slot-major
    (slot, token) order; pairs at positions < capacity stay. The buffer
    is (E, n_groups, capacity) as JAX's `expert_in`."""
    counts = chosen.to(torch.int32).view(n_groups, gs, top_k, n_experts)
    flat = counts.transpose(1, 2).reshape(n_groups, top_k * gs, n_experts)
    before = (torch.cumsum(flat, dim=1) - flat).view(
        n_groups, top_k, gs, n_experts).transpose(1, 2)
    pos = (before * counts).sum(-1)                       # (g, t, K)
    expert = chosen.view(n_groups, gs, top_k, n_experts).argmax(-1)
    group = torch.arange(n_groups, device=x2d.device)[:, None, None]
    n_slots = n_experts * n_groups * capacity
    pair_slot = torch.where(
        pos < capacity, (expert * n_groups + group) * capacity + pos,
        n_slots).view(n_groups * gs, top_k)
    return _run(params, x2d, gates, pair_slot, n_slots, n_experts)


def _dispatch_sort(params, x2d, gates, expert_idx, n_experts: int,
                   top_k: int, capacity_total: int):
    """The sort dispatch: the pairs in (token, slot) order, stably sorted
    by expert; each expert's first min(capacity_total, T K) pairs fill
    its buffer in that order, the rest are dropped."""
    t = x2d.shape[0]
    flat_expert = expert_idx.reshape(-1)                  # (T K,)
    one_hot = _one_hot(flat_expert, n_experts, torch.int32)
    before = torch.cumsum(one_hot, dim=0) - one_hot
    pos = before.gather(1, flat_expert[:, None])[:, 0]    # rank in expert
    cap = min(capacity_total, t * top_k)
    n_slots = n_experts * cap
    pair_slot = torch.where(pos < cap, flat_expert * cap + pos,
                            n_slots).view(t, top_k)
    return _run(params, x2d, gates, pair_slot, n_slots, n_experts)


def moe_apply(params, x, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 2048,
              dispatch: str = "einsum", dropless: bool = False):
    """x (b, s, d) -> (y (b, s, d), aux loss (scalar float32)).

    Tokens are padded with zero rows to whole groups of
    min(group_size, b s), and the padded rows route too, as in the JAX
    package; an expert takes max(1, int(gs * capacity_factor * top_k /
    n_experts)) pairs a group, at most gs. dropless=True: see the module
    docstring."""
    if dropless:
        if x.shape[0] * x.shape[1] * top_k <= _DROPLESS_EXACT_LIMIT:
            dispatch = "sort"
        else:
            dispatch = "einsum"
            capacity_factor = max(capacity_factor, 2.0)
            dropless = False
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    t_total = b * s
    gs = min(group_size, t_total)
    n_groups = math.ceil(t_total / gs)
    pad = n_groups * gs - t_total
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros(pad, d)])
    with torch.profiler.record_function("moe.dispatch"):
        probs, gates, expert_idx, chosen, aux = _route(params, x2d,
                                                       n_experts, top_k)
    capacity = max(1, int(gs * capacity_factor * top_k / n_experts))
    capacity = min(capacity, gs)
    if dispatch == "einsum":
        y2d = _dispatch_einsum(params, x2d, gates, chosen, n_groups, gs,
                               n_experts, top_k, capacity)
    elif dispatch == "sort":
        cap_total = x2d.shape[0] * top_k if dropless else capacity * n_groups
        y2d = _dispatch_sort(params, x2d, gates, expert_idx, n_experts,
                             top_k, cap_total)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if pad:
        y2d = y2d[:t_total]
    return y2d.reshape(b, s, d).to(x.dtype), aux
