"""Continuous-batching serving engine for the generator as a causal LM
(port of `repro.serving.engine`, for every family).

One step per engine iteration covers the whole request mix:

  * any-position batched decode: the step takes a per-slot position
    vector, so every active slot decodes every step wherever it is in
    its sequence, with greedy or temperature sampling on the device (the
    host reads back one small token array a step, never logits);
  * chunked prefill interleaved with decode: one prompt chunk (padded to
    a power-of-two bucket, so there are O(log prefill_chunk) step
    programs) runs in the same step as the decode batch, against the
    same caches, its padded tail masked to exact no-ops;
  * paged KV caches (`serving.cache`): full-attention caches are shared
    block pools addressed through per-slot block tables;
  * cross caches (the encoder-decoder and vision families): the stub
    frontend's features (`enc_feats_fn(1)`) do not depend on the
    request, so every cross sublayer's projected k/v is computed once at
    construction (the encoder first, for encdec) and copied into every
    slot's dense cross cache; they are never paged, reset or rewritten.

Sampling is keyed by (seed, rid, token_index): a request's tokens are a
function of the request alone, whatever the batch, the schedule or the
cache backend. The draws are the port's own (`_gumbel`, a counter-based
hash computed on the device); `_sample_one` takes the Gumbel noise as an
argument, so a test can feed it the JAX package's draws.

One program per prefill bucket plus the decode-only one, as the JAX
package jits them. On CUDA each program runs its first step eagerly
(under `set_sync_debug_mode("error")`: the step never waits for the
host), is then captured as a CUDA graph, and every later step of it is
a replay. The caches, the block table and every per-step input live in
static device buffers, updated in place; the host writes the inputs with
two copies and reads back one token array. On the CPU the same step runs
uncaptured.

Host side: FIFO admission by rid, a rejection path for requests that can
never fit (marked failed; the engine keeps going), and a block allocator
for the paged pool (an exhausted pool makes the head of the queue wait).

TENSOR PARALLELISM (tp > 1): one engine a rank of a model group of tp
ranks (`launch.mesh.spawn(..., tp=tp)`, a (1, model=tp) layout), SPMD:
every rank admits, schedules and samples the same requests from the same
inputs, so sampling is replicated, while the dense feed-forward runs
Megatron-style over the group on the rank's shards, cut on entry from
the global parameters (`sharding.rules.shard_tree`): a global-shaped
checkpoint serves at any tp. Rank 0 hands out the finished requests
(`run` returns them there, and an empty list on the other ranks). On a
gloo group the collectives go through the host, so the steps run
uncaptured; capturing them under NCCL across cards waits for a machine
with several (ROADMAP item 1). MoE and fuse_proj configs refuse tp > 1,
as in the JAX package; the cross caches are filled from the global
parameters. A step routes MoE tokens dropless (`nn.moe`) while its
tokens times top_k stay within `nn.moe._DROPLESS_EXACT_LIMIT` (4,096):
prefill_chunk x top_k for a prefill step, batch_size x top_k for a
decode step. A request's tokens then do not depend on what else is in
the batch. Past the limit, as in the JAX package, the step takes the
capacity dispatch at a capacity factor of at least 2, which drops pairs
where the router crowds an expert, so the tokens can depend on the
chunking and on the batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graphs import _sync_debug_error
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.models import gan
from repro_torch.models.backbone import fill_cross_caches, init_decode_caches
from repro_torch.serving import cache as paging
from repro_torch.sharding import rules
from repro_torch.tree import tree_map

@dataclasses.dataclass
class Request:
    rid: Optional[int]
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 => greedy
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    failed: Optional[str] = None        # rejection reason (engine keeps going)


@dataclasses.dataclass
class _Slot:
    req: Request
    pos: int = 0                 # prompt cursor (prefill) / next write index
    blocks: list = dataclasses.field(default_factory=list)
    prefilled: bool = False


def _pow2_bucket(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer mix (xor-shift-multiply) on int64 tensors holding
    unsigned 32-bit values; the multipliers are below 2**31, so no
    product leaves int64."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _gumbel(seed: int, rid, index, vocab: int):
    """Standard Gumbel noise (n, vocab) float32 for tokens `index` (n,)
    of requests `rid` (n,): a function of (seed, rid, token index,
    vocabulary entry) alone, computed on rid's device."""
    h = _mix32(torch.full_like(rid, (seed ^ 0x9E3779B9) & _M32))
    h = _mix32(h ^ (rid & _M32))
    h = _mix32(h ^ (index & _M32))
    v = torch.arange(vocab, device=rid.device)
    h = _mix32(_mix32(h[:, None] ^ v[None, :]) + 0x632BE5AB)
    u = ((h >> 8).float() + 0.5) * 2.0 ** -24          # in (0, 1)
    return -torch.log(-torch.log(u))


def _sample_one(logits, temp, gumbel):
    """Greedy or temperature sampling of logits (..., vocab) at temp
    (...): the argmax where temp <= 0, else argmax(gumbel + logits /
    max(temp, 1e-6)), which is `jax.random.categorical` given the same
    Gumbel noise."""
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / torch.clamp(temp, min=1e-6)[..., None]
    sampled = (gumbel + scaled).argmax(dim=-1)
    return torch.where(temp > 0, sampled, greedy)


class _Program:
    """One step program: eager on the CPU (or when not captured); on
    CUDA the first call runs eagerly on a side stream, then the body is
    captured once and every later call replays it."""

    def __init__(self, body, capture: bool):
        self.body, self.capture = body, capture
        self.graph = None

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            return
        if not self.capture:
            self.body()
            return
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side), _sync_debug_error():
            self.body()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.body()
        self.graph = graph


class ServingEngine:
    """Slot-based continuous batching over a fixed decode batch of B
    slots (module docstring). block_size=None serves from dense per-slot
    caches; an int turns on the paged pool. `device` defaults to CUDA;
    the parameters are moved there. enc_feats_fn(n) gives the
    conditioned families' frontend features (`models.specs.
    make_stub_enc_feats`); they need it."""

    def __init__(self, cfg: ArchConfig, gen_params, *, batch_size: int = 4,
                 max_len: int = 256, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 enc_feats_fn: Optional[Callable] = None, seed: int = 0,
                 tp: int = 1, cache_dtype=torch.float32, device=None):
        if tp > 1:
            if cfg.moe is not None:
                raise ValueError(
                    f"{cfg.name}: MoE serving is tp=1 only (expert "
                    f"parallelism is a ROADMAP item)")
            if cfg.fuse_proj:
                raise ValueError(
                    f"{cfg.name}: fuse_proj=True cannot be tensor-parallel "
                    f"(fused leaves have no per-shard name rule)")
        if cfg.family in ("encdec", "vlm") and enc_feats_fn is None:
            raise ValueError(f"{cfg.name} needs enc_feats_fn: its cross "
                             f"caches hold the frontend's features")
        self.cfg = cfg
        self.enc_feats_fn = enc_feats_fn
        self.tp = tp
        self.tp_rank = 0
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card by index, so that a front end's thread can select it
            self.device = torch.device("cuda", torch.cuda.current_device())
        global_params = gen_params
        if tp > 1:
            group = mesh.axis_group("model")
            err = mesh.tp_mesh_error(group, tp)
            if err:
                raise ValueError(err)
            self.tp_rank = torch.distributed.get_rank(group)
            # the rank's shards, cut from the global parameters
            gen_params = rules.shard_tree(tree_map(torch.as_tensor,
                                                   gen_params),
                                          tp, self.tp_rank)
        self.params = tree_map(lambda x: torch.as_tensor(x).to(self.device),
                               gen_params)
        self.b = batch_size
        self.max_len = max_len
        self.seed = seed
        self.prefill_chunk = max(1, min(prefill_chunk, max_len))
        self.paged = block_size is not None

        if self.paged:
            self.caches, meta = paging.init_paged_caches(
                cfg, batch_size, max_len, block_size=block_size,
                n_blocks=n_blocks, dtype=cache_dtype, device=self.device)
            self.block_size = meta["block_size"]
            self.n_blocks = meta["n_blocks"]
            self.max_blocks = meta["max_blocks"]
            self._paged_subs = frozenset(meta["paged_subs"])
            self.alloc = paging.BlockAllocator(self.n_blocks)
        else:
            self.caches = init_decode_caches(cfg, batch_size, max_len,
                                             dtype=cache_dtype,
                                             device=self.device)
            self.max_blocks = 1
            self._paged_subs = frozenset()
            self.alloc = None
        self.table = np.zeros((batch_size, self.max_blocks), dtype=np.int32)

        self._fill_cross_caches(self.params if tp == 1 else global_params)
        del global_params
        self.slots: list[Optional[_Slot]] = [None] * batch_size
        self.queue: deque[Request] = deque()
        self.rejected: list[Request] = []
        self.finished: list[Request] = []
        self._pf_order: deque[int] = deque()   # slots awaiting prefill, FIFO
        self._next_rid = 0
        self._steps = {}                       # chunk bucket -> _Program
        self.dispatch_count = 0                # steps issued
        # capture the step programs as CUDA graphs (private: a check may
        # turn it off to compare a replay with the eager step); the gloo
        # collectives of tp > 1 cannot be captured
        self._capture = self.device.type == "cuda" and tp == 1
        self._init_io()

    # -- construction helpers ---------------------------------------------

    def _fill_cross_caches(self, params):
        """Fill every slot's cross caches once from the global generator
        parameters (`backbone.fill_cross_caches`), moving to the card
        only what it reads: the encoder and the cross sublayers'
        attention."""
        cfg = self.cfg
        if cfg.family not in ("encdec", "vlm"):
            return
        groups = params["backbone"]["groups"]
        read = {"backbone": {"groups": {
            f"sub{i}": {"attn": groups[f"sub{i}"]["attn"]}
            for i, kind in enumerate(cfg.group_pattern) if kind == "cross"}}}
        if cfg.family == "encdec":
            read["encoder"] = params["encoder"]
        fill_cross_caches(self.caches, tree_map(
            lambda x: torch.as_tensor(x).to(self.device), read), cfg,
            self.enc_feats_fn(1).to(self.device))

    # -- the static step buffers ------------------------------------------

    def _init_io(self):
        """Every per-step input as a view of one of two static device
        buffers (int64, float32), each written from its host twin by one
        copy a step; `_out` receives the sampled tokens."""
        b, c = self.b, self.prefill_chunk
        ints = (("tokens", b), ("pos", b), ("active", b), ("rid", b),
                ("nout", b), ("table", b * self.max_blocks),
                ("pf_tokens", c), ("pf_slot", 1), ("pf_pos0", 1),
                ("pf_nvalid", 1), ("pf_rid", 1))
        floats = (("temp", b), ("pf_temp", 1))
        self._host = {}
        self._io = {}
        for dtype, fields in ((torch.int64, ints), (torch.float32, floats)):
            n = sum(width for _, width in fields)
            host = torch.zeros(n, dtype=dtype)
            dev = torch.zeros(n, dtype=dtype, device=self.device)
            off = 0
            for name, width in fields:
                self._host[name] = host[off:off + width].numpy()
                self._io[name] = dev[off:off + width]
                off += width
            self._host[dtype] = host
            self._io[dtype] = dev
        self._io["table"] = self._io["table"].view(b, self.max_blocks)
        self._io["tokens"] = self._io["tokens"].view(b, 1)
        # the sampled tokens: B decode slots, then the prefill's
        self._out = torch.zeros(b + 1, dtype=torch.int64, device=self.device)

    # -- the step ---------------------------------------------------------

    def _split_slot_caches(self, slot):
        """Caches for a one-slot prefill: paged pools pass whole (the
        block table isolates slots); per-slot dense leaves are copied
        out at batch row `slot` (a (1,) tensor)."""
        return {name: (sub if name in self._paged_subs else
                       {leaf: t.index_select(1, slot)
                        for leaf, t in sub.items()})
                for name, sub in self.caches.items()}

    def _merge_slot_caches(self, part, slot):
        for name, sub in part.items():
            if name not in self._paged_subs:
                for leaf, t in sub.items():
                    self.caches[name][leaf].index_copy_(1, slot, t)

    def _body(self, chunk: Optional[int]):
        """One serving step on the static buffers: an optional prefill
        chunk of `chunk` tokens for one slot, then the any-position
        decode batch, then sampling; the tokens go to `_out`."""
        cfg, io, vocab = self.cfg, self._io, self.cfg.vocab
        with torch.no_grad():
            pf_token = torch.zeros(1, dtype=torch.int64, device=self.device)
            if chunk is not None:
                slot = io["pf_slot"]
                steps = torch.arange(chunk, device=self.device)
                part = self._split_slot_caches(slot)
                out = gan.generator_lm_apply(
                    self.params, cfg, io["pf_tokens"][None, :chunk],
                    mode="decode", caches=part,
                    positions=(io["pf_pos0"] + steps)[None],
                    cache_write_mask=(steps < io["pf_nvalid"])[None],
                    paged_table=(io["table"].index_select(0, slot)
                                 if self.paged else None), remat=False,
                    tp_axis=self._tp_axis)
                self._merge_slot_caches(part, slot)
                last = out["logits"][0].index_select(0, io["pf_nvalid"] - 1)
                pf_token = _sample_one(
                    last, io["pf_temp"],
                    _gumbel(self.seed, io["pf_rid"],
                            torch.zeros_like(io["pf_rid"]), vocab))
            out = gan.generator_lm_apply(
                self.params, cfg, io["tokens"], mode="decode",
                caches=self.caches, positions=io["pos"][:, None],
                cache_write_mask=(io["active"] != 0)[:, None],
                paged_table=io["table"] if self.paged else None,
                remat=False, tp_axis=self._tp_axis)
            toks = _sample_one(out["logits"][:, 0], io["temp"],
                               _gumbel(self.seed, io["rid"], io["nout"],
                                       vocab))
            self._out[:self.b].copy_(toks)
            self._out[self.b:].copy_(pf_token)

    @property
    def _tp_axis(self):
        return "model" if self.tp > 1 else None

    def _get_step(self, chunk: Optional[int]) -> _Program:
        if chunk not in self._steps:
            self._steps[chunk] = _Program(lambda: self._body(chunk),
                                          self._capture)
        return self._steps[chunk]

    @property
    def compile_count(self) -> int:
        """Step programs built so far (captured graphs on CUDA): at most
        1 + log2(prefill_chunk) + 1, whatever the prompts."""
        return len(self._steps)

    def cache_bytes(self) -> int:
        return paging.cache_bytes(self.caches)

    # -- host logic -------------------------------------------------------

    def submit(self, req: Request):
        if req.rid is None:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid) + 1
        self.queue.append(req)

    def _reject(self, req: Request, reason: str):
        req.failed = reason
        self.rejected.append(req)

    def _admit(self):
        """FIFO admission (queue order is rid order): a request that can
        never fit is rejected and skipped; a head that cannot fit yet
        (no free slot, pool exhausted) blocks the queue, so later
        requests never overtake it."""
        while self.queue:
            req = self.queue[0]
            plen = len(req.prompt)
            total = plen + req.max_new_tokens
            if plen == 0:
                self.queue.popleft()
                self._reject(req, "empty prompt")
                continue
            if total > self.max_len:
                self.queue.popleft()
                self._reject(
                    req, f"needs {total} tokens > engine max_len "
                         f"{self.max_len}")
                continue
            slot = next((s for s in range(self.b) if self.slots[s] is None),
                        None)
            if slot is None:
                return
            blocks = []
            if self.paged:
                blocks = self.alloc.alloc(-(-total // self.block_size))
                if blocks is None:
                    return          # pool exhausted: the head waits
            self.queue.popleft()
            self.table[slot, :] = 0
            if blocks:
                self.table[slot, :len(blocks)] = blocks
            self._reset_slot(slot)
            self.slots[slot] = _Slot(req=req, pos=0, blocks=blocks)
            self._pf_order.append(slot)

    def _reset_slot(self, slot: int):
        """Wipe the per-slot dense state a former occupant left: the
        Mamba-2 and conv carries to zero, the attention caches' valid
        bits off. Paged pools need no reset: the fresh block table
        isolates the slot, and retired blocks are invalidated."""
        with torch.no_grad():
            for name, sub in self.caches.items():
                if name in self._paged_subs:
                    continue
                for leaf, t in sub.items():
                    if leaf == "valid":
                        t[:, slot] = False
                    elif leaf in ("ssm", "conv"):
                        t[:, slot] = 0

    def _retire(self, slot: int):
        sl = self.slots[slot]
        sl.req.done = True
        self.finished.append(sl.req)
        if self.paged and sl.blocks:
            paging.invalidate_blocks(
                self.caches, sorted(self._paged_subs),
                torch.tensor(sl.blocks, device=self.device))
            self.alloc.free(sl.blocks)
        self.table[slot, :] = 0
        self.slots[slot] = None

    def _next_prefill(self):
        """The oldest admitted slot still prefilling, with its next chunk
        (a power-of-two bucket <= prefill_chunk)."""
        while self._pf_order and (
                self.slots[self._pf_order[0]] is None
                or self.slots[self._pf_order[0]].prefilled):
            self._pf_order.popleft()
        if not self._pf_order:
            return None
        slot = self._pf_order[0]
        sl = self.slots[slot]
        remaining = len(sl.req.prompt) - sl.pos
        bucket = (self.prefill_chunk if remaining >= self.prefill_chunk
                  else _pow2_bucket(remaining))
        return slot, bucket, min(remaining, bucket)

    def step(self) -> bool:
        """One engine iteration: admit, run ONE step covering the next
        prefill chunk (if any) and every decoding slot, retire finished
        requests. Returns whether any work ran."""
        self._admit()
        pf_work = self._next_prefill()
        dec_slots = [s for s in range(self.b)
                     if self.slots[s] is not None and self.slots[s].prefilled]
        if pf_work is None and not dec_slots:
            return False

        host = self._host
        for dtype in (torch.int64, torch.float32):
            host[dtype].zero_()
        for s in dec_slots:
            sl = self.slots[s]
            host["tokens"][s] = sl.req.out_tokens[-1]
            host["pos"][s] = sl.pos
            host["active"][s] = 1
            host["temp"][s] = sl.req.temperature
            host["rid"][s] = sl.req.rid
            host["nout"][s] = len(sl.req.out_tokens)
        host["table"][:] = self.table.reshape(-1)
        bucket = None
        if pf_work is not None:
            pf_slot, bucket, nvalid = pf_work
            sl = self.slots[pf_slot]
            host["pf_tokens"][:nvalid] = sl.req.prompt[sl.pos:sl.pos + nvalid]
            host["pf_slot"][0] = pf_slot
            host["pf_pos0"][0] = sl.pos
            host["pf_nvalid"][0] = nvalid
            host["pf_rid"][0] = sl.req.rid
            host["pf_temp"][0] = sl.req.temperature
        for dtype in (torch.int64, torch.float32):
            self._io[dtype].copy_(host[dtype])
        self._get_step(bucket)()
        self.dispatch_count += 1
        toks = self._out.cpu().numpy()

        if pf_work is not None:
            sl = self.slots[pf_slot]
            sl.pos += nvalid
            if sl.pos >= len(sl.req.prompt):
                sl.prefilled = True
                sl.req.out_tokens.append(int(toks[self.b]))
                if len(sl.req.out_tokens) >= sl.req.max_new_tokens:
                    self._retire(pf_slot)

        for s in dec_slots:
            sl = self.slots[s]
            sl.req.out_tokens.append(int(toks[s]))
            sl.pos += 1
            if len(sl.req.out_tokens) >= sl.req.max_new_tokens:
                self._retire(s)
        return True

    def run(self, max_steps: int = 10_000):
        """Step until every request is done (or `max_steps`); returns the
        finished requests (on model rank 0; [] on the others)."""
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.finished if self.tp_rank == 0 else []
