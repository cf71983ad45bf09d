"""Step builders of the launch layer: one protocol training round (on
either layout), serving prefill and serving decode, each returned with
its abstract inputs. Port of `repro.launch.steps`.

Every builder returns (step, args): `step` runs on the tensors it is
given (on their device), and `args` are meta-device tensors of the JAX
package's shapes and dtypes (its `jax.ShapeDtypeStruct`s), built with
no storage (`abstract`), so a caller can size a configuration without
allocating it.

The launch step computes in bfloat16 (`COMPUTE_DTYPE`), as the JAX
package's does: every floating leaf of the state is cast to it,
parameters and optimizer states included (`_bf16_floats`), and the
noise is drawn in it (`make_backbone_spec(dtype=COMPUTE_DTYPE)`), so
every product follows. What the JAX package upcasts, the port upcasts:
the quantizer, Algorithm 2's flat payload, the norms, RoPE, the SSD
scan, the softmaxes and the flash backward run in float32. An optimizer
whose update is wider than the parameters (Adam's float32 moments)
raises a TypeError at the first step (`optim.apply_updates`), as the
JAX package's `lax.scan` over the local steps does: the launch state
trains with SGD (the default) or momentum.

Left out, because they place a global program's arrays on a device
mesh (the GSPMD planner, ROADMAP item 10c): `act_disc_spec`, the
`MeshConfig` argument and the NamedShardings of every step. Where the
JAX builders read the device count from the mesh, these take
`n_devices`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ProtocolConfig, ShapeConfig
from repro_torch.core import engine, graphs, protocol, shard_round
from repro_torch.core import faults as faults_lib
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.device_channel import DeviceChannel
from repro_torch.core.device_scheduling import DeviceScheduler
from repro_torch.launch import mesh
from repro_torch.models import gan as gan_model
from repro_torch.models.backbone import init_decode_caches
from repro_torch.models.specs import make_backbone_spec
from repro_torch.sharding import rules
from repro_torch.tree import tree_index, tree_leaves, tree_map

COMPUTE_DTYPE = torch.bfloat16


def _bf16_floats(tree):
    """`tree` with every floating leaf in COMPUTE_DTYPE and the others
    as they are: a cast of tensors, or of meta-device stand-ins."""
    return tree_map(lambda x: x.to(COMPUTE_DTYPE)
                    if torch.is_tensor(x) and x.is_floating_point() else x,
                    tree)


def abstract(fn):
    """What `fn()` returns, with every tensor replaced by an empty
    meta-device tensor of its shape and dtype: `fn` runs under a fake
    tensor mode, so nothing is allocated (the counterpart of
    `jax.eval_shape`)."""
    with FakeTensorMode():
        out = fn()
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta")
                    if torch.is_tensor(x) else x, out)


def needs_enc(cfg: ArchConfig) -> bool:
    return cfg.family in ("encdec", "vlm")


# per-chip budget for remat carries on the discriminator path (bf16)
_CARRY_BUDGET_BYTES = 1.5e9


def _pick_micro_d(cfg: ArchConfig, m: int, seq: int):
    """Largest divisor of m whose depth-stacked remat carry fits budget."""
    dcfg = gan_model.disc_config(cfg)
    n_groups = dcfg.n_groups_stack
    per_sample = n_groups * seq * cfg.d_model * 2  # bf16 carry per group
    best = 1
    for micro in range(1, m + 1):
        if m % micro == 0 and micro * per_sample <= _CARRY_BUDGET_BYTES:
            best = micro
    return None if best == m else best


def _enc_len(cfg: ArchConfig) -> int:
    return cfg.enc_seq if cfg.family == "encdec" else cfg.n_image_tokens


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Training round
# ---------------------------------------------------------------------------

def build_train_step(cfg: ArchConfig, shape: ShapeConfig, n_devices: int, *,
                     pcfg: Optional[ProtocolConfig] = None,
                     schedule: str = "serial",
                     pcfg_overrides: Optional[dict] = None,
                     fuse_rounds: int = 1, layout: str = "stacked",
                     algorithm: str = "proposed", tp: Optional[int] = None,
                     faults=None, reducer=None, avg_impl: str = "pallas"):
    """The protocol round as the launch layer's train step, on either
    layout, for K = `n_devices` paper workers (the JAX builder's device
    axes): global_batch = K * n_k rows of real data a round.

    The default ProtocolConfig is the JAX builder's: n_d = n_g = 5,
    m = n_k, M = K, `micro_batch_d` from `_pick_micro_d`, SGD, with
    `schedule`; `pcfg_overrides` replaces fields of it (or of `pcfg`).

    layout="stacked": the K workers stacked on one card. Returns
        (step, (state, batch, weights, seed)); step(state, batch,
        weights, seed) -> (state, metrics) runs `protocol.gan_round` on
        batch["tokens"] (K, n_k, seq) with Algorithm 2's (K,) weights
        and the draws of round `seed` of a `protocol.DrawSampler` of run
        seed 0 (the JAX step keys its round by PRNGKey(seed)). With
        fuse_rounds = F > 1 a call runs rounds seed .. seed + F - 1 as
        one chunk through `core.graphs.RoundGraph` (on CUDA the first
        round eager, then one captured CUDA graph a round, replayed), the
        same values as F chained single rounds; metrics then have a
        leading axis F. The state is updated in place (the JAX step
        donates it): the step returns its own static tensors, and a call
        with other tensors copies them in first. Proposed protocol only;
        faults, reducers, avg_impl and tp are the mesh layout's.

    layout="mesh": one rank of a process group a worker (`tp` ranks a
        worker at tp > 1; `launch.mesh.spawn`), `fuse_rounds` rounds a
        call of `shard_round.mesh_rounds` / `fedgan_mesh_rounds`, Step 1
        on every rank (uncaptured). Returns (step, (state, sched_carry,
        tokens, seed, start_round)), a `MeshTrainStep`; the encdec and
        vlm families raise NotImplementedError, as in the JAX package.

    The state is bfloat16 (module docstring); `args` hold the JAX
    builder's abstract inputs as meta tensors, the global state on both
    layouts.
    """
    if shape.global_batch % n_devices:
        raise ValueError(f"global_batch {shape.global_batch} is not a "
                         f"multiple of the {n_devices} devices")
    n_k = shape.global_batch // n_devices
    seq = shape.seq_len
    if pcfg is None:
        # Server sample size M = K so the generator update batch-shards
        # exactly over the devices; microbatching caps the remat carries
        # at disc_depth x micro x seq x d_model.
        pcfg = ProtocolConfig(
            n_devices=n_devices, n_d=5, n_g=5,
            sample_size=n_k, server_sample_size=n_devices,
            micro_batch_d=_pick_micro_d(cfg, n_k, seq),
            schedule=schedule)
    if pcfg_overrides:
        pcfg = dataclasses.replace(pcfg, **pcfg_overrides)

    if layout == "mesh":
        if needs_enc(cfg):
            raise NotImplementedError(
                "layout='mesh' does not support encoder-fed architectures "
                "(encdec/vlm) yet; use layout='stacked'")
        step = MeshTrainStep(cfg, seq, n_k, pcfg, max(1, fuse_rounds),
                             algorithm=algorithm, tp=1 if tp is None else tp,
                             faults=faults, reducer=reducer,
                             avg_impl=avg_impl)
        return step, step.args
    if layout != "stacked":
        raise ValueError(f"unknown layout {layout!r}")
    if faults is not None or reducer is not None:
        raise ValueError(
            "faults/reducer require layout='mesh' (the fused mesh engine "
            "owns scheduling and the averaging collective); the stacked "
            "pod-scale step has no fault machinery")
    if avg_impl != "pallas":
        raise ValueError(
            f"avg_impl={avg_impl!r} selects the mesh layout's explicit "
            f"Algorithm-2 collective; layout='stacked' runs Algorithm 2 "
            f"as one wavg launch on the stacked payload (use "
            f"layout='mesh')")
    if tp not in (None, 1):
        raise ValueError(
            f"tp={tp} applies to layout='mesh' only; the stacked layout "
            f"has no model group")
    if algorithm != "proposed":
        raise ValueError(
            f"build_train_step(layout='stacked') runs the proposed "
            f"protocol only (got algorithm {algorithm!r}); FedGAN runs "
            f"stacked through core.engine.Trainer, or on this builder "
            f"with layout='mesh'")

    enc = needs_enc(cfg)
    state_abs = _bf16_floats(abstract(lambda: protocol.make_train_state(
        lambda g: gan_model.gan_init(g, cfg), pcfg, n_devices,
        device="cpu")))
    batch_abs = {"tokens": _meta((n_devices, n_k, seq), torch.int32)}
    if enc:
        m = max(pcfg.sample_size, pcfg.server_sample_size)
        batch_abs["enc_feats"] = _meta((m, _enc_len(cfg), cfg.d_model),
                                       COMPUTE_DTYPE)
    args = (state_abs, batch_abs, _meta((n_devices,), torch.float32),
            _meta((), torch.int32))
    step = _StackedTrainStep(cfg, seq, n_k, pcfg, max(1, fuse_rounds),
                             protocol.count_params(state_abs["disc"]))
    return step, args


class _StackedTrainStep:
    """The stacked layout's step (`build_train_step`). The batch and
    weights are copied into tensors at fixed addresses on every call,
    so a captured round reads the call's inputs. `sampler` (t ->
    `protocol.RoundDraws`) is the seeded `DrawSampler`, made at the
    first call unless set before it (tests set the JAX package's
    draws)."""

    def __init__(self, cfg, seq, n_k, pcfg, fuse_rounds, n_params):
        self.cfg, self.pcfg, self.fuse_rounds = cfg, pcfg, fuse_rounds
        self.n_k, self.n_params = n_k, n_params
        self.slots = {}
        self.spec = make_backbone_spec(
            cfg, seq, dtype=COMPUTE_DTYPE,
            enc_feats_fn=((lambda n: self.slots["enc_feats"][:n])
                          if needs_enc(cfg) else None))
        self.sampler = None
        self.graph = None

    def _load(self, batch, weights, device):
        new = {"tokens": torch.as_tensor(batch["tokens"]).to(device,
                                                               torch.int64),
               "weights": torch.as_tensor(weights).to(device,
                                                      torch.float32)}
        if needs_enc(self.cfg):
            new["enc_feats"] = torch.as_tensor(batch["enc_feats"]).to(
                device, COMPUTE_DTYPE)
        if not self.slots:
            self.slots.update(new)
            if self.sampler is None:
                self.sampler = protocol.DrawSampler(
                    self.spec, self.pcfg, seed=0, n_local=self.n_k,
                    n_params=self.n_params, device=device)
            return
        for name, value in new.items():
            self.slots[name].copy_(value)

    def _round(self, state, slots):
        return protocol.gan_round(self.spec, self.pcfg, state,
                                  slots["tokens"], slots["weights"],
                                  slots["draws"])

    def __call__(self, state, batch, weights, seed):
        seed = int(seed)
        device = tree_leaves(state)[0].device
        self._load(batch, weights, device)
        if self.fuse_rounds == 1:
            return self._round(state, {**self.slots,
                                       "draws": self.sampler(seed)})
        first = None
        if self.graph is None:
            self.graph = graphs.RoundGraph(capture=device.type == "cuda")
            first = self.sampler(seed)
            self.slots["draws"] = first
            self.graph.bind(self._body, state, {}, self.slots)
        elif state is not self.graph.state:
            graphs.copy_into(self.graph.state, state)
        # round seed's draws bound the slots; later rounds draw into them
        out = self.graph.run(self.fuse_rounds, lambda i: None if (
            i == 0 and first is not None) else self.sampler(
                seed + i, out=self.slots["draws"]))
        return self.graph.state, {k: torch.from_numpy(v)
                                  for k, v in out.items()}

    def _body(self, state, carry, slots):
        state, metrics = self._round(state, slots)
        return state, carry, metrics


class MeshTrainStep:
    """The mesh layout's step (`build_train_step(layout="mesh")`):
    step(state, sched_carry, tokens, seed, start_round) -> (state,
    sched_carry, out), called on every rank of the process group
    together. `state` is this rank's state (`rank_state` of the global
    one: its own optimizer states, its shards at tp > 1); tokens the
    global (K, n_k, seq) batch, of which the rank takes its worker's
    row; round t (start_round <= t < start_round + fuse_rounds) draws
    from the seeded streams of run seed `seed` (`protocol.DrawSampler`
    and the channel's), which stand for the JAX step's PRNG key. `out`
    stacks the rounds' {"metrics", "wallclock_s", "mask", "weights"} as
    numpy arrays, the same on every rank. The state and carry are
    updated in place (the JAX step donates them). The process group is
    looked up at the first call; building the step needs none."""

    def __init__(self, cfg, seq, n_k, pcfg, fuse_rounds, *, algorithm, tp,
                 faults, reducer, avg_impl):
        algo = engine._check_scope(algorithm, "fused", "mesh", tp, pcfg)
        reducer = engine._check_faults(faults, reducer, pcfg, algorithm,
                                       algo)
        engine._check_avg_impl(avg_impl, "mesh", tp, faults, reducer)
        self.cfg, self.pcfg, self.n_k = cfg, pcfg, n_k
        self.fuse_rounds, self.algo, self.tp = fuse_rounds, algo, tp
        self.faults, self.reducer, self.avg_impl = faults, reducer, avg_impl
        self.spec = make_backbone_spec(cfg, seq, dtype=COMPUTE_DTYPE,
                                       tp_axis="model" if tp > 1 else None)
        k = pcfg.n_devices
        self.scheduler = DeviceScheduler(policy=pcfg.scheduler, n_devices=k,
                                         ratio=pcfg.scheduling_ratio)
        state_abs = _bf16_floats(abstract(
            lambda: faults_lib.attach_fault_state(
                algo.make_state(lambda g: gan_model.gan_init(g, cfg), pcfg,
                                k, device="cpu"), faults, algo.payload)))
        self.args = (state_abs,
                     abstract(lambda: self.scheduler.init_carry("cpu")),
                     _meta((k, n_k, seq), torch.int32),
                     _meta((), torch.int64), _meta((), torch.int32))
        # one worker's global state: the channel times whole models and
        # the quantizer's shard dims are decided on it
        worker = self._rank_slice(state_abs, 0)
        self.counts = dict(
            disc_nparams=protocol.count_params(worker["disc"]),
            gen_nparams=protocol.count_params(worker["gen"]),
            uplink_bits=protocol.uplink_payload_bits(worker, pcfg,
                                                     fedgan=algo.fedgan))
        self.n_params = self.counts["disc_nparams"] + (
            self.counts["gen_nparams"] if algo.fedgan else 0)
        self.tp_ctx = shard_round.make_tp_ctx(algo.payload, worker, tp)
        self.tp_dims = (None if tp <= 1 else
                        {key: rules.tp_tree_dims(v, tp)
                         for key, v in worker.items()})
        self._group = None
        self._channels = {}

    def _rank_slice(self, state, k):
        return {key: tree_index(v, k) if key in self.algo.stacked_keys
                else v for key, v in state.items()}

    def _rank(self):
        """(data group, worker index, model rank) of this process."""
        if self._group is None:
            self._group = engine._mesh_rank(None, self.pcfg.n_devices,
                                            self.tp)
        return self._group

    def rank_state(self, state):
        """This rank's state from the global one: its worker's slice of
        the stacked entries, and its shards at tp > 1."""
        _, k, tp_rank = self._rank()
        state = self._rank_slice(state, k)
        if self.tp_dims is not None:
            state = {key: rules.shard_tree(v, self.tp, tp_rank,
                                           self.tp_dims[key])
                     for key, v in state.items()}
        return state

    def global_state(self, state):
        """The global state from every rank's (a collective: every rank
        calls it): the shards gathered over the model group, then the
        workers' stacked entries over the data group."""
        group, _, _ = self._rank()
        if self.tp_dims is not None:
            state = {key: rules.gather_tree(v, self.tp_dims[key], "model")
                     for key, v in state.items()}
        return {key: tree_map(lambda x: mesh.all_gather(x, group), v)
                if key in self.algo.stacked_keys else v
                for key, v in state.items()}

    def __call__(self, state, sched_carry, tokens, seed, start_round):
        group, k, _ = self._rank()
        device = tree_leaves(state)[0].device
        if device not in self._channels:
            self._channels[device] = DeviceChannel(
                ChannelConfig(n_devices=self.pcfg.n_devices), device)
        data = torch.as_tensor(tokens)[k].to(device, torch.int64)
        sampler = protocol.DrawSampler(
            self.spec, self.pcfg, seed=int(seed), n_local=self.n_k,
            n_params=self.n_params, device=device, faults=self.faults)
        return self.algo.mesh_rounds(
            self.spec, self.pcfg, state, data, self.fuse_rounds,
            channel=self._channels[device], scheduler=self.scheduler,
            sampler=sampler, seed=int(seed), sched_carry=sched_carry,
            start_round=int(start_round), faults=self.faults,
            reducer=self.reducer, graph=graphs.RoundGraph(capture=False),
            group=group, avg_impl=self.avg_impl, tp_ctx=self.tp_ctx,
            **self.counts)


# ---------------------------------------------------------------------------
# Serving: prefill and single-token decode
# ---------------------------------------------------------------------------

def _gen_abs(cfg: ArchConfig):
    return _bf16_floats(abstract(lambda: gan_model.generator_init(
        torch.Generator(), cfg)))


def build_prefill_step(cfg: ArchConfig, shape: ShapeConfig):
    """Prefill of global_batch prompts of seq_len tokens: step(gen_params,
    batch) -> (last-position logits (b, vocab), caches of seq_len
    slots), with batch {"tokens" (b, s) integers, "enc_feats" (b, t,
    d_model) for the conditioned families}. Returns (step, (gen_params,
    batch)) abstract: bfloat16 generator parameters."""
    b, s = shape.global_batch, shape.seq_len

    @torch.no_grad()
    def prefill_step(gen_params, batch):
        out = gan_model.generator_lm_apply(
            gen_params, cfg, batch["tokens"], mode="prefill",
            enc_feats=batch.get("enc_feats"), remat=False,
            prefill_cache_len=s)
        # last-position logits only (next-token): the prefill output
        return out["logits"][:, -1, :], out["caches"]

    batch_abs = {"tokens": _meta((b, s), torch.int32)}
    if needs_enc(cfg):
        batch_abs["enc_feats"] = _meta((b, _enc_len(cfg), cfg.d_model),
                                       COMPUTE_DTYPE)
    return prefill_step, (_gen_abs(cfg), batch_abs)


def build_decode_step(cfg: ArchConfig, shape: ShapeConfig):
    """One decode token against caches of seq_len slots:
    step(gen_params, token (b, 1), caches, cache_index) -> (logits
    (b, vocab), caches), the caches updated in place. Returns (step,
    (gen_params, token, caches, cache_index)) abstract: bfloat16
    parameters and `init_decode_caches(dtype=COMPUTE_DTYPE)`."""
    b, s = shape.global_batch, shape.seq_len

    @torch.no_grad()
    def decode_step(gen_params, token, caches, cache_index):
        out = gan_model.generator_lm_apply(
            gen_params, cfg, token, mode="decode", caches=caches,
            cache_index=cache_index, remat=False)
        return out["logits"][:, 0, :], out["caches"]

    caches_abs = abstract(lambda: init_decode_caches(
        cfg, b, s, dtype=COMPUTE_DTYPE, device="cpu"))
    return decode_step, (_gen_abs(cfg), _meta((b, 1), torch.int32),
                         caches_abs, _meta((), torch.int32))


# ---------------------------------------------------------------------------

def build_step(cfg: ArchConfig, shape: ShapeConfig, n_devices: int, **kw):
    if shape.kind == "train":
        return build_train_step(cfg, shape, n_devices, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape)
    raise ValueError(shape.kind)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, n_devices: int):
    """Meta-tensor stand-ins for every model input of this step."""
    _, args = build_step(cfg, shape, n_devices)
    return args
