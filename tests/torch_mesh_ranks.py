"""Rank bodies for the port's mesh-layout tests, run by
`repro_torch.launch.mesh.spawn` in processes of their own.

This module imports torch, numpy and the port only: every spawned rank
imports it, so it must not pull in JAX. Inputs arrive as numpy trees
(made by the test modules, which compute the JAX references), and
results go back as numpy trees.
"""
import numpy as np
import torch

from repro_torch import interop
from repro_torch.tree import tree_index, tree_leaves, tree_map


def _setup():
    torch.set_num_threads(1)


def _draws(fields):
    from repro_torch.core import protocol
    return protocol.RoundDraws(**{
        name: (torch.from_numpy(v) if isinstance(v, np.ndarray)
               and name != "drop_u" else v)
        for name, v in fields.items()})


def ring_cases(cases, rank, world_size, device):
    """Every case's `ring_average_psum` on this rank: (result tree as
    float32, wire bytes sent, result dtypes, the row ranges accumulated
    through `ops.RowAccumulator`, in order)."""
    from repro_torch.kernels.ring_wavg import ops
    _setup()
    ranges = []
    accumulate = ops.RowAccumulator.__call__

    def recorded(self, r0, r1):
        ranges.append((r0, r1))
        return accumulate(self, r0, r1)

    ops.RowAccumulator.__call__ = recorded
    out = []
    for case in cases:
        ranges.clear()
        tree = {name: torch.from_numpy(a[rank]).to(getattr(torch, dt))
                for name, (a, dt) in case["tree"].items()}
        fallback = (tree_map(torch.ones_like, tree) if case["fallback"]
                    else None)
        u = case["uniforms"]
        before = ops.wire_bytes_sent
        avg = ops.ring_average_psum(
            tree, torch.tensor(case["w"][rank]),
            uniforms=None if u is None else torch.from_numpy(u[rank]),
            bits=case["bits"], n_chunks=case["n_chunks"], fallback=fallback)
        out.append((tree_map(lambda x: x.float(), avg),
                    ops.wire_bytes_sent - before,
                    {name: str(x.dtype) for name, x in avg.items()},
                    list(ranges)))
    return out


def psum_cases(tree_stacked, cases, rank, world_size, device):
    """`weighted_average_psum` on this rank's row of `tree_stacked`, for
    each (impl, robust method or None, weights (K,), fallback?) case."""
    from repro_torch.core.averaging import weighted_average_psum
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    _setup()
    tree = tree_index(interop.to_torch(tree_stacked, device), rank)
    out = []
    for impl, method, weights, fallback in cases:
        out.append(weighted_average_psum(
            tree, torch.tensor(weights[rank]), impl=impl,
            robust=RobustConfig(method=method) if method else None,
            fallback=tree_map(torch.ones_like, tree) if fallback else None))
    return out


def _model(model):
    """(spec, init_fn(generator)) of a model: the keyword arguments of a
    DCGANConfig, or {"arch": name, "seq": seq_len, "changes": {...}} for
    the backbone-GAN of a registered architecture's reduced config."""
    from repro_torch.models import specs
    if "arch" in model:
        import dataclasses
        from repro_torch.configs import get_arch_config
        from repro_torch.models import gan
        cfg = dataclasses.replace(get_arch_config(model["arch"]).reduced(),
                                  **model.get("changes", {}))
        return (specs.make_backbone_spec(cfg, model["seq"], remat=False,
                                         gen_loss_variant="nonsaturating"),
                lambda g: gan.gan_init(g, cfg))
    from repro_torch.configs import DCGANConfig
    from repro_torch.models import dcgan
    cfg = DCGANConfig(**model)
    return specs.make_dcgan_spec(cfg), lambda g: dcgan.gan_init(g, cfg)


def round_cases(model, state, data, cases, rank, world_size, device):
    """One mesh round per case on this rank, each from `state` (the
    stacked-layout state of the JAX package: per-device optimizer states
    stacked K). Returns [(new rank state, metrics)]."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import faults, shard_round
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    _setup()
    spec, _ = _model(model)
    out = []
    for case in cases:
        fedgan = case["algorithm"] == "fedgan"
        keys = (shard_round.FEDGAN_STACKED_KEYS if fedgan
                else shard_round.PROPOSED_STACKED_KEYS)
        st = interop.to_torch(state[case["algorithm"]], device)
        st = {k: tree_index(v, rank) if k in keys else v
              for k, v in st.items()}
        fcfg = (faults.FaultConfig(**case["faults"]) if case["faults"]
                else None)
        if fcfg is not None:
            st = faults.attach_fault_state(
                st, fcfg, shard_round.FEDGAN_PAYLOAD if fedgan
                else shard_round.PROPOSED_PAYLOAD)
        fn = (shard_round.fedgan_mesh_round if fedgan
              else shard_round.mesh_round)
        new_st, metrics = fn(
            spec, ProtocolConfig(**case["pcfg"]), st,
            torch.from_numpy(data[rank]), torch.tensor(case["w"][rank]),
            _draws(case["draws"]), avg_impl=case["impl"], faults=fcfg,
            reducer=(RobustConfig(**case["reducer"]) if case["reducer"]
                     else None))
        out.append((new_st, {k: float(v) for k, v in metrics.items()}))
    return out


def trainer_runs(model, data, runs, rank, world_size, device):
    """`Trainer(layout="mesh")` of `model` (`_model`) for each run: 2
    rounds of the run's driver from the seeded initial parameters.
    Returns [(history, state, the resolved driver)]."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.faults import FaultConfig
    _setup()
    spec, init_fn = _model(model)
    out = []
    for run in runs:
        tr = Trainer(spec, ProtocolConfig(**run["pcfg"]), init_fn, data,
                     seed=run["seed"],
                     algorithm=run["algorithm"], layout="mesh",
                     avg_impl=run["impl"], driver=run["driver"],
                     device=device,
                     faults=FaultConfig(**run["faults"]) if run["faults"]
                     else None)
        hist = tr.run(2)
        out.append(([(r.mask, r.weights, r.metrics, r.wallclock_s,
                      r.cumulative_s) for r in hist], tr.state, tr.driver))
    return out


def failing(rank, world_size, device):
    """Rank 1 raises."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    return rank


def suite(parts, rank, world_size, device):
    """Several of the bodies above in one spawn: `parts` maps a name to
    (body name, its leading arguments); returns {name: result}."""
    return {name: globals()[body](*args, rank, world_size, device)
            for name, (body, args) in parts.items()}


def checkpoint_run(model, data, run, directory, rank, world_size, device):
    """`Trainer(layout="mesh")`: one round of the run's driver, then
    `save_checkpoint(directory)`; a second mesh Trainer restores it.
    Returns (the first Trainer's state, the restored Trainer's state,
    what save_checkpoint returned)."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    _setup()
    spec, init_fn = _model(model)

    def make():
        return Trainer(spec, ProtocolConfig(**run["pcfg"]), init_fn, data,
                       seed=run["seed"], algorithm=run["algorithm"],
                       layout="mesh", avg_impl=run["impl"],
                       driver=run["driver"], device=device)

    tr = make()
    tr.run(1)
    path = tr.save_checkpoint(directory)
    again = make()
    again.restore(directory)
    return tr.state, again.state, path


def refusal(setting, rank, world_size, device):
    """What `experiments.common._run_setting(setting)` raises on this rank
    (a ValueError's message; None if it runs)."""
    from repro_torch.experiments import common
    _setup()
    try:
        common._run_setting(setting, device)
    except ValueError as err:
        return str(err)
    return None


# ---------------------------------------------------------------------------
# Tensor parallelism: K workers x tp model ranks (spawn(..., tp=tp))
# ---------------------------------------------------------------------------

def _tp_ranks():
    """(worker k, model rank r, data group, model group) of this rank."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    data, model = mesh.axis_group("data"), mesh.axis_group("model")
    return dist.get_rank(data), dist.get_rank(model), data, model


def tp_collectives(mlp_params, x, cot, rank, world_size, device):
    """`nn.tp`'s three pairs on this rank's model group, and the TP MLP
    (this rank's shards of `mlp_params`) forward and backward against
    the cotangent `cot`. Returns {"reduce", "copy_grad", "gather",
    "gather_grad", "y", "dx", "grads" (the rank's shards)}."""
    from repro_torch.nn import mlp, tp
    from repro_torch.sharding import rules
    _setup()
    k, r, _, _ = _tp_ranks()
    out = {}
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1) + k
    out["reduce"] = tp.reduce_from_tp(a, "model")
    a.requires_grad_(True)
    copied = tp.copy_to_tp(a, "model")
    (copied * (r + 2)).sum().backward()
    out["copy_grad"] = a.grad
    b = a.detach().clone().requires_grad_(True)
    gathered = tp.gather_from_tp(b, "model", dim=0)
    weights = torch.arange(gathered.numel(), dtype=torch.float32).reshape(
        gathered.shape)
    (gathered * weights).sum().backward()
    out["gather"], out["gather_grad"] = gathered, b.grad
    params = rules.shard_tree(interop.to_torch(mlp_params, device), 2, r)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mlp.mlp_apply(params, xt, tp_axis="model")
    (y * torch.from_numpy(cot)).sum().backward()
    out["y"], out["dx"] = y, xt.grad
    out["grads"] = tree_map(lambda t: t.grad, params)
    out["tp_rank"] = tp.tp_rank("model")
    return out


def tp_round_cases(state, data, cases, rank, world_size, device):
    """One TP mesh round of the MLP-GAN per case on this rank, from the
    stacked-layout `state` of the case's algorithm: the rank's slice of
    the per-device entries, its shards of everything (`make_tp_ctx` and
    the shard dims decided on the global state). Returns [(new state
    shards, metrics)]."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import shard_round
    from repro_torch.models import gan
    from repro_torch.sharding import rules
    _setup()
    k, r, data_group, _ = _tp_ranks()
    spec = gan.mlp_gan_spec(d_z=8, tp_axis="model")
    out = []
    for case in cases:
        fedgan = case["algorithm"] == "fedgan"
        keys = (shard_round.FEDGAN_STACKED_KEYS if fedgan
                else shard_round.PROPOSED_STACKED_KEYS)
        st = interop.to_torch(state[case["algorithm"]], device)
        st = {key: tree_index(v, k) if key in keys else v
              for key, v in st.items()}
        ctx = shard_round.make_tp_ctx(
            shard_round.FEDGAN_PAYLOAD if fedgan
            else shard_round.PROPOSED_PAYLOAD, st, 2)
        st = {key: rules.shard_tree(v, 2, r) for key, v in st.items()}
        fn = (shard_round.fedgan_mesh_round if fedgan
              else shard_round.mesh_round)
        new_st, metrics = fn(
            spec, ProtocolConfig(**case["pcfg"]), st,
            torch.from_numpy(data[k]), torch.tensor(case["w"][k]),
            _draws(case["draws"]), group=data_group, avg_impl=case["impl"],
            tp_ctx=ctx)
        out.append((new_st, {key: float(v) for key, v in metrics.items()}))
    return out


def _tp_model(model, tp):
    """(spec, init_fn) of `_model`'s model, built for `tp`: the MLP-GAN
    ({"mlp": kwargs of mlp_gan_init}) or a reduced backbone."""
    from repro_torch.models import gan, specs
    axis = "model" if tp > 1 else None
    if "mlp" in model:
        return (gan.mlp_gan_spec(d_z=model["mlp"].get("d_z", 8),
                                 tp_axis=axis),
                lambda g: gan.mlp_gan_init(g, **model["mlp"]))
    import dataclasses
    from repro_torch.configs import get_arch_config
    cfg = dataclasses.replace(get_arch_config(model["arch"]).reduced(),
                              **model.get("changes", {}))
    return (specs.make_backbone_spec(cfg, model["seq"], remat=False,
                                     gen_loss_variant="nonsaturating",
                                     tp_axis=axis),
            lambda g: gan.gan_init(g, cfg))


def weights_fid(gen, generator):
    """A stand-in FID that reads every generator leaf: the sum of their
    absolute values."""
    return float(sum(float(x.double().abs().sum()) for x in
                     tree_leaves(gen)))


def tp_trainer_runs(data_by_model, runs, rank, world_size, device):
    """`Trainer(layout="mesh", tp=2)` for each run: its rounds of its
    driver, with `weights_fid` every run["eval_every"] rounds. Returns
    [(history, the global state, the rank's own state shards' shapes of
    one MLP leaf)]."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    _setup()
    out = []
    for run in runs:
        spec, init_fn = _tp_model(run["model"], 2)
        tr = Trainer(spec, ProtocolConfig(**run["pcfg"]), init_fn,
                     data_by_model[run["data"]], seed=run["seed"],
                     algorithm=run["algorithm"], layout="mesh", tp=2,
                     driver=run["driver"], device=device,
                     channel_cfg=ChannelConfig(**run["channel"]))
        hist = tr.run(run["rounds"], eval_every=run["eval_every"],
                      fid_fn=weights_fid)
        out.append(([(h.mask, h.weights, h.metrics, h.wallclock_s,
                      h.cumulative_s, h.fid) for h in hist],
                    tr._global_state(),
                    {k: tuple(v.shape) for k, v in
                     tr.state["disc"].items()} if "mlp" in run["model"]
                    else None))
    return out


def tp_checkpoint(data, run, directory, rank, world_size, device):
    """A tp=2 mesh Trainer of the MLP-GAN: 1 round, `save_checkpoint`;
    then a tp=1 mesh Trainer on this rank's data group restores it and
    runs 1 round. Returns (the tp=2 global state, the restored tp=1
    state, its round-1 record, save_checkpoint's return)."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    _setup()
    _, _, data_group, _ = _tp_ranks()

    def make(tp, **kw):
        spec, init_fn = _tp_model(run["model"], tp)
        return Trainer(spec, ProtocolConfig(**run["pcfg"]), init_fn, data,
                       seed=run["seed"], algorithm=run["algorithm"],
                       layout="mesh", driver=run["driver"], device=device,
                       channel_cfg=ChannelConfig(**run["channel"]), tp=tp,
                       **kw)

    tr = make(2)
    tr.run(1)
    path = tr.save_checkpoint(directory)
    before = tr._global_state()
    one = make(1, group=data_group)
    one.restore(directory)
    # a copy: the fused driver goes on in the restored tensors
    restored = tree_map(lambda t: t.clone(), one.state)
    rec = one.run(1)[0]
    return before, restored, (rec.round, rec.mask, rec.cumulative_s), path


def tp_serve(ckpt_dir, arch, workload, blocks, rank, world_size, device):
    """The generator of the global checkpoint in `ckpt_dir` served at
    tp=2 on this rank, once a block size in `blocks` (None: dense):
    [(finished {rid: tokens} as `run` returns them, every rank's own
    {rid: tokens}, the rank's w_out shard shape)]."""
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import load_generator_params
    from repro_torch.serving import Request, ServingEngine
    _setup()
    cfg = get_arch_config(arch).reduced()
    params, _ = load_generator_params(ckpt_dir)
    out = []
    for block in blocks:
        eng = ServingEngine(cfg, params, batch_size=2, max_len=32,
                            block_size=block, prefill_chunk=4, tp=2,
                            device=device)
        for i, (p, n) in enumerate(workload):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        handed = eng.run()
        out.append(({r.rid: list(r.out_tokens) for r in handed},
                    {r.rid: list(r.out_tokens) for r in eng.finished},
                    tuple(eng.params["backbone"]["groups"]["sub0"]["ff"]
                          ["w_out"].shape)))
    return out


def launch_cli_runs(argvs, rank, world_size, device):
    """`repro_torch.launch.train`'s mesh layout on these ranks for each
    argv in turn (what its `main` spawns for one)."""
    from repro_torch.launch import train
    for argv in argvs:
        args, faults, reducer = train._checked_args(argv)
        train._train_rank(args, faults, reducer, rank, world_size, device)
