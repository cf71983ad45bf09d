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
from repro_torch.tree import tree_index, tree_map


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
