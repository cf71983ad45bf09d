"""The paper's experiments and the backbone families on the mesh layout
(`run_experiment(layout="mesh")`, `fig5_fedgan --layout mesh`,
`fedgan_compare --layout mesh`, `Trainer(layout="mesh")` on reduced
mamba2-130m, granite-3-2b, granite-moe-3b-a800m and zamba2-2.7b at 2
groups), each against its stacked twin, which
the other port tests hold to the JAX package.

Every mesh run is gloo ranks on the CPU, one a paper worker. Each figure
call starts its ranks once for all its settings (`common.run_on_mesh`);
the backbone rounds share one spawn of 2 ranks. Masks, weights and the
simulated wallclock must be equal bit for bit; metrics to 1e-5; FID to
1e-4 relative; the trained globals to one 16-bit quantization step (a
stochastic rounding decided on either side of an edge) plus 1e-6, the
server's generator of the proposed protocol to 1e-5.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ProtocolConfig
from repro_torch.core import Trainer
from repro_torch.core.engine import RoundRecord
from repro_torch.examples import fedgan_compare
from repro_torch.experiments import common, fig5_fedgan
from repro_torch.launch import mesh
from repro_torch.tree import tree_leaves
import torch_mesh_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 3
TIMEOUT_S = 150
# the reduced backbone-GANs of the mesh rounds, 2 ranks
BACKBONES = {"mamba2-130m": dict(arch="mamba2-130m", seq=40),
             "granite-3-2b": dict(arch="granite-3-2b", seq=24,
                                  changes={"n_kv_heads": 2}),
             "granite-moe-3b-a800m": dict(arch="granite-moe-3b-a800m",
                                          seq=24),
             "zamba2-2.7b": dict(arch="zamba2-2.7b", seq=24,
                                 changes={"n_layers": 12})}
BACKBONE_RUNS = {
    "mamba2-130m": dict(algorithm="proposed", impl="ring", driver="host",
                        seed=1, faults=None,
                        pcfg=dict(n_devices=2, n_d=1, n_g=1, sample_size=2,
                                  server_sample_size=2, lr_d=1e-3,
                                  lr_g=1e-3, optimizer="adam",
                                  scheduler="round_robin",
                                  scheduling_ratio=0.5)),
    "granite-3-2b": dict(algorithm="proposed", impl="pallas",
                         driver="fused", seed=2, faults=None,
                         pcfg=dict(n_devices=2, n_d=1, n_g=1, sample_size=2,
                                   server_sample_size=2, lr_d=1e-3,
                                   lr_g=1e-3, optimizer="adam",
                                   schedule="parallel")),
    # the MoE and hybrid families: the capacity dispatch in every
    # forward, the shared block called twice
    "granite-moe-3b-a800m": dict(
        algorithm="proposed", impl="pallas", driver="host", seed=3,
        faults=None, pcfg=dict(n_devices=2, n_d=1, n_g=1, sample_size=2,
                               server_sample_size=2, lr_d=1e-3, lr_g=1e-3,
                               optimizer="adam")),
    "zamba2-2.7b": dict(
        algorithm="proposed", impl="ring", driver="fused", seed=4,
        faults=None, pcfg=dict(n_devices=2, n_d=1, n_g=1, sample_size=2,
                               server_sample_size=2, lr_d=1e-3, lr_g=1e-3,
                               optimizer="adam")),
}


def _tokens(model, seed):
    from repro_torch.configs import get_arch_config
    vocab = get_arch_config(model["arch"]).reduced().vocab
    return np.random.default_rng(seed).integers(
        0, vocab, (2, 4, model["seq"])).astype(np.int32)


@pytest.fixture(scope="module")
def figures(tmp_path_factory):
    """fig5 --smoke (the proposed protocol and FedGAN, fused driver, K=3)
    and fedgan_compare (both algorithms, host driver, K=2), reduced, 2
    rounds with FID at round 2, on the mesh (K gloo ranks, started once a
    call) and stacked."""
    out = tmp_path_factory.mktemp("figures")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ROUNDS", 2)
        mp.setattr(common, "EVAL_EVERY", 2)
        runs = {layout: {
            "fig5": fig5_fedgan.main(str(out), layout=layout, k=K,
                                     smoke=True, device="cpu"),
            "fedgan_compare": fedgan_compare.main(
                ["--layout", layout, "--driver", "host", "--rounds", "2",
                 "--devices", "2", "--data", "64", "--device", "cpu"])}
            for layout in ("mesh", "stacked")}
    return runs, out


# a figure setting of K devices, which a group of 2 ranks must refuse
TOO_FEW = dict(k=K, rounds=1, driver="host", layout="mesh")


@pytest.fixture(scope="module")
def backbone_ranks(tmp_path_factory):
    """{arch: [(history, state, driver) of rank 0, of rank 1]}: the
    backbone runs of BACKBONE_RUNS, and {"refusal": [each rank's error]}
    of a TOO_FEW figure setting, from one spawn of 2 gloo ranks."""
    parts = {arch: ("trainer_runs", (BACKBONES[arch], _tokens(
                 BACKBONES[arch], run["seed"]), [run]))
             for arch, run in BACKBONE_RUNS.items()}
    parts["refusal"] = ("refusal", (common.Setting(**TOO_FEW)
                                    .resolved(),))
    init = tmp_path_factory.mktemp("backbones") / "init"
    per_rank = mesh.spawn(functools.partial(torch_mesh_ranks.suite, parts),
                          2, device="cpu", init_method=f"file://{init}",
                          timeout_s=TIMEOUT_S)
    return {name: [r[name] if name == "refusal" else r[name][0]
                   for r in per_rank] for name in parts}


def quant_step_close(got, want, *, atol):
    """Leaves of two trees agree to `atol` plus one 16-bit quantization
    step of the leaf (amax / 32767)."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        x, y = torch.as_tensor(np.asarray(x)), y.detach()
        step = float(y.abs().max()) / 32767
        torch.testing.assert_close(x, y, rtol=0, atol=atol + step)


def records_match(mesh_recs, stacked_recs):
    """Two histories: masks, weights, wallclock and cumulative clock bit
    for bit, metrics to 1e-5, FID (where taken) to 1e-4 relative."""
    assert len(mesh_recs) == len(stacked_recs)
    for m, s in zip(mesh_recs, stacked_recs):
        assert m.round == s.round
        np.testing.assert_array_equal(m.mask, s.mask)
        np.testing.assert_array_equal(m.weights, s.weights)
        assert (m.wallclock_s, m.cumulative_s) == (s.wallclock_s,
                                                   s.cumulative_s)
        assert m.metrics.keys() == s.metrics.keys()
        for key, value in s.metrics.items():
            np.testing.assert_allclose(m.metrics[key], value, rtol=0,
                                       atol=1e-5)
        assert (m.fid is None) == (s.fid is None)
        if s.fid is not None:
            np.testing.assert_allclose(m.fid, s.fid, rtol=1e-4)


def test_fig5_mesh_matches_stacked(figures):
    """fig5_fedgan --layout mesh --smoke: run_experiments on the mesh,
    fused, for the proposed protocol and FedGAN: every curve, and the
    JSON curves fig5 writes, are the stacked run's."""
    runs, out = figures
    mesh_curves, stacked_curves = runs["mesh"]["fig5"], runs["stacked"]["fig5"]
    assert [c.label for c in mesh_curves] == [c.label for c in
                                              stacked_curves] == [
        "fig5/proposed-serial", "fig5/fedgan"]
    for m, s in zip(mesh_curves, stacked_curves):
        assert (m.rounds, m.wallclock) == (s.rounds, s.wallclock)
        assert m.rounds == [0, 1]
        records_match(m.records, s.records)
        assert m.fid[0] is None and np.isfinite(m.fid[1])
    for layout, curves in (("mesh", mesh_curves), ("stacked", stacked_curves)):
        with open(out / f"fig5_fedgan_{layout}.json") as f:
            assert json.load(f) == [c.as_dict() for c in curves]
    assert [c.records[0].metrics.keys() for c in mesh_curves] == [
        {"disc_objective", "gen_objective", "participation"},
        {"participation"}]


def test_fedgan_compare_mesh_matches_stacked(figures):
    """fedgan_compare --layout mesh --driver host: both algorithms' last
    rounds, FID included, as the stacked layout's."""
    runs, _ = figures
    mesh_recs, stacked_recs = (runs["mesh"]["fedgan_compare"],
                               runs["stacked"]["fedgan_compare"])
    records_match(mesh_recs, stacked_recs)
    assert all(np.isfinite(r.fid) for r in mesh_recs)


@pytest.mark.parametrize("arch", list(BACKBONE_RUNS))
def test_backbone_mesh_rounds_match_stacked(backbone_ranks, arch):
    """2 mesh rounds of a reduced backbone-GAN (mamba2-130m on the ring,
    host driver; granite-3-2b with 2 kv heads on the flat all-gather,
    fused driver, parallel schedule; granite-moe-3b-a800m on the flat
    all-gather, host driver; zamba2-2.7b at 2 groups on the ring, fused
    driver) on 2 ranks against the stacked
    Trainer of the same seed and driver: the records, the globals, and
    each rank's own Adam moments of the group-stacked discriminator as
    its row of the stacked ones."""
    run, model = BACKBONE_RUNS[arch], BACKBONES[arch]
    spec, init_fn = torch_mesh_ranks._model(model)
    stacked = Trainer(spec, ProtocolConfig(**run["pcfg"]), init_fn,
                      _tokens(model, run["seed"]), seed=run["seed"],
                      driver=run["driver"], device="cpu")
    want = stacked.run(2)
    if run["pcfg"].get("scheduler") == "round_robin":
        assert all(rec.mask.sum() == 1 for rec in want)
    for r, (hist, state, driver) in enumerate(backbone_ranks[arch]):
        assert driver == stacked.driver == run["driver"]
        records_match([RoundRecord(rec.round, wall, cum, metrics, None,
                                   mask=mask, weights=weights)
                       for (mask, weights, metrics, wall, cum), rec
                       in zip(hist, want)], want)
        quant_step_close(state["disc"], stacked.state["disc"], atol=1e-6)
        for a, b in zip(tree_leaves(state["gen"]),
                        tree_leaves(stacked.state["gen"])):
            torch.testing.assert_close(torch.as_tensor(a), b, rtol=0,
                                       atol=1e-5)
        for a, b in zip(tree_leaves(state["disc_opt"]),
                        tree_leaves(stacked.state["disc_opt"])):
            torch.testing.assert_close(torch.as_tensor(a), b[r], rtol=0,
                                       atol=1e-5)


def test_mesh_refusals(backbone_ranks):
    """A mesh run needs a rank a device (no fallback to the stacked
    layout): a figure setting of K devices raises on each rank of a group
    of 2; the centralized baseline has no mesh layout; the runs of one
    call share their ranks, so their K must agree."""
    for message in backbone_ranks["refusal"]:
        assert "one rank per device" in message
    with pytest.raises(ValueError, match="not supported for algorithm "
                                         "'centralized'"):
        common.run_experiment("x", algorithm="centralized", k=K,
                              layout="mesh", device="cpu")
    with pytest.raises(ValueError, match="share their ranks"):
        common.run_experiments([("a", dict(k=2)), ("b", dict(k=3))],
                               layout="mesh", device="cpu")
    with pytest.raises(ValueError, match="is not ported"):
        common.run_experiment("x", k=K, layout="grid", device="cpu")
