"""Port parity: the mesh layout at tp=1 (`repro_torch.core.shard_round`,
`weighted_average_psum`, `Trainer(layout="mesh")`), one gloo rank per
paper worker on the CPU.

The JAX reference of a mesh round is the JAX package's own round body,
`shard_round._proposed_slice_round` / `_fedgan_slice_round`, under
`jax.vmap(axis_name="data")`: a real named axis of size K on one CPU
device, the harness of tests/test_ring_wavg_property.py. Both sides start
from the same weights (`repro_torch.interop`) and take the same draws
(`JaxDraws`, `FaultJaxDraws`). Parameters agree to f32 round-off, or to
one 16-bit quantization step where a stochastic rounding flips.

Every port computation runs in ONE spawn of 3 ranks (a module-scoped
fixture), initialised through a file in a temporary directory, with
timeouts on the process group and on the wait for results.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs.base import ProtocolConfig as JaxProtocolConfig
from repro.core import faults as jfaults
from repro.core import fedgan as jfedgan
from repro.core import protocol as jprotocol
from repro.core import shard_round as jshard
from repro.kernels.robust_avg.ops import RobustConfig as JaxRobustConfig
from repro.models import dcgan as jdcgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.configs import ProtocolConfig
from repro_torch.core import Trainer, faults, shard_round
from repro_torch.core.averaging import (weighted_average,
                                        weighted_average_psum)
from repro_torch.kernels.robust_avg.ops import RobustConfig
from repro_torch.launch import mesh
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
import torch_mesh_ranks
from test_torch_faults import FaultJaxDraws
from test_torch_protocol import (JCFG, KEY, SMALL, TCFG, JaxDraws,
                                 quant_step_close)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, N_LOCAL = 3, 8
TIMEOUT_S = 150
PCFG = dict(n_devices=K, n_d=2, n_g=1, sample_size=6, server_sample_size=6,
            lr_d=1e-3, lr_g=1e-3, optimizer="adam")
# one free-rider and one byzantine worker of 3
FAULTS = dict(n_devices=K, n_free_riders=1, n_byzantine=1, byz_scale=10.0,
              seed=3)


def _data():
    rng = np.random.default_rng(3)
    return np.tanh(rng.standard_normal(
        (K, N_LOCAL, 16, 16, 1))).astype(np.float32)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundCase:
    algorithm: str
    impl: str
    schedule: str = "serial"
    bits: int = 16
    weights: tuple = (6.0, 0.0, 6.0)     # worker 1 dropped
    faults: bool = False
    reducer: str = None


# Between them: serial and parallel, the three impls, 16- and 32-bit
# uplinks, a dropped worker, a no-survivor round, a corrupting fault
# program with the trimmed mean on the flat path, both algorithms.
ROUND_CASES = {
    "proposed-serial-ring": RoundCase("proposed", "ring"),
    "proposed-parallel-pallas-32bit": RoundCase(
        "proposed", "pallas", "parallel", 32),
    "proposed-serial-jnp": RoundCase("proposed", "jnp"),
    "proposed-ring-no-survivor": RoundCase(
        "proposed", "ring", weights=(0.0, 0.0, 0.0)),
    "proposed-pallas-faults-trimmed-mean": RoundCase(
        "proposed", "pallas", weights=(6.0, 6.0, 6.0), faults=True,
        reducer="trimmed_mean"),
    "fedgan-ring": RoundCase("fedgan", "ring"),
    "fedgan-jnp-32bit": RoundCase("fedgan", "jnp", "parallel", 32),
}
ROUND_KEY = jax.random.fold_in(KEY, 5)

PSUM_WEIGHTS = {"dropped": (2.0, 0.0, 3.5), "all": (2.0, 1.0, 3.5),
                "none": (0.0, 0.0, 0.0)}
PSUM_CASES = [(impl, None, w) for impl in ("jnp", "pallas", "ring")
              for w in ("dropped", "none")]
PSUM_CASES += [("pallas", m, "all")
               for m in ("trimmed_mean", "norm_clip", "krum")]
PSUM_IDS = [f"{impl}-{m or 'mean'}-{w}" for impl, m, w in PSUM_CASES]

# driver: the mesh Trainer's ("auto" resolves to "fused"); the stacked
# Trainer it is held to runs the resolved driver.
TRAINER_RUNS = {
    # dropout and stragglers compose with the ring
    "proposed-ring-dropout": dict(
        algorithm="proposed", impl="ring", seed=0, driver="host",
        pcfg=dict(PCFG, scheduler="best_channel", scheduling_ratio=0.5),
        faults=dict(n_devices=K, dropout_prob=0.3, straggler_factor=2.0,
                    seed=1)),
    "fedgan-pallas": dict(algorithm="fedgan", impl="pallas", seed=1,
                          driver="host",
                          pcfg=dict(PCFG, scheduler="round_robin",
                                    scheduling_ratio=0.5), faults=None),
    # the fused driver: fading and dropout from the same slots on every
    # rank, Step 1 on each rank's device
    "proposed-ring-dropout-fused": dict(
        algorithm="proposed", impl="ring", seed=0, driver="auto",
        pcfg=dict(PCFG, scheduler="best_channel", scheduling_ratio=0.5),
        faults=dict(n_devices=K, dropout_prob=0.3, straggler_factor=2.0,
                    seed=1)),
}


def _jax_state(algorithm, faulty):
    jpcfg = JaxProtocolConfig(**PCFG)
    make = (jfedgan.make_fedgan_state if algorithm == "fedgan"
            else jprotocol.make_train_state)
    st = make(KEY, lambda k: jdcgan.gan_init(k, JCFG), jpcfg, K)
    if faulty:
        st = jfaults.attach_fault_state(
            st, jfaults.FaultConfig(**FAULTS),
            jshard.FEDGAN_PAYLOAD if algorithm == "fedgan"
            else jshard.PROPOSED_PAYLOAD)
    return st


def _n_params(algorithm):
    st = _jax_state(algorithm, False)
    parts = ("disc", "gen") if algorithm == "fedgan" else ("disc",)
    return sum(jprotocol.count_params(st[p]) for p in parts)


def _case_pcfg(case):
    return dict(PCFG, schedule=case.schedule, quantize_bits=case.bits)


def _draws(case):
    tpcfg = ProtocolConfig(**_case_pcfg(case))
    if case.faults:
        maker = FaultJaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL,
                              _n_params(case.algorithm),
                              faults.FaultConfig(**FAULTS))
    else:
        maker = JaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL,
                         _n_params(case.algorithm))
    draws = maker.for_key(ROUND_KEY)
    return {f.name: (getattr(draws, f.name).numpy()
                     if torch.is_tensor(getattr(draws, f.name))
                     else getattr(draws, f.name))
            for f in dataclasses.fields(draws)}


@functools.cache
def jax_mesh_round(name):
    """The JAX package's slice round of the case under vmap: (new state
    with every entry stacked over the K slices, metrics per slice)."""
    case = ROUND_CASES[name]
    fedgan = case.algorithm == "fedgan"
    jstate = _jax_state(case.algorithm, case.faults)
    keys = jshard.FEDGAN_STACKED_KEYS if fedgan else jshard.PROPOSED_STACKED_KEYS
    rep = {k: v for k, v in jstate.items() if k not in keys}
    body = functools.partial(
        jshard._fedgan_slice_round if fedgan else jshard._proposed_slice_round,
        jspecs.make_dcgan_spec(JCFG), JaxProtocolConfig(**_case_pcfg(case)),
        "data", jfaults.FaultConfig(**FAULTS) if case.faults else None,
        JaxRobustConfig(method=case.reducer) if case.reducer else None,
        case.impl, None)

    def slice_round(stacked, data_k, w_k):
        my = jax.lax.axis_index("data")
        weights = jax.lax.all_gather(w_k, "data")
        wsum = jax.lax.psum(w_k.astype(jnp.float32), "data")
        return body(my, {**rep, **stacked}, data_k, w_k, weights, wsum,
                    ROUND_KEY)

    out = jax.vmap(slice_round, axis_name="data")(
        {k: jstate[k] for k in keys}, jnp.asarray(_data()),
        jnp.asarray(case.weights, jnp.float32))
    return jax.device_get(out)


# ---------------------------------------------------------------------------
# The one spawn
# ---------------------------------------------------------------------------

def _psum_tree():
    rng = np.random.default_rng(7)
    return {"a": rng.standard_normal((K, 2049)).astype(np.float32),
            "b": [rng.standard_normal((K, 3, 5)).astype(np.float32),
                  rng.standard_normal((K, 7)).astype(np.float32) * 5]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{part: [[case 0 on rank 0, on rank 1, on rank 2], [case 1 ...],
    ...]} for every port computation of this module, from one spawn of K
    gloo ranks."""
    states = {alg: jax.device_get(_jax_state(alg, False))
              for alg in ("proposed", "fedgan")}
    rounds = [dict(algorithm=c.algorithm, impl=c.impl, pcfg=_case_pcfg(c),
                   w=np.asarray(c.weights, np.float32), draws=_draws(c),
                   faults=FAULTS if c.faults else None,
                   reducer=dict(method=c.reducer) if c.reducer else None)
              for c in ROUND_CASES.values()]
    psum = [(impl, m, np.asarray(PSUM_WEIGHTS[w], np.float32), w == "none")
            for impl, m, w in PSUM_CASES]
    parts = {"psum": ("psum_cases", (_psum_tree(), psum)),
             "rounds": ("round_cases", (SMALL, states, _data(), rounds)),
             "trainers": ("trainer_runs", (SMALL, _data(),
                                           list(TRAINER_RUNS.values())))}
    init = tmp_path_factory.mktemp("mesh") / "init"
    per_rank = mesh.spawn(functools.partial(torch_mesh_ranks.suite, parts),
                          K, device="cpu", init_method=f"file://{init}",
                          timeout_s=TIMEOUT_S)
    return {part: [list(case) for case in zip(*(r[part] for r in per_rank))]
            for part in parts}


# ---------------------------------------------------------------------------
# weighted_average_psum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,method,w", PSUM_CASES, ids=PSUM_IDS)
def test_weighted_average_psum_matches_stacked(ranks, impl, method, w):
    """Every impl on every rank equals the port's stacked
    `weighted_average` (one wavg or robust reduction of the same (K, N)
    payload) to f32 round-off; zero total weight keeps the fallback."""
    i = PSUM_CASES.index((impl, method, w))
    stacked = interop.to_torch(_psum_tree(), "cpu")
    weights = torch.tensor(PSUM_WEIGHTS[w])
    want = weighted_average(
        stacked, weights, robust=RobustConfig(method=method) if method
        else None, fallback=interop.to_torch(
            jax.tree.map(lambda x: np.ones(x.shape[1:], x.dtype),
                         _psum_tree()), "cpu"))
    for r, got in enumerate(ranks["psum"][i]):
        got = interop.to_torch(got, "cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6,
                                       msg=f"rank {r}")


def test_ring_refuses_robust_reducers():
    with pytest.raises(ValueError, match="does not compose with robust"):
        weighted_average_psum({"a": torch.zeros(3)}, torch.tensor(1.0),
                              impl="ring",
                              robust=RobustConfig(method="trimmed_mean"))


# ---------------------------------------------------------------------------
# Mesh rounds against the JAX package's slice rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_mesh_round_matches_jax_slice_round(ranks, name):
    """Rank r's state and metrics against JAX slice r: the globals (the
    uploaded nets to one quantization step, the protocol's generator to
    round-off), the rank's own optimizer states, the metrics; the globals
    agree across ranks."""
    case = ROUND_CASES[name]
    i = list(ROUND_CASES).index(name)
    jst, jm = jax_mesh_round(name)
    fedgan = case.algorithm == "fedgan"
    quantized = ("gen", "disc") if fedgan else ("disc",)
    for r, (st, metrics) in enumerate(ranks["rounds"][i]):
        for part in ("gen", "disc"):
            want = jax.tree.map(lambda x: x[r], jst[part])
            if part in quantized and case.bits < 32:
                quant_step_close(interop.to_torch(st[part], "cpu"), want,
                                 atol=1e-6)
            else:
                for a, b in zip(tree_leaves(interop.to_torch(st[part],
                                                             "cpu")),
                                jax.tree_util.tree_leaves(want)):
                    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                               atol=1e-5)
        for part in (("gen_opt", "disc_opt") if fedgan else ("disc_opt",)):
            for a, b in zip(tree_leaves(interop.to_torch(st[part], "cpu")),
                            jax.tree_util.tree_leaves(jst[part])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b)[r],
                                           rtol=0, atol=1e-5)
        assert set(metrics) == set(jm) == set(
            shard_round.FEDGAN_METRICS if fedgan
            else shard_round.PROPOSED_METRICS)
        for key, value in metrics.items():
            np.testing.assert_allclose(value, float(jm[key][r]), rtol=0,
                                       atol=1e-5)
        if r:
            first = interop.to_torch(ranks["rounds"][i][0][0], "cpu")
            for part in ("gen", "disc"):
                for a, b in zip(tree_leaves(interop.to_torch(st[part],
                                                             "cpu")),
                                tree_leaves(first[part])):
                    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    if case.weights == (0.0, 0.0, 0.0):           # no survivor: frozen
        start = _jax_state(case.algorithm, False)
        for a, b in zip(tree_leaves(interop.to_torch(
                ranks["rounds"][i][0][0]["disc"], "cpu")),
                jax.tree_util.tree_leaves(start["disc"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Trainer(layout="mesh") against Trainer(layout="stacked")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_mesh_trainer_matches_stacked_trainer(ranks, name):
    """2 rounds: masks, weights and the wallclock bit for bit on every rank
    and as the stacked Trainer's with the same seed and driver; metrics
    and globals to round-off (one quantization step where a rounding
    flips). On the flat path every rank reduces the same gathered
    payload, so the ranks agree bit for bit; the ring accumulates in
    each rank's hop order, so there they agree to f32 round-off."""
    run = TRAINER_RUNS[name]
    stacked = Trainer(tspecs.make_dcgan_spec(TCFG),
                      ProtocolConfig(**run["pcfg"]),
                      lambda g: tdcgan.gan_init(g, TCFG), _data(),
                      seed=run["seed"], algorithm=run["algorithm"],
                      faults=faults.FaultConfig(**run["faults"])
                      if run["faults"] else None, driver=run["driver"],
                      device="cpu")
    want = stacked.run(2)
    i = list(TRAINER_RUNS).index(name)
    exact = run["impl"] != "ring"
    per_rank = ranks["trainers"][i]
    assert any(not rec.mask.all() for rec in want)    # a worker sat out
    for r, (hist, state, driver) in enumerate(per_rank):
        assert driver == stacked.driver
        for rec, (mask, weights, metrics, wall, cum) in zip(want, hist):
            np.testing.assert_array_equal(mask, rec.mask)
            np.testing.assert_array_equal(weights, rec.weights)
            assert (wall, cum) == (rec.wallclock_s, rec.cumulative_s)
            assert metrics.keys() == rec.metrics.keys()
            for key, value in rec.metrics.items():
                np.testing.assert_allclose(metrics[key], value, rtol=0,
                                           atol=1e-5)
        state = interop.to_torch(state, "cpu")
        for part in ("gen", "disc"):
            if part == "disc" or run["algorithm"] == "fedgan":
                quant_step_close(state[part], interop.to_numpy(
                    stacked.state[part]), atol=1e-6)
            else:
                for a, b in zip(tree_leaves(state[part]),
                                tree_leaves(stacked.state[part])):
                    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        first_hist, first_state, _ = per_rank[0]
        for (_, _, m, _, _), (_, _, m0, _, _) in zip(hist, first_hist):
            for key in m:
                if exact:
                    assert m[key] == m0[key]
                else:
                    np.testing.assert_allclose(m[key], m0[key], rtol=1e-6,
                                               atol=1e-6)
        own = (("gen_opt", "disc_opt") if run["algorithm"] == "fedgan"
               else ("disc_opt",))
        for part in own:                  # the rank's own optimizer states
            for a, b in zip(tree_leaves(state[part]),
                            tree_leaves(stacked.state[part])):
                torch.testing.assert_close(a, b[r], rtol=0, atol=1e-5)
        shared = [part for part in state if part not in own]
        for a, b in zip(tree_leaves({p: state[p] for p in shared}),
                        tree_leaves({p: interop.to_torch(first_state[p],
                                                         "cpu")
                                     for p in shared})):
            if exact:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(faults=faults.FaultConfig(n_devices=K, n_byzantine=1)),
     "upload-corrupting"),
    (dict(faults=faults.FaultConfig(n_devices=K, n_free_riders=1)),
     "upload-corrupting"),
    (dict(robust=RobustConfig()), "robust reducers"),
    (dict(tp=2), "tensor parallelism"),
], ids=["byzantine", "free_riders", "robust", "tp2"])
def test_check_ring_support_refuses_as_jax(kw, match):
    """The same contract and messages as the JAX package's."""
    args = {"tp": 1, "faults": None, "robust": None, **kw}
    with pytest.raises(NotImplementedError, match=match) as port:
        shard_round.check_ring_support("ring", args["tp"], args["faults"],
                                       args["robust"])
    jfaults_cfg = (jfaults.FaultConfig(**dataclasses.asdict(args["faults"]))
                   if args["faults"] else None)
    with pytest.raises(NotImplementedError) as ref:
        jshard.check_ring_support(
            "ring", ("data",), "model" if args["tp"] > 1 else None,
            args["tp"], jfaults_cfg,
            JaxRobustConfig() if args["robust"] else None)
    assert str(port.value) == str(ref.value)
    # dropout and stragglers compose; the flat impls take everything
    shard_round.check_ring_support(
        "ring", 1, faults.FaultConfig(n_devices=K, dropout_prob=0.5,
                                      straggler_factor=2.0), None)
    shard_round.check_ring_support("pallas", 2, args["faults"],
                                   args["robust"])


def test_check_faults_tp_refuses_as_jax():
    for kw in (dict(faults=faults.FaultConfig(n_devices=K)),
               dict(robust=RobustConfig())):
        args = {"faults": None, "robust": None, **kw}
        with pytest.raises(NotImplementedError) as port:
            shard_round.check_faults_tp(args["faults"], args["robust"], 2)
        with pytest.raises(NotImplementedError) as ref:
            jshard.check_faults_tp(
                jfaults.FaultConfig(n_devices=K) if args["faults"] else None,
                JaxRobustConfig() if args["robust"] else None, "model", 2)
        assert str(port.value) == str(ref.value)
        shard_round.check_faults_tp(args["faults"], args["robust"], 1)


@pytest.mark.parametrize("kw,error,match", [
    (dict(avg_impl="ring"), ValueError, "selects the mesh layout"),
    (dict(avg_impl="jnp"), ValueError, "selects the mesh layout"),
    (dict(avg_impl="psum"), ValueError, "unknown avg_impl"),
    (dict(layout="mesh", avg_impl="psum"), ValueError, "unknown avg_impl"),
    (dict(layout="mesh", avg_impl="ring", reducer="trimmed_mean"),
     NotImplementedError, "robust reducers"),
    (dict(layout="mesh"), RuntimeError, "process group"),
], ids=["ring_on_stacked", "jnp_on_stacked", "unknown", "unknown_on_mesh",
        "ring_with_robust", "mesh_without_a_group"])
def test_trainer_checks_avg_impl_and_the_group(kw, error, match):
    with pytest.raises(error, match=match):
        Trainer(tspecs.make_dcgan_spec(TCFG), ProtocolConfig(**PCFG),
                lambda g: tdcgan.gan_init(g, TCFG), _data(), device="cpu",
                **kw)


def test_spawn_reraises_a_rank_failure(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        mesh.spawn(torch_mesh_ranks.failing, 2, device="cpu",
                   init_method=f"file://{tmp_path / 'init'}", timeout_s=60)
    assert "rank 1 gives up" in str(err.value)
    assert "Traceback" in str(err.value)


def test_spawn_backend_checks():
    with pytest.raises(ValueError, match="runs on CUDA"):
        mesh.spawn(torch_mesh_ranks.failing, 2, device="cpu",
                   backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.spawn(torch_mesh_ranks.failing, 2)
