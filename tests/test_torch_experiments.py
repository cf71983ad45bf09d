"""Port parity: the centralized baseline, microbatching, the schedules,
`select_tree` and the paper's experiment harness
(`repro_torch.experiments`), against the JAX package.

Both packages start from the same parameters and take the same draws
(`JaxDraws`): the model math agrees to f32 round-off, and the
scheduling masks and the simulated wallclock bit for bit.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import common as jcommon  # noqa: E402
from repro.core import averaging as javeraging  # noqa: E402
from repro.core import protocol as jprotocol  # noqa: E402
from repro.core.channel import ChannelConfig as JaxChannelConfig  # noqa: E402
from repro.core.engine import Trainer as JaxTrainer  # noqa: E402
from repro.core.faults import FaultConfig as JaxFaultConfig  # noqa: E402
from repro.models import dcgan as jdcgan  # noqa: E402
from repro.models import specs as jspecs  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import Trainer, faults, protocol  # noqa: E402
from repro_torch.core.averaging import select_tree  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.experiments import common, fig5_fedgan, fig_robust  # noqa: E402
from repro_torch.models import dcgan as tdcgan  # noqa: E402
from repro_torch.models import specs as tspecs  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_checkpoint import (jax_init, level0, port_params,  # noqa: E402
                                   quick_jax_trainer)
from test_torch_protocol import (JCFG, KEY, TCFG, JaxDraws, _configs,  # noqa: E402
                                 quant_step_close)
from torch_threads import one_torch_thread  # noqa: F401,E402 (autouse)

K, N_LOCAL = 3, 8


def _data():
    rng = np.random.default_rng(3)
    return np.tanh(rng.standard_normal(
        (K, N_LOCAL, 16, 16, 1))).astype(np.float32)


def _n_params(tree):
    return sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(tree))


# ---------------------------------------------------------------------------
# The centralized baseline
# ---------------------------------------------------------------------------

def test_centralized_trainer_matches_jax():
    """3 rounds of `Trainer(algorithm="centralized")` in both packages
    from the same parameters and one device's draws over the K shards
    pooled in device order: each round's metrics and the parameters to
    f32 round-off (`protocol.centralized_step` against JAX's), the host
    driver's masks and wallclock curve bit for bit (it still schedules
    and times K devices), participation 1, disc_opt with a leading axis
    of 1."""
    jpcfg, tpcfg = _configs(n_devices=K, optimizer="adam",
                            scheduler="round_robin", scheduling_ratio=0.5)
    data = _data()
    params = port_params(JCFG)
    jtr = quick_jax_trainer(
        jspecs.make_dcgan_spec(JCFG), jpcfg, jax_init(params),
        jnp.asarray(data), KEY, algorithm="centralized",
        channel_cfg=JaxChannelConfig(n_devices=K, fading=False))
    one = dataclasses.replace(tpcfg, n_devices=1)
    ttr = Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                  lambda g: interop.to_torch(params, "cpu"), data, seed=0,
                  algorithm="centralized",
                  sampler=JaxDraws(KEY, one, TCFG.nz, K * N_LOCAL,
                                   _n_params(params["disc"])),
                  channel_cfg=ChannelConfig(n_devices=K, fading=False),
                  device="cpu")
    assert ttr.driver == jtr.driver == "host"
    assert tuple(ttr.data.shape) == (K * N_LOCAL, 16, 16, 1)
    jhist, thist = jtr.run(3), ttr.run(3)
    for jr, tr in zip(jhist, thist):
        np.testing.assert_array_equal(tr.mask, jr.mask)
        assert 0 < tr.mask.sum() < K
        assert (tr.wallclock_s, tr.cumulative_s) == (jr.wallclock_s,
                                                     jr.cumulative_s)
        assert tr.metrics["participation"] == 1.0
        for name, value in jr.metrics.items():
            np.testing.assert_allclose(tr.metrics[name], value, rtol=0,
                                       atol=1e-5)
    for part in ("disc", "gen", "disc_opt", "gen_opt"):
        got, want = tree_leaves(ttr.state[part]), [
            np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.state[part])]
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    assert tree_leaves(ttr.state["disc_opt"])[0].shape[0] == 1


def test_centralized_step_equals_a_k1_round():
    """At quantize_bits=32 (no uplink) the centralized step is a K=1
    round of the protocol on the pooled data."""
    _, pcfg = _configs(n_devices=1, quantize_bits=32, sample_size=4,
                       server_sample_size=4)
    spec = tspecs.make_dcgan_spec(TCFG)
    pooled = torch.from_numpy(_data().reshape((-1, 16, 16, 1)))
    state = protocol.make_train_state(
        lambda g: tdcgan.gan_init(g, TCFG), pcfg, 1, device="cpu")
    draws = protocol.DrawSampler(spec, pcfg, seed=1,
                                 n_local=pooled.shape[0], n_params=0,
                                 device="cpu")(0)
    s_round, _ = protocol.gan_round(spec, pcfg, state, pooled[None],
                                    torch.tensor([4.0]), draws)
    s_cent, m = protocol.centralized_step(spec, pcfg, state, pooled, draws)
    for part in ("gen", "disc", "disc_opt"):
        for a, b in zip(tree_leaves(s_round[part]), tree_leaves(s_cent[part])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert float(m["participation"]) == 1.0


@pytest.mark.parametrize("kw", [
    dict(driver="fused"), dict(layout="mesh"),
    dict(faults="free_rider"), dict(reducer="trimmed_mean")],
    ids=["fused", "mesh", "faults", "reducer"])
def test_centralized_refuses_as_jax(kw):
    """The JAX Trainer's ValueErrors, word for word."""
    jpcfg, tpcfg = _configs(n_devices=K)
    data = _data()
    messages = []
    for make, pkg_faults in (
            (lambda **a: JaxTrainer(jspecs.make_dcgan_spec(JCFG), jpcfg,
                                    jax_init(port_params(JCFG)),
                                    jnp.asarray(data), KEY, **a),
             JaxFaultConfig),
            (lambda **a: Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                                 lambda g: tdcgan.gan_init(g, TCFG), data,
                                 device="cpu", **a),
             faults.FaultConfig)):
        args = dict(kw)
        if "faults" in args:
            args["faults"] = pkg_faults(n_devices=K, n_free_riders=1)
        with pytest.raises(ValueError) as err:
            make(algorithm="centralized", **args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "centralized" in messages[0]


# ---------------------------------------------------------------------------
# Microbatching
# ---------------------------------------------------------------------------

def test_microbatched_round_matches_jax():
    """micro_batch_d=2, micro_batch_g=4 on a DCGAN round (batch-norm
    takes each chunk's statistics, as in JAX), from the same parameters
    and draws: metrics and parameters to f32 round-off (one quantization
    step where a stochastic rounding flips); and not the unbatched
    round."""
    jpcfg, tpcfg = _configs(n_devices=K, sample_size=8,
                            server_sample_size=8, micro_batch_d=2,
                            micro_batch_g=4)
    jstate = jprotocol.make_train_state(KEY, jax_init(port_params(JCFG)),
                                        jpcfg, K)
    tstate = interop.to_torch(jax.device_get(jstate), "cpu")
    draws = JaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL,
                     protocol.count_params(tstate["disc"]))(0)
    data = _data()
    w = np.asarray([8.0, 0.0, 8.0], np.float32)
    spec = jspecs.make_dcgan_spec(JCFG)
    jnew, jm = level0(lambda s, d, w, k: jprotocol.gan_round(
        spec, jpcfg, s, d, w, k))(jstate, jnp.asarray(data), jnp.asarray(w),
                                  jax.random.fold_in(KEY, 0))
    spec = tspecs.make_dcgan_spec(TCFG)
    tnew, tm = protocol.gan_round(spec, tpcfg, tstate,
                                  torch.from_numpy(data),
                                  torch.from_numpy(w), draws)
    for name in ("disc_objective", "gen_objective", "participation"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=0,
                                   atol=1e-5)
    quant_step_close(tnew["disc"], jnew["disc"], atol=1e-6)
    quant_step_close(tnew["gen"], jnew["gen"], atol=1e-6)
    whole = dataclasses.replace(tpcfg, micro_batch_d=None,
                                micro_batch_g=None)
    _, m_whole = protocol.gan_round(spec, whole, tstate,
                                    torch.from_numpy(data),
                                    torch.from_numpy(w), draws)
    assert abs(float(m_whole["gen_objective"])
               - float(tm["gen_objective"])) > 1e-4


def test_microbatch_must_divide_the_batch():
    _, tpcfg = _configs(n_devices=K, micro_batch_d=4)      # of 6
    state = protocol.make_train_state(
        lambda g: tdcgan.gan_init(g, TCFG), tpcfg, K, device="cpu")
    spec = tspecs.make_dcgan_spec(TCFG)
    draws = protocol.DrawSampler(spec, tpcfg, seed=0, n_local=N_LOCAL,
                                 n_params=protocol.count_params(
                                     state["disc"]), device="cpu")(0)
    with pytest.raises(ValueError, match="micro 4 must divide batch 6"):
        protocol.gan_round(spec, tpcfg, state, torch.from_numpy(_data()),
                           torch.full((K,), 6.0), draws)


# ---------------------------------------------------------------------------
# Schedules and select_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine_decay", (1e-3, 100)),
    ("warmup_cosine", (1e-3, 10, 100, 0.05))],
    ids=["constant", "cosine_decay", "warmup_cosine"])
def test_schedules_match_jax(name, args):
    port, ref = getattr(schedules, name)(*args), getattr(jschedules,
                                                          name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = port(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(step)), rtol=1e-6)
    steps = torch.arange(0, 120, 7)
    np.testing.assert_allclose(port(steps).numpy(),
                               np.asarray(ref(jnp.asarray(steps.numpy()))),
                               rtol=1e-6)


def test_select_tree_matches_jax():
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32),
         "b": [rng.standard_normal((4,)).astype(np.float32)]}
    b = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32),
         "b": [rng.standard_normal((4,)).astype(np.float32)]}
    mask = np.array([True, False, False, True])
    got = select_tree(torch.from_numpy(mask), interop.to_torch(a, "cpu"),
                      interop.to_torch(b, "cpu"))
    want = javeraging.select_tree(jnp.asarray(mask), a, b)
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# The experiment harness
# ---------------------------------------------------------------------------

def _timing_only_trainer(*args, **kw):
    """The JAX Trainer with its round's model math left out: the host
    driver's scheduling, channel timing and wallclock, which read only
    the parameter counts, run as they are."""
    tr = JaxTrainer(*args, **kw)
    tr._round = lambda state, data, weights, key: (state, {})
    return tr


def test_run_experiment_wallclock_matches_jax(monkeypatch):
    """`run_experiment` at K=2, 2 rounds, reduced, host driver, fading
    off: the wallclock curve equals `benchmarks.common.run_experiment`'s
    bit for bit. The JAX harness runs its own settings, data, Trainer
    and channel; its model math, which the wallclock does not read, is
    left out (it starts from the port's parameters and skips the round
    and the FID features), since its compiles alone would take a
    minute of CPU."""
    assert not (common.FULL or jcommon.FULL)
    monkeypatch.setattr(jcommon, "dcgan", types.SimpleNamespace(
        gan_init=lambda key, cfg: jax_init(port_params(cfg))(key),
        generator_apply=jdcgan.generator_apply))
    monkeypatch.setattr(jcommon, "make_feature_extractor",
                        lambda channels: lambda imgs: jnp.zeros((2, 1)))
    monkeypatch.setattr(jcommon, "Trainer", _timing_only_trainer)
    kw = dict(k=2, rounds=2, driver="host", channel_kw={"fading": False},
              scheduler="round_robin", ratio=0.5)
    jc = jcommon.run_experiment("celeba/serial", **kw)
    tc = common.run_experiment("celeba/serial", device="cpu", **kw)
    assert tc.rounds == jc.rounds == [0, 1]
    assert tc.wallclock == jc.wallclock
    assert tc.fid == jc.fid == [None, None]


def test_fig4_centralized_setting_runs():
    """Fig. 4's centralized setting: the host driver, FID at its eval
    round."""
    c = common.run_experiment("fig4/centralized", algorithm="centralized",
                              k=2, rounds=common.EVAL_EVERY, device="cpu")
    assert c.fid[:-1] == [None] * (common.EVAL_EVERY - 1)
    assert np.isfinite(common.last_fid(c))
    assert c.wallclock == sorted(c.wallclock) and c.wallclock[0] > 0


def test_entry_points_refuse(tmp_path):
    """The figures refuse a layout the port lacks, and the centralized
    baseline on the mesh layout (as the JAX Trainer); the robustness
    sweep never writes the JAX package's BENCH_robust.json; without a
    card the figures need device='cpu'."""
    with pytest.raises(ValueError, match="layout='grid' is not ported"):
        fig5_fedgan.main(str(tmp_path), layout="grid", device="cpu")
    with pytest.raises(ValueError, match="not supported for algorithm "
                                         "'centralized'"):
        common.run_experiment("x", algorithm="centralized", layout="mesh",
                              device="cpu")
    root_json = os.path.join(os.path.dirname(__file__), "..",
                             "BENCH_robust.json")
    with pytest.raises(SystemExit):
        fig_robust.main(["--smoke", "--json", root_json, "--device", "cpu"])
    assert not os.path.exists(root_json)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            common.run_experiment("x", k=2, rounds=1)
