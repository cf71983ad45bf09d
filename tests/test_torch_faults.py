"""Port parity: the hostile-worker regime (fault programs, corrupted
uploads, robust Algorithm 2 in the round and the Trainer) against the
JAX package.

`FaultJaxDraws` extends `JaxDraws` with the JAX round's fault draws: the
dropout uniforms behind `FaultProgram.dropout_mask` and the byzantine
devices' normals (`jax.random.normal(byz_key(round_key, k), (N,))`), so
both packages corrupt the same uploads.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import faults as jfaults
from repro.core import protocol as jprotocol
from repro.core import quantize as jquant
from repro.core.engine import Trainer as JaxTrainer
from repro.kernels.robust_avg.ops import RobustConfig as JaxRobustConfig
from repro.models import dcgan as jdcgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.core import Trainer, faults, protocol, quantize
from repro_torch.kernels.robust_avg.ops import RobustConfig
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
from test_torch_protocol import (JCFG, KEY, TCFG, JaxDraws, _configs,
                                 quant_step_close)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, N_LOCAL = 6, 8
FAULTS = dict(n_devices=K, dropout_prob=0.25, n_free_riders=1,
              n_byzantine=1, straggler_factor=2.0, seed=3)


class FaultJaxDraws(JaxDraws):
    """`JaxDraws` plus the JAX fault program's draws for the round."""

    def __init__(self, key, pcfg, nz, n_local, n_params, fault_cfg,
                 device="cpu"):
        super().__init__(key, pcfg, nz, n_local, n_params, device)
        self.fault_cfg = fault_cfg

    def for_key(self, round_key):
        draws = super().for_key(round_key)
        return protocol.RoundDraws(
            draws.z_dev, draws.z_srv, draws.idx, draws.quant_u,
            *fault_draws(self.fault_cfg, round_key, self.n_params,
                         self.device))


def fault_draws(cfg, round_key, n_params, device="cpu"):
    """(drop_u, byz_normals) of the JAX round keyed `round_key`."""
    drop_u = np.asarray(jax.random.uniform(
        jax.random.fold_in(round_key, jfaults._SALT_DROP), (cfg.n_devices,)))
    byz = jfaults.fault_program(jfaults.FaultConfig(
        **dataclasses.asdict(cfg))).byzantine_np
    normals = [np.asarray(jax.random.normal(jfaults.byz_key(round_key, k),
                                            (n_params,)))
               for k in np.flatnonzero(byz)]
    byz_normals = (torch.tensor(np.stack(normals), device=device)
                   if normals else None)
    return drop_u, byz_normals


def _data(k=K, seed=1):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal(
        (k, N_LOCAL, 16, 16, 1))).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(n_devices=6, n_free_riders=1, n_byzantine=1, seed=3),
    dict(n_devices=10, n_free_riders=2, n_byzantine=2, straggler_factor=2.0,
         seed=0),
    dict(n_devices=5, n_byzantine=5, straggler_factor=3.5, seed=7),
    dict(n_devices=8, n_free_riders=3, straggler_factor=1.5, seed=11),
    dict(n_devices=4),
], ids=["k6", "k10", "k5_all_byz", "k8_free_riders", "k4_none"])
def test_fault_program_roles_match_jax_bitwise(kw):
    port = faults.FaultProgram(faults.FaultConfig(**kw))
    ref = jfaults.FaultProgram(jfaults.FaultConfig(**kw))
    np.testing.assert_array_equal(port.free_rider_np, ref.free_rider_np)
    np.testing.assert_array_equal(port.byzantine_np, ref.byzantine_np)
    np.testing.assert_array_equal(port.compute_mult_np, ref.compute_mult_np)
    assert port.compute_mult_np.dtype == ref.compute_mult_np.dtype
    assert not (port.free_rider_np & port.byzantine_np).any()
    assert port.corrupts == ref.corrupts


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_dropout_mask_matches_jax_bitwise(p):
    cfg = dict(n_devices=7, dropout_prob=p)
    port = faults.fault_program(faults.FaultConfig(**cfg))
    ref = jfaults.fault_program(jfaults.FaultConfig(**cfg))
    for t in range(6):
        round_key = jax.random.fold_in(KEY, t)
        drop_u, _ = fault_draws(port.cfg, round_key, 1)
        mask = port.dropout_mask(drop_u if p > 0 else None)
        np.testing.assert_array_equal(mask, ref.dropout_mask_np(round_key))
        assert mask.dtype == bool


def test_fault_config_validates_as_the_jax_one():
    for bad in (dict(dropout_prob=1.5), dict(n_free_riders=-1),
                dict(n_free_riders=3, n_byzantine=2),
                dict(straggler_factor=0.5)):
        for mod in (faults, jfaults):
            with pytest.raises(ValueError):
                mod.FaultConfig(n_devices=4, **bad)
    assert faults.fault_program(None) is None
    cfg = faults.FaultConfig(n_devices=4, n_byzantine=1)
    assert faults.fault_program(cfg) is faults.fault_program(cfg)


def test_uplink_then_corruption_matches_jax_bitwise():
    """The quantized uplink (the integers, then the dequantized values)
    and the corruption after it: free-riders get the UNQUANTIZED stale
    global, byzantine devices scaled noise. The payload is FedGAN's
    combined {"gen", "disc"} tree ("disc" first in leaf order), so it
    holds the proposed framework's disc payload too."""
    cfg = faults.FaultConfig(n_devices=K, n_free_riders=2, n_byzantine=2,
                             byz_scale=10.0, seed=1)
    jprog = jfaults.fault_program(jfaults.FaultConfig(
        **dataclasses.asdict(cfg)))
    rng = np.random.default_rng(0)
    one = {"disc": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal(5).astype(np.float32)},
           "gen": [rng.standard_normal((2, 2)).astype(np.float32)]}
    stacked = jax.tree.map(lambda v: (v[None] * rng.uniform(
        0.5, 2.0, (K,) + (1,) * v.ndim)).astype(np.float32), one)
    n = sum(v.size for v in jax.tree_util.tree_leaves(one))
    round_key = jax.random.fold_in(KEY, 5)

    quant_u = np.stack([np.asarray(jax.random.uniform(
        jquant.device_uplink_key(round_key, k), (n,))) for k in range(K)])
    for k in range(K):
        q, _ = quantize.quantize_tree(torch.from_numpy(quant_u[k]),
                                      interop.to_torch(jax.tree.map(
                                          lambda v: v[k], stacked), "cpu"))
        jq, _ = jquant.quantize_tree(
            jquant.device_uplink_key(round_key, k),
            jax.tree.map(lambda v: jnp.asarray(v[k]), stacked))
        for a, b in zip(tree_leaves(q), jax.tree_util.tree_leaves(jq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jout = jquant.roundtrip_stacked(round_key, jax.tree.map(jnp.asarray,
                                                            stacked))
    jout = jfaults.corrupt_uploads_stacked(jprog, round_key, jout,
                                           stale=jax.tree.map(jnp.asarray,
                                                              one))
    _, byz_normals = fault_draws(cfg, round_key, n)
    out = quantize.roundtrip_stacked(torch.from_numpy(quant_u),
                                     interop.to_torch(stacked, "cpu"))
    out = faults.corrupt_upload(faults.fault_program(cfg), out, byz_normals,
                                stale=interop.to_torch(one, "cpu"))
    for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(jout)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fr = np.flatnonzero(jprog.free_rider_np)
    for a, s in zip(tree_leaves(out), jax.tree_util.tree_leaves(one)):
        np.testing.assert_array_equal(a.numpy()[fr], np.stack([s] * 2))


def test_corrupt_upload_rejects_missing_byzantine_draws():
    prog = faults.fault_program(faults.FaultConfig(n_devices=3,
                                                   n_byzantine=1))
    payload = {"w": torch.zeros(3, 4)}
    with pytest.raises(ValueError, match="normals"):
        faults.corrupt_upload(prog, payload, None)
    with pytest.raises(ValueError, match="normals"):
        faults.corrupt_upload(prog, payload, torch.zeros(1, 5))


def test_draw_sampler_fault_draws_are_seeded():
    """Dropout uniforms are a host numpy array, byzantine normals one row
    per byzantine device on the round's device; the same seed repeats
    them, another round does not."""
    _, pcfg = _configs(n_devices=K)
    cfg = faults.FaultConfig(**FAULTS)
    spec = tspecs.make_dcgan_spec(TCFG)
    make = lambda: protocol.DrawSampler(spec, pcfg, seed=5, n_local=N_LOCAL,
                                        n_params=100, device="cpu",
                                        faults=cfg)
    d0, again = make()(0), make()(0)
    assert isinstance(d0.drop_u, np.ndarray) and d0.drop_u.shape == (K,)
    assert d0.byz_normals.shape == (1, 100)
    np.testing.assert_array_equal(d0.drop_u, again.drop_u)
    torch.testing.assert_close(d0.byz_normals, again.byz_normals, rtol=0,
                               atol=0)
    d1 = make()(1)
    assert not np.array_equal(d1.drop_u, d0.drop_u)
    plain = protocol.DrawSampler(spec, pcfg, seed=5, n_local=N_LOCAL,
                                 n_params=100, device="cpu")(0)
    assert plain.drop_u is None and plain.byz_normals is None
    torch.testing.assert_close(plain.quant_u, d0.quant_u, rtol=0, atol=0)


@functools.cache
def _jax_round(jpcfg, reducer):
    spec = jspecs.make_dcgan_spec(JCFG)
    jcfg = jfaults.FaultConfig(**FAULTS)
    red = JaxRobustConfig(method=reducer, trim=1, krum_f=1)
    return jax.jit(lambda s, d, w, k: jprotocol.gan_round(
        spec, jpcfg, s, d, w, k, faults=jcfg, reducer=red))


@pytest.mark.parametrize("reducer", ["trimmed_mean", "norm_clip", "krum"])
@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_gan_round_with_faults_matches_jax(schedule, reducer):
    """2 rounds under a fault program (one free-rider, one byzantine
    device), the JAX draws injected. Parameters agree to round-off or to
    one 16-bit step where a stochastic rounding flips; that bound holds
    through the trimmed mean too: the weights are all equal (m_k = m), so
    an order statistic moves by at most the perturbation of its row."""
    jpcfg, tpcfg = _configs(n_devices=K, schedule=schedule,
                            optimizer="adam")
    jstate = jprotocol.make_train_state(
        KEY, lambda k: jdcgan.gan_init(k, JCFG), jpcfg, K)
    jstate = jfaults.attach_fault_state(jstate, jfaults.FaultConfig(**FAULTS),
                                        lambda s: s["disc"])
    tstate = interop.to_torch(jax.device_get(jstate), "cpu")
    n_params = protocol.count_params(tstate["disc"])
    cfg = faults.FaultConfig(**FAULTS)
    draws = FaultJaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_params, cfg)
    spec = tspecs.make_dcgan_spec(TCFG)
    data = _data()
    red = RobustConfig(method=reducer, trim=1, krum_f=1)
    for r, w in enumerate([[6.0] * K, [6.0, 0, 6.0, 6.0, 0, 6.0]]):
        w = np.asarray(w, np.float32)
        round_key = jax.random.fold_in(KEY, r)
        jstate, jm = _jax_round(jpcfg, reducer)(
            jstate, jnp.asarray(data), jnp.asarray(w), round_key)
        tstate, tm = protocol.gan_round(
            spec, tpcfg, tstate, torch.from_numpy(data), torch.from_numpy(w),
            draws.for_key(round_key), faults=cfg, reducer=red)
        for name in ("disc_objective", "gen_objective", "participation"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=0, atol=1e-5)
    quant_step_close(tstate["disc"], jstate["disc"], atol=1e-6)
    quant_step_close(tstate["gen"], jstate["gen"], atol=1e-6)
    quant_step_close(tstate["fault"]["stale"], jstate["fault"]["stale"],
                     atol=1e-6)


def _jax_trainer_and_params(jpcfg, algorithm, data, reducer):
    jtr = JaxTrainer(jspecs.make_dcgan_spec(JCFG), jpcfg,
                     lambda k: jdcgan.gan_init(k, JCFG), jnp.asarray(data),
                     KEY, algorithm=algorithm, driver="host",
                     faults=jfaults.FaultConfig(**FAULTS), reducer=reducer)
    params = jax.device_get({"gen": jtr.state["gen"],
                             "disc": jtr.state["disc"]})
    return jtr, params


def check_trainer_matches_jax(algorithm):
    """3 host-driver rounds under faults and the trimmed mean: masks,
    weights and the wallclock bit for bit, the rest to round-off."""
    jpcfg, tpcfg = _configs(n_devices=K, optimizer="adam")
    data = _data()
    jtr, params = _jax_trainer_and_params(jpcfg, algorithm, data,
                                          "trimmed_mean")
    n_params = sum(protocol.count_params(interop.to_torch(params[part],
                                                          "cpu"))
                   for part in (("disc", "gen") if algorithm == "fedgan"
                                else ("disc",)))
    cfg = faults.FaultConfig(**FAULTS)
    ttr = Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                  lambda g: interop.to_torch(params, "cpu"), data,
                  algorithm=algorithm, faults=cfg, reducer="trimmed_mean",
                  sampler=FaultJaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL,
                                        n_params, cfg),
                  driver="host", device="cpu")
    jhist, thist = jtr.run(3), ttr.run(3)
    dropped = 0
    for jr, tr in zip(jhist, thist):
        np.testing.assert_array_equal(tr.mask, jr.mask)
        np.testing.assert_array_equal(
            tr.weights, np.where(jr.mask, np.float32(tpcfg.sample_size),
                                 np.float32(0)))
        assert tr.wallclock_s == jr.wallclock_s
        assert tr.cumulative_s == jr.cumulative_s
        assert tr.metrics.keys() == jr.metrics.keys()
        for name, value in jr.metrics.items():
            np.testing.assert_allclose(tr.metrics[name], value, rtol=0,
                                       atol=1e-5)
        dropped += int((~tr.mask).sum())
    assert dropped > 0                     # dropout acted in these rounds
    quant_step_close(ttr.state["disc"], jtr.state["disc"], atol=1e-6)
    quant_step_close(ttr.state["gen"], jtr.state["gen"], atol=1e-6)
    return ttr


def test_trainer_with_faults_matches_jax_host_driver():
    ttr = check_trainer_matches_jax("proposed")
    assert set(ttr.state) == {"gen", "disc", "gen_opt", "disc_opt", "fault"}


@pytest.mark.parametrize("reducer", ["mean", "trimmed_mean", "norm_clip",
                                     "krum"])
@pytest.mark.parametrize("algorithm", ["proposed", "fedgan"])
def test_no_survivor_rounds_keep_the_globals_bitwise(algorithm, reducer):
    """dropout_prob=1.0: every round drops every device, so the global
    discriminator (and FedGAN's generator) never changes."""
    _, tpcfg = _configs(n_devices=K, optimizer="adam")
    cfg = faults.FaultConfig(**dict(FAULTS, dropout_prob=1.0))
    tr = Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                 lambda g: tdcgan.gan_init(g, TCFG), _data(), seed=2,
                 algorithm=algorithm, faults=cfg, reducer=reducer,
                 device="cpu")
    frozen = ("gen", "disc") if algorithm == "fedgan" else ("disc",)
    before = {part: [x.clone() for x in tree_leaves(tr.state[part])]
              for part in frozen}
    hist = tr.run(2)
    for part in frozen:
        for a, b in zip(tree_leaves(tr.state[part]), before[part]):
            assert torch.equal(a, b)
    assert all(r.metrics["participation"] == 0.0 and not r.mask.any()
               for r in hist)


@pytest.mark.parametrize("kw,match", [
    (dict(reducer="median"), "unknown robust method"),
    (dict(reducer=3), "reducer must be"),
    (dict(faults="dropout"), "FaultConfig"),
    (dict(faults=faults.FaultConfig(n_devices=K + 1)), "must match"),
], ids=["unknown_method", "not_a_reducer", "not_a_fault_config",
        "fault_devices"])
def test_trainer_checks_faults_and_reducer(kw, match):
    _, tpcfg = _configs(n_devices=K)
    with pytest.raises(ValueError, match=match):
        Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                lambda g: tdcgan.gan_init(g, TCFG), _data(), device="cpu",
                **kw)
