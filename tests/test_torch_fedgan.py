"""Port parity: the FedGAN baseline (`repro_torch.core.fedgan`) against the
JAX package's `repro.core.fedgan`, with and without hostile workers and
a robust reducer, round by round and through the host-driver Trainer.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import faults as jfaults
from repro.core import fedgan as jfedgan
from repro.core import protocol as jprotocol
from repro.kernels.robust_avg.ops import RobustConfig as JaxRobustConfig
from repro.models import dcgan as jdcgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.core import faults, fedgan, protocol
from repro_torch.kernels.robust_avg import ops as robust_ops
from repro_torch.kernels.robust_avg.ops import RobustConfig
from repro_torch.kernels.wavg import ops as wavg_ops
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
from test_torch_faults import (FAULTS, K, N_LOCAL, FaultJaxDraws, _data,
                               check_trainer_matches_jax)
from test_torch_protocol import (JCFG, KEY, TCFG, JaxDraws, _configs,
                                 quant_step_close)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@functools.cache
def _jax_round(jpcfg, faulty, reducer):
    spec = jspecs.make_dcgan_spec(JCFG)
    jcfg = jfaults.FaultConfig(**FAULTS) if faulty else None
    red = None if reducer is None else JaxRobustConfig(method=reducer,
                                                       trim=1)
    return jax.jit(lambda s, d, w, k: jfedgan.fedgan_round(
        spec, jpcfg, s, d, w, k, faults=jcfg, reducer=red))


def _states(jpcfg, faulty):
    jstate = jfedgan.make_fedgan_state(
        KEY, lambda k: jdcgan.gan_init(k, JCFG), jpcfg, K)
    if faulty:
        jstate = jfaults.attach_fault_state(
            jstate, jfaults.FaultConfig(**FAULTS),
            lambda s: {"gen": s["gen"], "disc": s["disc"]})
    return jstate, interop.to_torch(jax.device_get(jstate), "cpu")


@pytest.mark.parametrize("case", ["plain", "faults_trimmed_mean"])
def test_fedgan_round_matches_jax(case):
    """2 rounds, the JAX draws injected: without a reducer (two plain
    averages), and under a fault program with the trimmed mean (one
    reduction of the combined payload). Parameters agree to round-off or
    one 16-bit step (equal weights: the trimmed mean's order statistics
    move by at most the perturbation)."""
    faulty = case != "plain"
    reducer = "trimmed_mean" if faulty else None
    jpcfg, tpcfg = _configs(n_devices=K, optimizer="adam")
    jstate, tstate = _states(jpcfg, faulty)
    n_params = protocol.count_params({"gen": tstate["gen"],
                                      "disc": tstate["disc"]})
    cfg = faults.FaultConfig(**FAULTS) if faulty else None
    draws = (FaultJaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_params, cfg)
             if faulty else JaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_params))
    spec = tspecs.make_dcgan_spec(TCFG)
    data = _data()
    red = None if reducer is None else RobustConfig(method=reducer, trim=1)
    for r, w in enumerate([[6.0] * K, [0, 6.0, 6.0, 0, 6.0, 6.0]]):
        w = np.asarray(w, np.float32)
        round_key = jax.random.fold_in(KEY, r)
        jstate, jm = _jax_round(jpcfg, faulty, reducer)(
            jstate, jnp.asarray(data), jnp.asarray(w), round_key)
        tstate, tm = fedgan.fedgan_round(
            spec, tpcfg, tstate, torch.from_numpy(data), torch.from_numpy(w),
            draws.for_key(round_key), faults=cfg, reducer=red)
        assert tm.keys() == jm.keys() == {"participation"}
        assert float(tm["participation"]) == float(jm["participation"])
    assert set(tstate) == set(jstate)
    quant_step_close(tstate["disc"], jstate["disc"], atol=1e-6)
    quant_step_close(tstate["gen"], jstate["gen"], atol=1e-6)
    for part in ("gen_opt", "disc_opt"):
        for x, y in zip(tree_leaves(tstate[part]),
                        jax.tree_util.tree_leaves(jstate[part])):
            assert tuple(x.shape) == np.shape(y)
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=1e-5)
    if faulty:
        quant_step_close(tstate["fault"]["stale"], jstate["fault"]["stale"],
                         atol=1e-6)


def test_fedgan_trainer_with_faults_matches_jax_host_driver():
    ttr = check_trainer_matches_jax("fedgan")
    assert set(ttr.state["fault"]["stale"]) == {"gen", "disc"}


def test_make_fedgan_state_and_uplink_bits_match_jax():
    jpcfg, tpcfg = _configs(n_devices=K, optimizer="adam")
    jstate = jfedgan.make_fedgan_state(
        KEY, lambda k: jdcgan.gan_init(k, JCFG), jpcfg, K)
    params = jax.device_get({"gen": jstate["gen"], "disc": jstate["disc"]})
    tstate = fedgan.make_fedgan_state(
        lambda g: interop.to_torch(params, "cpu"), tpcfg, K, device="cpu")
    assert (jax.tree_util.tree_structure(interop.to_numpy(tstate))
            == jax.tree_util.tree_structure(jax.device_get(jstate)))
    for x, y in zip(tree_leaves(tstate), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for flag in (False, True):
        assert protocol.uplink_payload_bits(tstate, tpcfg, fedgan=flag) == \
            jprotocol.uplink_payload_bits(jstate, jpcfg, fedgan=flag)


@pytest.mark.parametrize("algorithm,reducer,calls", [
    ("proposed", None, (1, 0)), ("proposed", "trimmed_mean", (0, 1)),
    ("proposed", "krum", (1, 0)), ("fedgan", None, (2, 0)),
    ("fedgan", "trimmed_mean", (0, 1)), ("fedgan", "norm_clip", (1, 0))],
    ids=["proposed-mean", "proposed-trimmed_mean", "proposed-krum",
         "fedgan-mean", "fedgan-trimmed_mean", "fedgan-norm_clip"])
def test_a_round_calls_each_kernel_wrapper_as_the_jax_one(
        monkeypatch, algorithm, reducer, calls):
    """Calls of the two kernel wrappers (wavg, trimmed_wavg) in a round;
    on a CUDA tensor each call is one kernel launch. A reducer reduces
    the (K, N) payload once (FedGAN's combined payload too): trimmed_mean
    in trimmed_wavg, norm_clip and krum in wavg. Without one each net
    is averaged by wavg (FedGAN: two calls)."""
    seen = {"wavg": 0, "trimmed": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            seen[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(wavg_ops, "weighted_average",
                        counted("wavg", wavg_ops.weighted_average))
    monkeypatch.setattr(robust_ops, "trimmed_average",
                        counted("trimmed", robust_ops.trimmed_average))
    _, tpcfg = _configs(n_devices=K, n_d=1, n_g=1)
    spec = tspecs.make_dcgan_spec(TCFG)
    cfg = faults.FaultConfig(**FAULTS)
    state = (fedgan.make_fedgan_state if algorithm == "fedgan"
             else protocol.make_train_state)(
        lambda g: tdcgan.gan_init(g, TCFG), tpcfg, K, device="cpu")
    n_params = protocol.count_params(
        {"gen": state["gen"], "disc": state["disc"]}
        if algorithm == "fedgan" else state["disc"])
    draws = protocol.DrawSampler(spec, tpcfg, seed=0, n_local=N_LOCAL,
                                 n_params=n_params, device="cpu",
                                 faults=cfg)(0)
    round_fn = (fedgan.fedgan_round if algorithm == "fedgan"
                else protocol.gan_round)
    red = None if reducer is None else RobustConfig(method=reducer)
    new_state, _ = round_fn(spec, tpcfg, state, torch.from_numpy(_data()),
                            torch.full((K,), 6.0), draws, faults=cfg,
                            reducer=red)
    assert (seen["wavg"], seen["trimmed"]) == calls
    for x in tree_leaves({"gen": new_state["gen"],
                          "disc": new_state["disc"]}):
        assert bool(torch.isfinite(x).all())
