"""Port parity: the Trainer's host driver, the channel and scheduler
simulator, the synthetic data and FID, against the JAX package.

The port's Trainer runs on the JAX Trainer's own parameters and draws
(`JaxDraws`), so masks, weights and the simulated wallclock match the
JAX host driver bit for bit and the model math to float32 round-off.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import channel as jchannel
from repro.core import scheduling as jscheduling
from repro.core.engine import Trainer as JaxTrainer
from repro.data.partition import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.metrics import fid as jfid
from repro.models import dcgan as jdcgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.core import Trainer, channel, protocol, scheduling
from repro_torch.data.partition import partition as tpartition
from repro_torch.data import synthetic as tsynthetic
from repro_torch.metrics import fid as tfid
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
from test_torch_protocol import (JCFG, KEY, TCFG, JaxDraws, _configs,
                                 quant_step_close)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, N_LOCAL = 4, 8


def _data(k=K):
    rng = np.random.default_rng(1)
    return np.tanh(rng.standard_normal(
        (k, N_LOCAL, 16, 16, 1))).astype(np.float32)


def _jax_fid_weights(channels, feat_dim=64, seed=42):
    """The weights `repro.metrics.fid.make_feature_extractor` draws."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    shapes = [(4, 4, channels, 16), (4, 4, 16, 32), (4, 4, 32, feat_dim)]
    return [np.asarray(jax.random.normal(k, s)) / d
            for k, s, d in zip(ks, shapes, (4.0, 8.0, 16.0))]


@pytest.mark.parametrize("scheduler", ["best_channel", "random"])
def test_trainer_matches_jax_host_driver(scheduler):
    """3 rounds, scheduling half the devices (zero weights); "random"
    also draws from the Trainer's own numpy generator."""
    jpcfg, tpcfg = _configs(n_devices=K, scheduler=scheduler,
                            scheduling_ratio=0.5, optimizer="adam")
    data = _data()
    params = jax.device_get(jdcgan.gan_init(KEY, JCFG))
    z = np.random.default_rng(2).standard_normal((32, JCFG.nz)).astype(
        np.float32)
    jfeat = jfid.make_feature_extractor(JCFG.nc)
    tfeat = tfid.make_feature_extractor(TCFG.nc, device="cpu",
                                        weights=_jax_fid_weights(TCFG.nc))
    real = data.reshape((-1, 16, 16, 1))

    def jax_fid(gen, _key):
        return jfid.fid_score(jfeat(jnp.asarray(real)), jfeat(
            jdcgan.generator_apply(gen, JCFG, jnp.asarray(z))))

    gens = []

    def port_fid(gen, generator):
        gens.append(generator)
        with torch.no_grad():
            fake = tdcgan.generator_apply(gen, TCFG, torch.from_numpy(z))
        return tfid.fid_score(tfeat(torch.from_numpy(real)), tfeat(fake))

    jtr = JaxTrainer(jspecs.make_dcgan_spec(JCFG), jpcfg,
                     lambda k: jdcgan.gan_init(k, JCFG), jnp.asarray(data),
                     KEY, driver="host")
    n_params = sum(int(np.size(x)) for x in
                   jax.tree_util.tree_leaves(params["disc"]))
    ttr = Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                  lambda g: interop.to_torch(params, "cpu"), data, seed=0,
                  sampler=JaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_params),
                  driver="host", device="cpu")
    jhist = jtr.run(3, eval_every=3, fid_fn=jax_fid)
    thist = ttr.run(3, eval_every=3, fid_fn=port_fid)

    for jr, tr in zip(jhist, thist):
        assert tr.round == jr.round
        np.testing.assert_array_equal(tr.mask, jr.mask)
        assert tr.mask.sum() == 2
        np.testing.assert_array_equal(
            tr.weights, np.where(jr.mask, np.float32(tpcfg.sample_size),
                                 np.float32(0)))
        assert tr.weights.dtype == np.float32
        assert tr.wallclock_s == jr.wallclock_s
        assert tr.cumulative_s == jr.cumulative_s
        for name, value in jr.metrics.items():
            np.testing.assert_allclose(tr.metrics[name], value, rtol=0,
                                       atol=1e-5)
        assert (tr.fid is None) == (jr.fid is None)
    assert len(gens) == 1 and isinstance(gens[0], torch.Generator)
    np.testing.assert_allclose(thist[-1].fid, jhist[-1].fid, rtol=1e-4)
    quant_step_close(ttr.state["disc"], jtr.state["disc"], atol=1e-6)
    quant_step_close(ttr.state["gen"], jtr.state["gen"], atol=1e-6)


def test_trainer_default_draws_are_seeded():
    """Without a sampler the Trainer draws from its seed: the same seed
    repeats a run exactly, another seed does not. A flat dataset goes
    through `partition=` first."""
    _, tpcfg = _configs(n_devices=K, n_d=1, n_g=1)
    flat = _data().reshape((-1, 16, 16, 1))

    def run(seed):
        tr = Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                     lambda g: tdcgan.gan_init(g, TCFG), flat, seed=seed,
                     partition="iid", driver="host", device="cpu")
        assert tuple(tr.data.shape) == (K, N_LOCAL, 16, 16, 1)
        return tr.run(2), tr.state

    (h1, s1), (h2, s2), (h3, _) = run(7), run(7), run(8)
    assert [r.metrics for r in h1] == [r.metrics for r in h2]
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert h3[0].metrics != h1[0].metrics


def test_entry_points_need_a_device_or_an_explicit_cpu():
    """With no GPU, naming no device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tpcfg = _configs(n_devices=K)
    spec = tspecs.make_dcgan_spec(TCFG)
    init = lambda g: tdcgan.gan_init(g, TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(spec, tpcfg, init, _data())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        protocol.make_train_state(init, tpcfg, K)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfid.make_feature_extractor(1)


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(algorithm="centralized", driver="fused"),
                 "driver='fused' is not supported",
                 id="algorithm=centralized"),
    pytest.param(dict(layout="mesh", tp=2),
                 "tp=2 needs a spec built with tp_axis='model'",
                 id="layout=mesh-tp=2"),
    pytest.param(dict(tp=2), "requires layout='mesh'", id="tp=2"),
    pytest.param(dict(pcfg=dict(micro_batch_d=2, sample_size=5)),
                 "micro_batch_d=2 must divide the batch 5",
                 id="pcfg={'micro_batch_d': 2}"),
    pytest.param(dict(pcfg=dict(micro_batch_g=2, server_sample_size=5)),
                 "micro_batch_g=2 must divide the batch 5",
                 id="pcfg={'micro_batch_g': 2}"),
])
def test_trainer_refuses_what_is_not_ported(kw, match):
    """What the JAX Trainer refuses (the centralized baseline on the
    fused driver, tp > 1 off the mesh layout or with a spec that is not
    TP-aware; its messages, checked before any process group), and a
    microbatch
    that does not divide its batch (refused before anything is built;
    the JAX package asserts it in the first round)."""
    kw = dict(kw)
    _, tpcfg = _configs(n_devices=K, **kw.pop("pcfg", {}))
    with pytest.raises(ValueError, match=match):
        Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                lambda g: tdcgan.gan_init(g, TCFG), _data(), device="cpu",
                **kw)


@pytest.mark.parametrize("policy", ["all", "round_robin", "best_channel",
                                    "prop_fair", "random"])
def test_channel_and_scheduler_copies_match_bitwise(policy):
    """The numpy copies draw in the same order, so rates, masks, timings
    and the wallclock are identical."""
    cfgs = [mod.ChannelConfig(n_devices=6, straggler_deadline_s=0.05)
            for mod in (jchannel, channel)]
    sims = [jchannel.ChannelSimulator(cfgs[0]),
            channel.ChannelSimulator(cfgs[1])]
    scheds = [jscheduling.SchedulerState(policy=policy, n_devices=6,
                                         ratio=0.5),
              scheduling.SchedulerState(policy=policy, n_devices=6,
                                        ratio=0.5)]
    rngs = [np.random.default_rng(0), np.random.default_rng(0)]
    fns = [(jscheduling.schedule_round, jchannel.round_wallclock),
           (scheduling.schedule_round, channel.round_wallclock)]
    for _ in range(4):
        out = []
        for sim, sched, rng, (sched_fn, wall_fn) in zip(sims, scheds, rngs,
                                                        fns):
            rates = sim.uplink_rates(sched.n_scheduled)
            mask = sched_fn(sched, rates, rng)
            timing = sim.round_timing(
                mask=mask, disc_params=1000, gen_params=2000,
                disc_step_flops=1e9, gen_step_flops=2e9, n_d=2, n_g=3,
                uplink_bits=16000)
            out.append((rates, mask, timing.upload_s, timing.stragglers,
                        wall_fn(timing, mask, schedule="parallel"),
                        wall_fn(timing, mask, schedule="serial")))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)


def test_synthetic_data_and_partitions_match_bitwise():
    jimgs, jlabels = jsynthetic.make_image_dataset("celeba32", 24, seed=3)
    timgs, tlabels = tsynthetic.make_image_dataset("celeba32", 24, seed=3)
    np.testing.assert_array_equal(timgs, jimgs)
    np.testing.assert_array_equal(tlabels, jlabels)
    np.testing.assert_array_equal(tpartition(timgs, 4, seed=1),
                                  jpartition(jimgs, 4, seed=1))
    np.testing.assert_array_equal(
        tpartition(timgs, 3, labels=tlabels, kind="dirichlet",
                             alpha=5.0, seed=2),
        jpartition(jimgs, 3, labels=jlabels, kind="dirichlet",
                             alpha=5.0, seed=2))


def test_fid_matches_jax_on_shared_features_and_weights():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((48, 8)).astype(np.float32)
    b = (rng.standard_normal((40, 8)) * 1.3 + 0.2).astype(np.float32)
    np.testing.assert_allclose(
        tfid.fid_score(torch.from_numpy(a), torch.from_numpy(b)),
        jfid.fid_score(a, b), rtol=1e-6)
    imgs = np.tanh(rng.standard_normal((5, 16, 16, 3))).astype(np.float32)
    feats = tfid.make_feature_extractor(3, device="cpu",
                                        weights=_jax_fid_weights(3))
    np.testing.assert_allclose(
        feats(torch.from_numpy(imgs)).numpy(),
        np.asarray(jfid.make_feature_extractor(3)(jnp.asarray(imgs))),
        rtol=1e-5, atol=1e-5)
    own = tfid.make_feature_extractor(3, device="cpu")(torch.from_numpy(imgs))
    assert own.shape == (5, 64) and bool(torch.isfinite(own).all())
