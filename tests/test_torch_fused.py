"""Port parity: the fused driver (`protocol.rounds`, `graphs.RoundGraph`,
the device twins of the channel and the scheduler) against the port's
host driver and against the JAX package's fused driver.

The contract, as tests/test_driver_equivalence.py states it for the JAX
package's two drivers: masks and weights bit for bit for deterministic
policies with fading off, the wallclock to float32 round-off, parameters
and metrics to the host-parity tolerance (atol 1e-5). Against the JAX
fused driver, with fading off and the JAX draws injected, masks,
weights and the float32 wallclock are equal bit for bit. On the
CPU the body runs uncaptured; the CUDA graph is exercised by
`chip_smoke.py`.

Everything runs on the 8x8 DCGAN of tests/test_driver_equivalence.py,
K = 4.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs.base import ProtocolConfig as JaxProtocolConfig
from repro.configs.dcgan import DCGANConfig as JaxDCGANConfig
from repro.core import channel as jchannel
from repro.core import faults as jfaults
from repro.core import protocol as jprotocol
from repro.core import scheduling as jscheduling
from repro.core import shard_round as jshard
from repro.core.engine import Trainer as JaxTrainer
from repro.core.jax_channel import JaxChannel
from repro.core.jax_channel import round_wallclock as jax_round_wallclock
from repro.core.jax_scheduling import JaxScheduler, schedule_step
from repro.models import dcgan as jdcgan
from repro.models import gan as jgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import Trainer, channel, faults, graphs, protocol
from repro_torch.core.device_channel import DeviceChannel, round_wallclock
from repro_torch.core.device_scheduling import (DeviceScheduler,
                                                schedule_step as dstep)
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import gan as tgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
from test_torch_faults import FaultJaxDraws
from test_torch_protocol import quant_step_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(nz=8, ngf=8, ndf=8, nc=1, image_size=8)
JCFG, TCFG = JaxDCGANConfig(**SMALL), DCGANConfig(**SMALL)
K, N_LOCAL = 4, 8
KEY = jax.random.PRNGKey(0)
ATOL = 1e-5                      # the host-parity tests' tolerance
# one free-rider, one byzantine worker, 30 % dropout, stragglers to 2x
FAULTS = dict(n_devices=K, dropout_prob=0.3, n_free_riders=1,
              n_byzantine=1, straggler_factor=2.0, seed=0)


def _data():
    rng = np.random.default_rng(9)
    return np.tanh(rng.standard_normal(
        (K, N_LOCAL, 8, 8, 1))).astype(np.float32)


def _pcfg(module, **kw):
    common = dict(n_devices=K, n_d=1, n_g=1, sample_size=4,
                  server_sample_size=4, lr_d=1e-3, lr_g=1e-3,
                  optimizer="adam", scheduler="round_robin",
                  scheduling_ratio=0.5)
    common.update(kw)
    return module(**common)


def _trainer(driver, *, algorithm="proposed", schedule="serial",
             chan=None, fcfg=None, reducer=None, **kw):
    return Trainer(tspecs.make_dcgan_spec(TCFG),
                   _pcfg(ProtocolConfig, schedule=schedule),
                   lambda g: tdcgan.gan_init(g, TCFG), _data(), seed=0,
                   channel_cfg=channel.ChannelConfig(
                       n_devices=K, seed=3, **(chan or {"fading": False})),
                   driver=driver, algorithm=algorithm,
                   faults=faults.FaultConfig(**fcfg) if fcfg else None,
                   reducer=reducer, device="cpu", **kw)


def _assert_same_rounds(host, fused, *, wall_rtol=1e-6):
    assert len(host) == len(fused)
    for h, f in zip(host, fused):
        assert h.round == f.round
        np.testing.assert_array_equal(f.mask, h.mask)
        assert f.mask.dtype == bool
        np.testing.assert_array_equal(f.weights, h.weights)
        assert f.weights.dtype == np.float32
        np.testing.assert_allclose(f.wallclock_s, h.wallclock_s,
                                   rtol=wall_rtol)
        np.testing.assert_allclose(f.cumulative_s, h.cumulative_s,
                                   rtol=wall_rtol)
        assert f.metrics.keys() == h.metrics.keys()
        for name, value in h.metrics.items():
            np.testing.assert_allclose(f.metrics[name], value, rtol=0,
                                       atol=ATOL)


def _assert_states_close(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# The device twins against the JAX package's and the numpy ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["all", "round_robin", "best_channel",
                                    "prop_fair"])
def test_scheduler_twin_matches_jax_and_numpy(policy):
    """6 steps on the same rates (K=5, n=2: the cursor wraps): the masks
    bit for bit against JAX's `schedule_step` and the numpy twin, the
    EWMA (float32) against JAX's to round-off."""
    k, ratio = 5, 0.4
    rng = np.random.default_rng(11)
    np_state = jscheduling.SchedulerState(policy, k, ratio=ratio)
    jx = JaxScheduler(policy=policy, n_devices=k, ratio=ratio)
    dv = DeviceScheduler(policy=policy, n_devices=k, ratio=ratio)
    jcarry, tcarry = jx.init_carry(), dv.init_carry("cpu")
    for t in range(6):
        rates = rng.uniform(0.5, 10.0, k)      # distinct w.p. 1
        np_mask = jscheduling.schedule_round(np_state, rates, rng)
        jmask, jcarry = schedule_step(jx, jcarry,
                                      jnp.asarray(rates, jnp.float32), KEY)
        tmask, tcarry = dstep(dv, tcarry, torch.tensor(rates,
                                                       dtype=torch.float32))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tmask.numpy(), np_mask)
        np.testing.assert_allclose(tcarry["ewma_rate"].numpy(),
                                   np.asarray(jcarry["ewma_rate"]),
                                   rtol=1e-6)
        assert tcarry["rr_cursor"].dtype == torch.int32
        assert int(tcarry["rr_cursor"]) == int(jcarry["rr_cursor"])
    if policy == "round_robin":
        assert int(tcarry["rr_cursor"]) == np_state.rr_cursor == 2


def test_scheduler_twin_breaks_ties_as_jax():
    """Equal scores: the tail of a stable ascending argsort keeps the
    devices of the highest indices among the ties, as `jnp.argsort`
    (the ROADMAP's "argsort ties" trap)."""
    dv = DeviceScheduler(policy="best_channel", n_devices=6, ratio=0.5)
    jx = JaxScheduler(policy="best_channel", n_devices=6, ratio=0.5)
    rates = np.array([2.0, 1.0, 2.0, 2.0, 1.0, 2.0], np.float32)
    tmask, _ = dstep(dv, dv.init_carry("cpu"), torch.from_numpy(rates))
    jmask, _ = schedule_step(jx, jx.init_carry(), jnp.asarray(rates), KEY)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert np.flatnonzero(tmask.numpy()).tolist() == [2, 3, 5]


def test_random_policy_takes_the_rounds_permutation():
    """`random` schedules the first n of the round's permutation: always
    exactly n, every device eventually (the stream is the port's own)."""
    dv = DeviceScheduler(policy="random", n_devices=6, ratio=0.34)
    carry, seen = dv.init_carry("cpu"), np.zeros(6, bool)
    for t in range(40):
        perm = torch.randperm(6, generator=protocol.seeded_generator(
            0, protocol.STREAM_CHANNEL, t, "cpu"))
        mask, carry = dstep(dv, carry, torch.ones(6), perm)
        assert int(mask.sum()) == dv.n_scheduled == 3
        assert mask[perm[:3]].all()
        seen |= mask.numpy()
    assert seen.all()
    with pytest.raises(ValueError, match="permutation"):
        dstep(dv, carry, torch.ones(6))


@pytest.mark.parametrize("schedule,fedgan,deadline", [
    ("serial", False, 0.05), ("parallel", False, 0.05),
    ("serial", True, 0.05), ("serial", False, 1e-12)],
    ids=["serial", "parallel", "fedgan", "all-stragglers"])
def test_channel_twin_matches_jax_and_numpy(schedule, fedgan, deadline):
    """Fading off: rates, timing, stragglers and the wallclock against
    `JaxChannel` and the numpy simulator, to float32 round-off (the
    stragglers bit for bit), with per-device compute multipliers."""
    kw = dict(n_devices=6, seed=3, fading=False,
              straggler_deadline_s=deadline)
    np_sim = channel.ChannelSimulator(channel.ChannelConfig(**kw))
    jx = JaxChannel(jchannel.ChannelConfig(**kw))
    dv = DeviceChannel(channel.ChannelConfig(**kw), "cpu")
    for n in (1, 3, 6):
        np.testing.assert_allclose(dv.uplink_rates(None, n).numpy(),
                                   np.asarray(jx.uplink_rates(KEY, n)),
                                   rtol=1e-6)
        np.testing.assert_allclose(dv.uplink_rates(None, n).numpy(),
                                   np_sim.uplink_rates(n), rtol=1e-6)
    mask = np.array([True, True, False, True, False, True])
    mult = np.array([1.0, 0.0, 1.5, 30.0, 1.0, 2.0])
    args = dict(disc_params=10_000, gen_params=12_000,
                disc_step_flops=1e9, gen_step_flops=1e9, n_d=2, n_g=2,
                fedgan=fedgan, uplink_bits=16 * 11_000)
    t_np = np_sim.round_timing(mask=mask, compute_mult=mult, **args)
    t_jx = jx.round_timing(KEY, jnp.asarray(mask), compute_mult=mult,
                           **args)
    t_dv = dv.round_timing(None, torch.from_numpy(mask),
                           compute_mult=torch.tensor(mult,
                                                     dtype=torch.float32),
                           **args)
    for name in ("compute_dev_s", "upload_s", "compute_srv_s",
                 "broadcast_s"):
        got = getattr(t_dv, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(t_jx, name)),
                                   rtol=1e-6)
        np.testing.assert_allclose(got, getattr(t_np, name), rtol=1e-6)
    np.testing.assert_array_equal(t_dv.stragglers.numpy(), t_np.stragglers)
    np.testing.assert_array_equal(t_dv.stragglers.numpy(),
                                  np.asarray(t_jx.stragglers))
    assert t_dv.stragglers.any()             # device 3 (30x) straggles
    wall = round_wallclock(t_dv, torch.from_numpy(mask), schedule=schedule,
                           fedgan=fedgan)
    assert wall.dtype == torch.float32 and wall.dim() == 0
    np.testing.assert_allclose(float(wall), jchannel.round_wallclock(
        t_np, mask, schedule=schedule, fedgan=fedgan), rtol=1e-6)
    np.testing.assert_allclose(float(wall), float(jax_round_wallclock(
        t_jx, jnp.asarray(mask), schedule=schedule, fedgan=fedgan)),
        rtol=1e-6)


def test_device_dropout_mask_matches_the_host_mask():
    """Float32 comparison on both sides, at uniforms on either side of
    the dropout probability."""
    prog = faults.fault_program(faults.FaultConfig(n_devices=6,
                                                   dropout_prob=0.3))
    p = np.float32(0.3)
    u = np.array([0.0, np.nextafter(p, 0), p, np.nextafter(p, 1), 0.7,
                  0.29999998], np.float64)
    got = prog.dropout_mask_device(torch.tensor(u, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), prog.dropout_mask(u))
    np.testing.assert_array_equal(got.numpy(),
                                  [True, True, False, False, False, True])
    assert faults.fault_program(faults.FaultConfig(
        n_devices=6)).dropout_mask_device(None) is None


# ---------------------------------------------------------------------------
# The slots and the graph's bookkeeping
# ---------------------------------------------------------------------------

def test_draw_sampler_fills_slots_in_place():
    """`DrawSampler(t, out=slots)` writes the very values of
    `DrawSampler(t)` into the slots' tensors (slots that held another
    round's draws)."""
    pcfg = _pcfg(ProtocolConfig, n_d=2, n_g=3, sample_size=4,
                 server_sample_size=6)
    sampler = protocol.DrawSampler(
        tspecs.make_dcgan_spec(TCFG), pcfg, seed=5, n_local=N_LOCAL,
        n_params=50, device="cpu", faults=faults.FaultConfig(**FAULTS))
    want = sampler(7)
    slots = protocol.RoundSlots.holding(sampler(6), fading=True,
                                        random_policy=True, dropout=True,
                                        n_devices=K, device="cpu")
    ptrs = lambda: [getattr(slots.draws, f.name).data_ptr()
                    for f in dataclasses.fields(slots.draws)
                    if getattr(slots.draws, f.name) is not None]
    before = ptrs()
    protocol.fill_slots(slots, sampler, 7, seed=5)
    for f in dataclasses.fields(protocol.RoundDraws):
        a, b = getattr(slots.draws, f.name), getattr(want, f.name)
        if f.name == "drop_u":
            assert a is None
            continue
        assert torch.equal(a, b), f.name
    assert ptrs() == before
    np.testing.assert_array_equal(slots.drop_u.numpy(),
                                  want.drop_u.astype(np.float32))
    assert bool((slots.fading > 0).all())
    assert sorted(slots.perm.tolist()) == list(range(K))


def test_copy_into_clones_leaves_that_alias_the_static_tensors():
    """A new state that keeps the round-start tensor (the free-riders'
    stale cache) must see it before it is overwritten."""
    a, b = torch.arange(3.0), torch.zeros(3)
    graphs.copy_into({"a": a, "b": b}, {"a": a + 10, "b": a})
    assert a.tolist() == [10.0, 11.0, 12.0]
    assert b.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="changed a leaf"):
        graphs.copy_into({"a": a}, {"a": torch.zeros(4)})


# ---------------------------------------------------------------------------
# The port's fused driver against its host driver
# ---------------------------------------------------------------------------

FUSED_VS_HOST = {
    "proposed-serial": dict(),
    "proposed-parallel": dict(schedule="parallel"),
    "fedgan": dict(algorithm="fedgan"),
    # dropout from the shared slots, free-rider, byzantine, stragglers
    "proposed-faults-trimmed_mean": dict(fcfg=FAULTS,
                                         reducer="trimmed_mean"),
}


@pytest.mark.parametrize("name", list(FUSED_VS_HOST))
def test_fused_driver_matches_host_driver(name):
    """3 rounds, round_robin at ratio 0.5, fading off."""
    kw = FUSED_VS_HOST[name]
    host, fused = _trainer("host", **kw), _trainer("fused", **kw)
    assert (host.driver, fused.driver) == ("host", "fused")
    want, got = host.run(3), fused.run(3)
    _assert_same_rounds(want, got)
    assert any(not rec.mask.all() for rec in got)
    _assert_states_close(fused.state, host.state)
    assert fused.state is fused._graph.state
    assert fused._graph.eager_rounds == 3 and not fused._graph.captured


def test_chunked_fused_run_matches_one_shot():
    """run(2) + run(1) equals run(3): the scheduler carry, the static
    state and the absolute round index go on across chunks."""
    a, b = _trainer("fused"), _trainer("fused")
    a.run(2)
    a.run(1)
    b.run(3)
    for ra, rb in zip(a.history, b.history):
        assert (ra.round, ra.wallclock_s, ra.cumulative_s, ra.metrics) == (
            rb.round, rb.wallclock_s, rb.cumulative_s, rb.metrics)
        np.testing.assert_array_equal(ra.mask, rb.mask)
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)
    assert int(a._sched_carry["rr_cursor"]) == 2 * 3 % K
    with pytest.raises(ValueError, match="own state"):
        protocol.gan_rounds(a.spec, a.pcfg, dict(a.state), a.data, 1,
                            channel=a.device_channel,
                            scheduler=a.device_sched, sampler=a.sampler,
                            seed=0, graph=a._graph)


def test_fid_runs_on_the_same_rounds_with_the_same_generators():
    """eval_every=2 over 4 rounds: FID on rounds 1 and 3, from the same
    parameters and a generator seeded from (seed, STREAM_FID, t), in
    both drivers; the fused run ends its chunks there."""
    calls = {"host": [], "fused": []}

    def fid_fn(driver):
        def fn(gen, generator):
            draw = float(torch.rand((), generator=generator))
            value = draw + float(sum(x.sum() for x in tree_leaves(gen)))
            calls[driver].append(value)
            return value
        return fn

    runs = {d: _trainer(d).run(4, eval_every=2, fid_fn=fid_fn(d))
            for d in ("host", "fused")}
    for d, hist in runs.items():
        assert [r.fid is not None for r in hist] == [False, True] * 2, d
    np.testing.assert_allclose(calls["fused"], calls["host"], rtol=0,
                               atol=1e-4)
    _assert_same_rounds(runs["host"], runs["fused"])


# ---------------------------------------------------------------------------
# The port's fused driver against the JAX package's
# ---------------------------------------------------------------------------

def _deadline_off_the_edge(sim, upload_bits, compute):
    """A straggler deadline in the widest relative gap between the
    devices' upload + compute totals, for every count of scheduled
    devices a round can time (1 or 2 of K after dropout); returns it and
    its least relative distance to a total."""
    totals = np.sort(np.concatenate([
        upload_bits / np.maximum(sim.uplink_rates(n), 1.0) + compute
        for n in (1, 2)]))
    gaps = totals[1:] / totals[:-1]
    i = int(np.argmax(gaps))
    deadline = float(np.sqrt(totals[i] * totals[i + 1]))
    return deadline, float(np.min(np.abs(totals - deadline)) / deadline)


def test_fused_driver_matches_jax_fused_driver():
    """3 rounds, fading off, round_robin, a fault program with dropout,
    a free-rider and stragglers, the JAX draws injected (the dropout
    uniforms too): the port's masks, weights and float32 wallclock equal
    those of JAX's fused engine (`gan_rounds_scan`) bit for bit (the
    same float32 operations in the same order), metrics and parameters
    to the host-parity tolerance (one
    quantization step where a stochastic rounding flips). The deadline
    lies at least 5 % from every device's upload + compute time, off the
    edge where float32 and float64 could decide differently."""
    fcfg = dict(FAULTS, n_byzantine=0, straggler_factor=3.0, seed=2)
    data = _data()
    jpcfg, tpcfg = _pcfg(JaxProtocolConfig), _pcfg(ProtocolConfig)
    params = jax.device_get(jdcgan.gan_init(KEY, JCFG))
    tparams = interop.to_torch(params, "cpu")
    n_disc = protocol.count_params(tparams["disc"])
    sim = channel.ChannelSimulator(channel.ChannelConfig(
        n_devices=K, seed=3, fading=False))
    deadline, margin = _deadline_off_the_edge(
        sim, protocol.uplink_payload_bits(tparams, tpcfg),
        1e-3 * faults.fault_program(
            faults.FaultConfig(**fcfg)).compute_mult_np)
    assert margin > 0.05
    chan = dict(n_devices=K, seed=3, fading=False,
                straggler_deadline_s=deadline)

    jstate = jfaults.attach_fault_state(
        jprotocol.make_train_state(KEY, lambda k: params, jpcfg, K),
        jfaults.FaultConfig(**fcfg), jshard.PROPOSED_PAYLOAD)
    jstate, _, out = jprotocol.gan_rounds_scan(
        jspecs.make_dcgan_spec(JCFG), jpcfg, jstate, jnp.asarray(data), KEY,
        3, channel=JaxChannel(jchannel.ChannelConfig(**chan)),
        scheduler=JaxScheduler(policy="round_robin", n_devices=K,
                               ratio=0.5),
        faults=jfaults.FaultConfig(**fcfg))
    ttr = Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg, lambda g: tparams,
                  data, seed=0, channel_cfg=channel.ChannelConfig(**chan),
                  faults=faults.FaultConfig(**fcfg), device="cpu",
                  sampler=FaultJaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_disc,
                                        faults.FaultConfig(**fcfg)))
    assert ttr.driver == "fused"
    thist = ttr.run(3)
    np.testing.assert_array_equal(np.stack([r.mask for r in thist]),
                                  np.asarray(out["mask"]))
    np.testing.assert_array_equal(np.stack([r.weights for r in thist]),
                                  np.asarray(out["weights"]))
    np.testing.assert_array_equal(                # float32, bit for bit
        np.float32([r.wallclock_s for r in thist]),
        np.asarray(out["wallclock_s"]))
    for name, series in out["metrics"].items():
        np.testing.assert_allclose([r.metrics[name] for r in thist],
                                   np.asarray(series), rtol=0, atol=ATOL)
    masks = np.asarray(out["mask"])
    assert (masks & (np.asarray(out["weights"]) == 0)).any()  # stragglers
    assert masks.sum() < 3 * 2                                # dropout
    quant_step_close(ttr.state["disc"], jstate["disc"], atol=ATOL)
    quant_step_close(ttr.state["gen"], jstate["gen"], atol=ATOL)


# ---------------------------------------------------------------------------
# driver="auto" and the MLP-GAN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["proposed", "fedgan"])
def test_auto_resolves_as_in_jax(algorithm):
    """"auto" is the fused driver for both algorithms, in both packages;
    "host" stays the host driver."""
    jtr = JaxTrainer(jspecs.make_dcgan_spec(JCFG), _pcfg(JaxProtocolConfig),
                     lambda k: jdcgan.gan_init(k, JCFG),
                     jnp.asarray(_data()), KEY, algorithm=algorithm)
    assert _trainer("auto", algorithm=algorithm).driver == jtr.driver \
        == "fused"
    assert _trainer("host", algorithm=algorithm).driver == "host"
    with pytest.raises(ValueError, match="unknown driver"):
        _trainer("scan")


def test_mlp_gan_matches_jax_and_trains_fused():
    """The forward of G and D on the JAX package's parameters, then 2
    fused rounds of the MLP-GAN against 2 host rounds; the TP-aware spec
    refuses the stacked layout."""
    jparams = jgan.mlp_gan_init(KEY, d_data=16)
    params = interop.to_torch(jax.device_get(jparams), "cpu")
    jspec, tspec = jgan.mlp_gan_spec(), tgan.mlp_gan_spec()
    z = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    fake = tspec.gen_apply(params["gen"], torch.from_numpy(z))
    np.testing.assert_allclose(
        fake.numpy(), np.asarray(jspec.gen_apply(jparams["gen"], z)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tspec.disc_fake(params["disc"], fake).numpy(),
        np.asarray(jspec.disc_fake(jparams["disc"], jnp.asarray(
            fake.numpy()))), rtol=1e-6, atol=1e-6)
    shapes = {k: {n: tuple(x.shape) for n, x in v.items()}
              for k, v in tgan.mlp_gan_init(torch.Generator().manual_seed(0),
                                            d_data=16).items()}
    assert shapes == {k: {n: tuple(x.shape) for n, x in v.items()}
                      for k, v in jparams.items()}
    data = np.tanh(np.random.default_rng(4).standard_normal(
        (8, N_LOCAL, 16))).astype(np.float32)
    pcfg = _pcfg(ProtocolConfig, n_devices=8, quantize_bits=16)
    chan = channel.ChannelConfig(n_devices=8, fading=False)
    runs = {d: Trainer(tspec, pcfg, lambda g: tgan.mlp_gan_init(g, d_data=16),
                       data, seed=1, channel_cfg=chan, driver=d,
                       device="cpu")
            for d in ("host", "fused")}
    _assert_same_rounds(runs["host"].run(2), runs["fused"].run(2))
    _assert_states_close(runs["fused"].state, runs["host"].state)
    # the TP-aware spec (its tp=2 rounds: tests/test_torch_tp_mesh.py)
    # runs only on the mesh layout, as in the JAX package
    assert tgan.mlp_gan_spec(tp_axis="model").tp_axis == "model"
    with pytest.raises(ValueError, match="has no model group"):
        Trainer(tgan.mlp_gan_spec(tp_axis="model"), pcfg,
                lambda g: tgan.mlp_gan_init(g, d_data=16), data,
                channel_cfg=chan, device="cpu")


def test_capture_allocator_setting_is_scoped(monkeypatch):
    """`graphs._expandable_segments`, which a capture runs under: the
    caching allocator's expandable segments set on entering the block
    and off on leaving it, also when it raises; nothing set where the
    environment turns them on for the whole process."""
    calls = []
    monkeypatch.setattr(graphs, "_set_allocator", calls.append)
    for name in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.delenv(name, raising=False)
    with graphs._expandable_segments():
        assert calls == ["expandable_segments:True"]
    assert calls == ["expandable_segments:True", "expandable_segments:False"]
    with pytest.raises(RuntimeError):
        with graphs._expandable_segments():
            raise RuntimeError("capture failed")
    assert calls[2:] == ["expandable_segments:True",
                         "expandable_segments:False"]
    calls.clear()
    for name in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.setenv(name,
                           "max_split_size_mb:64, expandable_segments:True")
        with graphs._expandable_segments():
            pass
        monkeypatch.delenv(name)
    assert calls == []
