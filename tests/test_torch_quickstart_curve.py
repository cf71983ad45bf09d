"""The quickstart's 20-round curve against the JAX package's, from
tests/fixtures/quickstart_jax.npz alone (no jax): the JAX quickstart's
settings (reduced DCGAN 32x32, K=10, serial, Adam, 16-bit uplink, FID
every 5 rounds) on the host drivers of both packages, from JAX's initial
parameters, round draws and FID extractor weights and draws.

The uplink quantizer's uniforms, (K, N) a round, are drawn here from the
fixture's per-device keys by a numpy port of JAX's threefry2x32 and
`jax.random.uniform` (the partitionable bit layout, JAX's default), bit
for bit, which the guarded test checks against JAX itself.

Masks, weights and the simulated wallclock must be equal bit for bit
in all 20 rounds. Each round's step is held to JAX's at the limits of a
single round (metrics to 1e-5, parameters to 1e-5 plus one quantization
step, round 4's FID to 1e-3 relative) by the guarded test that runs the
port's rounds 0-4 from JAX's live states. Run free, the two curves part
further: a rounding of the 16-bit uplink decided on the other side of an
edge moves an upload by a quantization step, and the GAN's next rounds
grow it. So the free curve holds the metrics to 1e-5 in rounds 0-2 and
FID to 1e-3 at round 4, then all 20 rounds' metrics to 1e-2 absolute
and FIDs to 2e-2 relative: round-off alone, with nothing else changed,
drifts that far. `tests/fixtures/quickstart_drift.py` reads it over the
20 rounds: the port with oneDNN against PyTorch's native convolutions
9.8e-4 and 3.4e-3 in the objectives and 5.4e-3 in FID, the native port
against JAX 1.9e-3, 3.2e-3 and 1.6e-2, JAX at XLA level 1 against its
default 6.5e-4 and 3.6e-3, and the port against JAX 2.3e-3, 6.6e-3 and
1.1e-2; run from JAX's states, all 20 of the port's rounds stay within
9.6e-7 of JAX's metrics and 1.4e-6 of its parameters.
`tests/fixtures/make_quickstart_fixture.py` writes the fixture; the
guarded tests hold its rounds 0-4 against a live JAX run, so it cannot
go stale.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import Trainer, protocol
from repro_torch.data import make_image_dataset, partition
from repro_torch.metrics import fid_score, make_feature_extractor
from repro_torch.models import dcgan
from repro_torch.models.specs import make_dcgan_spec
from repro_torch.tree import tree_leaves, tree_unflatten
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ROUNDS, K, EVAL_EVERY = 20, 10, 5
FORCED_ROUNDS = 5         # the rounds run from JAX's states: 0-4
# the quickstart's settings (examples/quickstart.py and its port)
CFG = DCGANConfig(nz=32, ngf=16, ndf=16, nc=3, image_size=32)
PCFG = ProtocolConfig(n_devices=K, n_d=2, n_g=2, sample_size=16,
                      server_sample_size=16, lr_d=2e-4, lr_g=2e-4,
                      schedule="serial", optimizer="adam")


def load_fixture():
    with np.load(os.path.join(FIXTURES, "quickstart_jax.npz")) as f:
        return dict(f)


@pytest.fixture(scope="module")
def fixture():
    return load_fixture()


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """JAX's threefry2x32 hash of the uint32 counters (x0, x1) under
    key = (k0, k1): 20 rounds, a key injection every 4."""
    ks = [np.uint32(key[0]), np.uint32(key[1])]
    ks.append(ks[0] ^ ks[1] ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform(key, n):
    """`jax.random.uniform(key, (n,))` in float32: the partitionable
    random bits (counter i hashed as (0, i), the two words XORed), their
    top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(key, np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
    bits = (hi ^ lo) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


class FixtureDraws:
    """The JAX run's draws of round t, as the port's RoundDraws."""

    def __init__(self, fx, n_params):
        self.fx, self.n_params = fx, n_params

    def __call__(self, t):
        fx = self.fx
        quant_u = np.stack([uniform(key, self.n_params)
                            for key in fx["uplink_keys"][t]])
        return protocol.RoundDraws(
            torch.from_numpy(fx["z_dev"][t]), torch.from_numpy(fx["z_srv"][t]),
            torch.from_numpy(fx["idx"][t].astype(np.int64)),
            torch.from_numpy(quant_u))


def initial_params(fx):
    """JAX's initial parameters, in the port's tree."""
    like = dcgan.gan_init(torch.Generator().manual_seed(0), CFG)
    params = {}
    for part in ("gen", "disc"):
        names = sorted(n for n in fx if re.fullmatch(rf"{part}_\d{{3}}", n))
        leaves = [torch.from_numpy(fx[name]) for name in names]
        assert [x.shape for x in leaves] == [
            x.shape for x in tree_leaves(like[part])]
        params[part] = tree_unflatten(like[part], leaves)
    return params


def run_port(fx):
    """The port's quickstart run on the host driver from the fixture's
    parameters and draws: its 20 RoundRecords."""
    imgs, _ = make_image_dataset("celeba32", 640)
    shards = partition(imgs, K)
    params = initial_params(fx)
    n_disc = protocol.count_params(params["disc"])
    feat = make_feature_extractor(CFG.nc, device="cpu", weights=[
        fx[f"fid_w{i}"] for i in range(3)])
    real = feat(torch.from_numpy(imgs[:512]))
    fid_z = iter(fx["fid_z"])

    def fid_fn(gen_params, generator):
        with torch.no_grad():
            fake = dcgan.generator_apply(gen_params, CFG,
                                         torch.from_numpy(next(fid_z)))
        return fid_score(real, feat(fake))

    trainer = Trainer(make_dcgan_spec(CFG, gen_loss_variant="nonsaturating"),
                      PCFG, lambda g: params, shards, seed=0, driver="host",
                      sampler=FixtureDraws(fx, n_disc), device="cpu")
    return trainer.run(ROUNDS, eval_every=EVAL_EVERY, fid_fn=fid_fn)


def test_quickstart_curve_matches_jax(fixture):
    """The port's quickstart run from the fixture's parameters and
    draws: JAX's 20-round curve (limits in the module docstring)."""
    hist = run_port(fixture)

    np.testing.assert_array_equal(np.stack([r.mask for r in hist]),
                                  fixture["mask"])
    np.testing.assert_array_equal(
        np.stack([r.weights for r in hist]),
        np.where(fixture["mask"], np.float32(PCFG.sample_size),
                 np.float32(0)))
    np.testing.assert_array_equal([r.wallclock_s for r in hist],
                                  fixture["wallclock_s"])
    np.testing.assert_array_equal([r.cumulative_s for r in hist],
                                  fixture["cumulative_s"])
    for name in ("disc_objective", "gen_objective", "participation"):
        got = np.asarray([r.metrics[name] for r in hist])
        np.testing.assert_allclose(got[:3], fixture[name][:3], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got, fixture[name], rtol=0, atol=1e-2)
    fids = [(r.round, r.fid) for r in hist if r.fid is not None]
    assert [t for t, _ in fids] == fixture["fid_rounds"].tolist() == [
        4, 9, 14, 19]
    np.testing.assert_allclose(fids[0][1], fixture["fid"][0], rtol=1e-3)
    np.testing.assert_allclose([f for _, f in fids], fixture["fid"],
                               rtol=2e-2)


def _maker():
    """tests/fixtures/make_quickstart_fixture.py as a module (jax)."""
    spec = importlib.util.spec_from_file_location(
        "make_quickstart_fixture",
        os.path.join(FIXTURES, "make_quickstart_fixture.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    return maker


def jax_params(fx, key):
    """The fixture's initial parameters as the JAX package's tree."""
    import jax
    import jax.numpy as jnp
    maker = _maker()
    params = initial_params(fx)
    return {part: jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(
            jax.eval_shape(lambda k: maker.dcgan.gan_init(k, maker.CFG),
                           key)[part]),
        [jnp.asarray(x.numpy()) for x in tree_leaves(params[part])])
        for part in ("gen", "disc")}


def live_jax_rounds(fx, n, level=1):
    """The JAX package's quickstart on its host driver, live, for n
    rounds from the fixture's initial parameters (its round compiled at
    XLA backend optimisation `level`): (the fixture maker's module, the
    key, the shards, the records, and the state (numpy) at the start of
    each round and after the last)."""
    import jax
    import jax.numpy as jnp
    from repro.core import protocol as jprotocol
    maker = _maker()
    key = jax.random.PRNGKey(maker.SEED)
    imgs, _ = maker.make_image_dataset("celeba32", 640)
    shards = jnp.asarray(maker.partition(imgs, K))
    spec = maker.make_dcgan_spec(maker.CFG, gen_loss_variant="nonsaturating")
    trainer = maker.Trainer(spec, maker.PCFG, lambda k: jax_params(fx, key),
                            shards, key, driver="host")
    compiled = jax.jit(lambda s, d, w, k: jprotocol.gan_round(
        spec, maker.PCFG, s, d, w, k)).lower(
        trainer.state, trainer.data, jnp.zeros((K,), jnp.float32),
        jax.random.fold_in(key, 0)).compile(
        compiler_options={"xla_backend_optimization_level": level})
    states = []

    def round_fn(state, data, weights, round_key):
        states.append(jax.tree_util.tree_map(np.array, state))
        return compiled(state, data, weights, round_key)
    trainer._round = round_fn
    hist = trainer.run(n)
    states.append(jax.tree_util.tree_map(np.array, trainer.state))
    return maker, key, shards, hist, states


def forced_rounds(fx, n, live=None):
    """Each of the n rounds of `live_jax_rounds` (run here if not given)
    repeated by the port's `protocol.gan_round` from JAX's state at its
    start, with the fixture's draws: for each round, (JAX's metrics, the
    port's, the port's state after it, JAX's state after it as
    tensors)."""
    _, _, shards, hist, states = live or live_jax_rounds(fx, n)
    spec = make_dcgan_spec(CFG, gen_loss_variant="nonsaturating")
    draws = FixtureDraws(fx, protocol.count_params(
        initial_params(fx)["disc"]))
    data = torch.from_numpy(np.array(shards))
    for t, rec in enumerate(hist):
        w = np.where(rec.mask, np.float32(PCFG.sample_size), np.float32(0))
        state, metrics = protocol.gan_round(
            spec, PCFG, interop.to_torch(states[t], "cpu"), data,
            torch.from_numpy(w), draws(t))
        yield (rec.metrics, {k: float(v) for k, v in metrics.items()},
               state, interop.to_torch(states[t + 1], "cpu"))


@pytest.fixture(scope="module")
def live_jax(fixture):
    """`live_jax_rounds` over rounds 0-4 (up to the first FID round)."""
    pytest.importorskip("jax")
    return live_jax_rounds(fixture, FORCED_ROUNDS)


def test_fixture_is_a_live_jax_run(fixture, live_jax):
    """With jax: the fixture's settings, its draws, masks and wallclocks
    of rounds 0-4 (and the numpy uniforms of round 0's uplink keys
    against `jax.random.uniform`) and its round-0 metrics against the
    JAX package's, run now. (JAX's initializer and FID weights, whose
    PRNG compiles take 20 s here, are what the fixture holds; its rounds
    must follow from them.)"""
    import dataclasses
    import jax
    from repro.core import quantize as jquantize
    maker, key, shards, hist, _ = live_jax
    assert dataclasses.asdict(maker.CFG) == dataclasses.asdict(CFG)
    assert dataclasses.asdict(maker.PCFG) == dataclasses.asdict(PCFG)
    assert (maker.ROUNDS, maker.K, maker.EVAL_EVERY) == (ROUNDS, K,
                                                         EVAL_EVERY)
    for t, rec in enumerate(hist):
        for name, live in zip(("z_dev", "z_srv", "idx", "uplink_keys"),
                              maker.round_draws(key, t, shards.shape[1])):
            np.testing.assert_array_equal(fixture[name][t], live)
        np.testing.assert_array_equal(rec.mask, fixture["mask"][t])
        assert rec.wallclock_s == fixture["wallclock_s"][t]
        assert rec.cumulative_s == fixture["cumulative_s"][t]
    n_disc = protocol.count_params(initial_params(fixture)["disc"])
    for k, device_key in enumerate(fixture["uplink_keys"][0]):
        np.testing.assert_array_equal(
            uniform(device_key, n_disc), np.asarray(jax.random.uniform(
                jquantize.device_uplink_key(jax.random.fold_in(key, 0), k),
                (n_disc,))))
    for name, value in hist[0].metrics.items():
        np.testing.assert_allclose(value, fixture[name][0], rtol=0,
                                   atol=1e-6)


def test_rounds_from_jax_states_match_jax(fixture, live_jax):
    """With jax: each of rounds 0-4, run by the port from JAX's state at
    its start, against JAX's round at the limits of a single round: the
    metrics to 1e-5, G's and D's parameters to 1e-5 plus one
    quantization step of the leaf, and the FID of round 4's generator
    to 1e-3 relative of the FID of JAX's. Run free, the curve drifts
    further (the module docstring); here no round leaves round-off."""
    feat = make_feature_extractor(CFG.nc, device="cpu", weights=[
        fixture[f"fid_w{i}"] for i in range(3)])
    imgs, _ = make_image_dataset("celeba32", 640)
    real = feat(torch.from_numpy(imgs[:512]))

    def fid(gen_params):
        with torch.no_grad():
            return fid_score(real, feat(dcgan.generator_apply(
                gen_params, CFG, torch.from_numpy(fixture["fid_z"][0]))))

    for jax_metrics, port_metrics, port, ref in forced_rounds(
            fixture, FORCED_ROUNDS, live_jax):
        assert port_metrics.keys() == jax_metrics.keys()
        for name, value in jax_metrics.items():
            np.testing.assert_allclose(port_metrics[name], value, rtol=0,
                                       atol=1e-5)
        for part in ("gen", "disc"):
            for x, y in zip(tree_leaves(port[part]), tree_leaves(ref[part])):
                step = float(y.abs().max()) / 32767
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                           atol=1e-5 + step)
    assert fixture["fid_rounds"][0] == FORCED_ROUNDS - 1
    np.testing.assert_allclose(fid(port["gen"]), fid(ref["gen"]), rtol=1e-3)
