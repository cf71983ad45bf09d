"""Port parity: one communication round (Algorithms 1-3, the 16-bit
uplink and Algorithm 2) against the JAX package's `gan_round`.

Both packages start from the same state (carried across by
`repro_torch.interop`) and consume the same randomness: `JaxDraws`
rebuilds the JAX round's keys (`repro/core/protocol.py` shared-noise and
data-sampling salts, `repro/core/quantize.py` uplink keys) and hands
the draws to the port as `RoundDraws`.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs.base import ProtocolConfig as JaxProtocolConfig
from repro.configs.dcgan import DCGANConfig as JaxDCGANConfig
from repro.core import protocol as jprotocol
from repro.core import quantize as jquant
from repro.models import dcgan as jdcgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.configs import DCGANConfig, ProtocolConfig
from repro_torch.core import protocol as tprotocol
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(nz=8, ngf=8, ndf=8, nc=1, image_size=16)
JCFG, TCFG = JaxDCGANConfig(**SMALL), DCGANConfig(**SMALL)
K, N_LOCAL = 3, 8
# round r's weights: all scheduled, one dropped, then no survivor at all
WEIGHTS = [[8.0, 8.0, 8.0], [8.0, 0.0, 8.0], [0.0, 0.0, 0.0]]
KEY = jax.random.PRNGKey(0)


class JaxDraws:
    """The JAX package's randomness for a round, as the port's draws."""

    def __init__(self, key, pcfg, nz, n_local, n_params, device="cpu",
                 sample_z=None):
        """sample_z(key, n): the JAX spec's noise draw; by default the
        DCGAN's (n, nz) normals."""
        self.key, self.pcfg, self.nz = key, pcfg, nz
        self.n_local, self.n_params, self.device = n_local, n_params, device
        self.sample_z = sample_z or (
            lambda k, n: jax.random.normal(k, (n, nz)))

    def __call__(self, t):
        """Round t of a JAX Trainer keyed by `key` (fold_in(key, t))."""
        return self.for_key(jax.random.fold_in(self.key, t))

    def for_key(self, round_key):
        p = self.pcfg
        salted_z = jax.random.fold_in(round_key, jprotocol._SALT_SHARED_Z)
        salted_x = jax.random.fold_in(round_key, jprotocol._SALT_DATA)

        def z(j, n):
            return np.asarray(self.sample_z(jax.random.fold_in(salted_z, j),
                                            n))

        z_dev = np.stack([z(j, p.sample_size) for j in range(p.n_d)])
        z_srv = np.stack([z(j, p.server_sample_size) for j in range(p.n_g)])
        idx = np.stack([[np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(salted_x, k), j),
            (p.sample_size,), 0, self.n_local)) for k in range(p.n_devices)]
            for j in range(p.n_d)])
        quant_u = np.stack([np.asarray(jax.random.uniform(
            jquant.device_uplink_key(round_key, k), (self.n_params,)))
            for k in range(p.n_devices)])
        to = lambda a, dtype: torch.tensor(a, dtype=dtype, device=self.device)
        return tprotocol.RoundDraws(
            to(z_dev, torch.float32), to(z_srv, torch.float32),
            to(idx, torch.int64),
            to(quant_u, torch.float32) if p.quantize_bits < 32 else None)


def _configs(**kw):
    common = dict(n_devices=K, n_d=2, n_g=2, sample_size=6,
                  server_sample_size=6, lr_d=1e-3, lr_g=1e-3)
    common.update(kw)
    return JaxProtocolConfig(**common), ProtocolConfig(**common)


def _data():
    rng = np.random.default_rng(0)
    return np.tanh(rng.standard_normal(
        (K, N_LOCAL, 16, 16, 1))).astype(np.float32)


@functools.cache
def _jax_round(jpcfg):
    spec = jspecs.make_dcgan_spec(JCFG)
    return jax.jit(lambda s, d, w, k: jprotocol.gan_round(spec, jpcfg, s, d,
                                                          w, k))


def quant_step_close(port_tree, jax_tree, *, atol):
    """Leaves agree to `atol` plus one 16-bit quantization step of the
    leaf (amax / 32767): a stochastic-rounding decision taken on either
    side of a rounding edge moves an element by one step."""
    a = tree_leaves(port_tree)
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        step = float(np.abs(y).max()) / 32767
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=atol + step)


@pytest.mark.parametrize("n_rounds", [1, 3])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_gan_round_matches_jax(schedule, optimizer, n_rounds):
    jpcfg, tpcfg = _configs(schedule=schedule, optimizer=optimizer)
    jstate = jprotocol.make_train_state(
        KEY, lambda k: jdcgan.gan_init(k, JCFG), jpcfg, K)
    tstate = interop.to_torch(jax.device_get(jstate), "cpu")
    n_params = tprotocol.count_params(tstate["disc"])
    draws = JaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_params)
    spec = tspecs.make_dcgan_spec(TCFG)
    data = _data()
    for r in range(n_rounds):
        w = np.asarray(WEIGHTS[r], np.float32)
        round_key = jax.random.fold_in(KEY, r)
        jstate, jm = _jax_round(jpcfg)(jstate, jnp.asarray(data),
                                       jnp.asarray(w), round_key)
        tstate, tm = tprotocol.gan_round(spec, tpcfg, tstate,
                                         torch.from_numpy(data),
                                         torch.from_numpy(w),
                                         draws.for_key(round_key))
        for name in ("disc_objective", "gen_objective", "participation"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=0, atol=1e-5)
    quant_step_close(tstate["disc"], jstate["disc"], atol=1e-6)
    quant_step_close(tstate["gen"], jstate["gen"], atol=1e-6)
    for part in ("gen_opt", "disc_opt"):
        for x, y in zip(tree_leaves(tstate[part]),
                        jax.tree_util.tree_leaves(jstate[part])):
            assert tuple(x.shape) == np.shape(y) and (
                x.dtype == torch.int32) == (np.asarray(y).dtype == np.int32)
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=1e-5)


def test_make_train_state_matches_jax():
    jpcfg, tpcfg = _configs(optimizer="adam")
    jstate = jprotocol.make_train_state(
        KEY, lambda k: jdcgan.gan_init(k, JCFG), jpcfg, K)
    params = jax.device_get({"gen": jstate["gen"], "disc": jstate["disc"]})
    tstate = tprotocol.make_train_state(
        lambda g: interop.to_torch(params, "cpu"), tpcfg, K, device="cpu")
    assert (jax.tree_util.tree_structure(interop.to_numpy(tstate))
            == jax.tree_util.tree_structure(jax.device_get(jstate)))
    for x, y in zip(tree_leaves(tstate), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert tprotocol.count_params(tstate["disc"]) == \
        jprotocol.count_params(jstate["disc"])
    assert tprotocol.uplink_payload_bits(tstate, tpcfg) == \
        jprotocol.uplink_payload_bits(jstate, jpcfg)


def test_draw_sampler_shares_noise_and_is_seeded():
    """The default sampler: shapes of `RoundDraws`, the server's noise at
    step j is the devices' (a prefix when M > m), same seed -> same
    draws, another round -> other draws."""
    _, pcfg = _configs(n_d=3, n_g=2, sample_size=4, server_sample_size=6)
    spec = tspecs.make_dcgan_spec(TCFG)
    sampler = tprotocol.DrawSampler(spec, pcfg, seed=5, n_local=N_LOCAL,
                                    n_params=100, device="cpu")
    d0 = sampler(0)
    assert d0.z_dev.shape == (3, 4, TCFG.nz) and d0.z_srv.shape == (2, 6,
                                                                    TCFG.nz)
    assert d0.idx.shape == (3, K, 4) and d0.idx.dtype == torch.int64
    assert int(d0.idx.min()) >= 0 and int(d0.idx.max()) < N_LOCAL
    assert d0.quant_u.shape == (K, 100)
    torch.testing.assert_close(d0.z_srv[:, :4], d0.z_dev[:2], rtol=0, atol=0)
    again = tprotocol.DrawSampler(spec, pcfg, seed=5, n_local=N_LOCAL,
                                  n_params=100, device="cpu")(0)
    for a, b in zip((d0.z_dev, d0.idx, d0.quant_u),
                    (again.z_dev, again.idx, again.quant_u)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(sampler(1).z_dev, d0.z_dev)
    _, p32 = _configs(quantize_bits=32)
    assert tprotocol.DrawSampler(spec, p32, seed=5, n_local=N_LOCAL,
                                 n_params=100, device="cpu")(0).quant_u is None


def test_gan_round_rejects_draws_of_another_shape():
    _, tpcfg = _configs()
    spec = tspecs.make_dcgan_spec(TCFG)
    state = tprotocol.make_train_state(lambda g: tdcgan.gan_init(g, TCFG),
                                       tpcfg, K, device="cpu")
    n_params = tprotocol.count_params(state["disc"])
    _, other = _configs(n_d=3)
    draws = tprotocol.DrawSampler(spec, other, seed=0, n_local=N_LOCAL,
                                  n_params=n_params, device="cpu")(0)
    with pytest.raises(ValueError, match="draws"):
        tprotocol.gan_round(spec, tpcfg, state, torch.from_numpy(_data()),
                            torch.ones(K), draws)
    with pytest.raises(ValueError, match="schedule"):
        tprotocol.gan_round(spec, ProtocolConfig(
            n_devices=K, n_d=3, n_g=2, sample_size=6, server_sample_size=6,
            schedule="async"), state, torch.from_numpy(_data()),
            torch.ones(K), draws)
