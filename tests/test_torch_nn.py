"""Port parity: convolutions, batch-norm, the DCGAN, losses, optimizers.

The same numpy inputs and the JAX package's own parameters (carried
across by `repro_torch.interop`) go through both packages on the CPU.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import nn as jnn
from repro.configs.dcgan import DCGANConfig as JaxDCGANConfig
from repro.core import losses as jlosses
from repro.models import dcgan as jdcgan
from repro.optim import optimizers as joptim
from repro_torch import interop
from repro_torch import nn as tnn
from repro_torch.configs import DCGANConfig
from repro_torch.core import losses as tlosses
from repro_torch.core.protocol import _value_and_grad
from repro_torch.models import dcgan as tdcgan
from repro_torch.optim import optimizers as toptim
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(nz=8, ngf=8, ndf=8, nc=1, image_size=16)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def assert_trees_close(port_tree, jax_tree, *, rtol, atol):
    a = tree_leaves(port_tree)
    b = jax.tree_util.tree_leaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(np.shape(y))
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("stride,padding,size", [(2, 1, 8), (1, 0, 4)])
def test_conv2d_matches_jax(stride, padding, size):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (2, size, size, 3)), _rand(rng, (4, 4, 3, 5), 0.2)
    ref = jnn.conv2d_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                           stride=stride, padding=padding)
    out = tnn.conv2d_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                           stride=stride, padding=padding)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("stride,padding,size", [(2, 1, 4), (1, 0, 1)])
def test_conv_transpose_matches_jax(stride, padding, size):
    """lax.conv_transpose(transpose_kernel=False) on HWIO weights: the
    port permutes AND flips the kernel for F.conv_transpose2d."""
    rng = np.random.default_rng(1)
    x, w = _rand(rng, (2, size, size, 6)), _rand(rng, (4, 4, 6, 3), 0.2)
    ref = jnn.conv_transpose2d_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                                     stride=stride, padding=padding)
    out = tnn.conv_transpose2d_apply({"w": torch.from_numpy(w)},
                                     torch.from_numpy(x), stride=stride,
                                     padding=padding)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_batchnorm_matches_jax():
    rng = np.random.default_rng(2)
    x = _rand(rng, (4, 5, 5, 6), 3.0) + 1.5
    params = {"scale": _rand(rng, (6,)), "bias": _rand(rng, (6,))}
    ref = jnn.batchnorm_apply(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x))
    out = tnn.batchnorm_apply(interop.to_torch(params, "cpu"),
                              torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("full_width", [False, True])
def test_dcgan_forward_matches_jax(full_width):
    """G and D on the JAX package's weights: small config at batch 4,
    and the paper's full 64x64 config once at batch 2."""
    kw = {} if full_width else SMALL
    jcfg, tcfg = JaxDCGANConfig(**kw), DCGANConfig(**kw)
    batch = 2 if full_width else 4
    jparams = jdcgan.gan_init(jax.random.PRNGKey(3), jcfg)
    tparams = interop.to_torch(jparams, "cpu")
    rng = np.random.default_rng(3)
    z = _rand(rng, (batch, jcfg.nz))
    imgs = np.tanh(_rand(rng, (batch, jcfg.image_size, jcfg.image_size,
                               jcfg.nc)))
    with torch.no_grad():
        fake = tdcgan.generator_apply(tparams["gen"], tcfg,
                                      torch.from_numpy(z))
        logits = tdcgan.discriminator_apply(tparams["disc"], tcfg,
                                            torch.from_numpy(imgs))
    np.testing.assert_allclose(
        _np(fake), np.asarray(jdcgan.generator_apply(jparams["gen"], jcfg,
                                                      jnp.asarray(z))),
        atol=1e-4)
    np.testing.assert_allclose(
        _np(logits), np.asarray(jdcgan.discriminator_apply(
            jparams["disc"], jcfg, jnp.asarray(imgs))), atol=1e-4)


def test_dcgan_init_matches_jax_tree_and_paper_counts():
    """Same tree, leaf order and shapes as the JAX init; the paper's
    parameter counts at full width (models/dcgan.py)."""
    for kw in (SMALL, {}):
        jshapes = jax.eval_shape(
            lambda k: jdcgan.gan_init(k, JaxDCGANConfig(**kw)),
            jax.random.PRNGKey(0))
        tparams = tdcgan.gan_init(torch.Generator().manual_seed(0),
                                  DCGANConfig(**kw))
        for net in ("gen", "disc"):
            assert (jax.tree_util.tree_structure(interop.to_numpy(
                tparams[net])) == jax.tree_util.tree_structure(jshapes[net]))
            assert [tuple(x.shape) for x in tree_leaves(tparams[net])] == \
                [tuple(x.shape) for x in jax.tree_util.tree_leaves(
                    jshapes[net])]
    assert sum(x.numel() for x in tree_leaves(tparams["gen"])) == 3_576_704
    assert sum(x.numel() for x in tree_leaves(tparams["disc"])) == 2_765_568


def test_disc_objective_gradients_match_jax():
    jcfg, tcfg = JaxDCGANConfig(**SMALL), DCGANConfig(**SMALL)
    jparams = jdcgan.gan_init(jax.random.PRNGKey(4), jcfg)["disc"]
    rng = np.random.default_rng(4)
    x = np.tanh(_rand(rng, (6, 16, 16, 1)))
    fake = np.tanh(_rand(rng, (6, 16, 16, 1)))

    def jneg(phi):
        return -jlosses.disc_objective(
            jdcgan.discriminator_apply(phi, jcfg, jnp.asarray(x)),
            jdcgan.discriminator_apply(phi, jcfg, jnp.asarray(fake)))

    jval, jgrads = jax.value_and_grad(jneg)(jparams)
    tval, tgrads = _value_and_grad(
        lambda phi: -tlosses.disc_objective(
            tdcgan.discriminator_apply(phi, tcfg, torch.from_numpy(x)),
            tdcgan.discriminator_apply(phi, tcfg, torch.from_numpy(fake))),
        interop.to_torch(jparams, "cpu"))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    assert_trees_close(tgrads, jgrads, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["minimax", "nonsaturating"])
def test_generator_objective_gradients_match_jax(variant):
    """Algorithm 3's objective: gradients reach G only, through D."""
    jcfg, tcfg = JaxDCGANConfig(**SMALL), DCGANConfig(**SMALL)
    jparams = jdcgan.gan_init(jax.random.PRNGKey(5), jcfg)
    tparams = interop.to_torch(jparams, "cpu")
    z = _rand(np.random.default_rng(5), (6, jcfg.nz))

    def jobj(theta):
        fake = jdcgan.generator_apply(theta, jcfg, jnp.asarray(z))
        return jlosses.gen_objective(
            jdcgan.discriminator_apply(jparams["disc"], jcfg, fake),
            variant=variant)

    jval, jgrads = jax.value_and_grad(jobj)(jparams["gen"])
    tval, tgrads = _value_and_grad(
        lambda theta: tlosses.gen_objective(
            tdcgan.discriminator_apply(
                tparams["disc"], tcfg,
                tdcgan.generator_apply(theta, tcfg, torch.from_numpy(z))),
            variant=variant),
        tparams["gen"])
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    assert_trees_close(tgrads, jgrads, rtol=1e-5, atol=1e-5)


def test_unknown_generator_loss_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        tlosses.gen_objective(torch.zeros(2), variant="wasserstein")


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax(name):
    """Three steps from the same params and gradients: params and state
    agree to float32 round-off (Adam's f32 bias correction included)."""
    rng = np.random.default_rng(6)
    params = {"a": _rand(rng, (3, 4)), "b": [_rand(rng, (5,))]}
    grads = [{"a": _rand(rng, (3, 4)), "b": [_rand(rng, (5,))]}
             for _ in range(3)]
    jopt = joptim.make_optimizer(name, 1e-2)
    topt = toptim.make_optimizer(name, 1e-2)
    jp, tp = jax.tree.map(jnp.asarray, params), interop.to_torch(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(interop.to_torch(g, "cpu"), ts)
        tp = toptim.apply_updates(tp, tu)
    assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
    assert_trees_close(ts, js, rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 3
    with pytest.raises(ValueError, match="optimizer"):
        toptim.make_optimizer("lion", 1e-2)


def test_interop_roundtrip_is_exact():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
            "t": np.int32(3), "layers": [{"s": np.ones(2, np.float32)}]}
    back = interop.to_numpy(interop.to_torch(tree, "cpu"))
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
