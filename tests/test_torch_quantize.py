"""Port parity: the 16-bit uplink quantizer.

Given the JAX package's own stochastic-rounding uniforms, the port's
quantized integers, scales and dequantized uploads match bit for bit.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs.dcgan import DCGANConfig as JaxDCGANConfig
from repro.core import quantize as jquant
from repro.models import dcgan as jdcgan
from repro_torch import interop
from repro_torch.core import quantize as tquant
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = JaxDCGANConfig(nz=8, ngf=8, ndf=8, nc=1, image_size=16)


def _disc(seed, k=None):
    """A small discriminator tree with spread-out values (so every
    leaf exercises many quantization levels); stacked K when k is set."""
    params = jdcgan.discriminator_init(jax.random.PRNGKey(seed), CFG)
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return jax.tree.map(
        lambda x: np.asarray(x)[None].repeat(k or 1, 0).reshape(
            lead + x.shape) + rng.standard_normal(lead + x.shape).astype(
                np.float32) * 0.05, params)


def _n_params(tree):
    return sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_quantized_integers_match_jax_bitwise(bits):
    tree = _disc(0)
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (_n_params(tree),)))
    jq, js = jquant.quantize_tree(key, jax.tree.map(jnp.asarray, tree), bits)
    tq, ts = tquant.quantize_tree(torch.from_numpy(u),
                                  interop.to_torch(tree, "cpu"), bits)
    for a, b in zip(tree_leaves(tq), jax.tree_util.tree_leaves(jq)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    deq = tquant.dequantize_tree(tq, ts)
    jdeq = jquant.dequantize_tree(jq, js)
    for a, b in zip(tree_leaves(deq), jax.tree_util.tree_leaves(jdeq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_roundtrip_matches_jax_bitwise():
    tree = _disc(1)
    key = jax.random.PRNGKey(12)
    u = np.array(jax.random.uniform(key, (_n_params(tree),)))
    ref = jquant.roundtrip(key, jax.tree.map(jnp.asarray, tree), 16)
    out = tquant.roundtrip(torch.from_numpy(u), interop.to_torch(tree, "cpu"))
    for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [16, 8])
def test_roundtrip_stacked_matches_jax_bitwise(bits):
    """Every device quantizes its own upload with its own stream: row k
    of the port's uniforms is device k's JAX draw."""
    k = 3
    stacked = _disc(2, k)
    round_key = jax.random.PRNGKey(13)
    n = _n_params(stacked) // k
    u = np.stack([np.asarray(jax.random.uniform(
        jquant.device_uplink_key(round_key, i), (n,))) for i in range(k)])
    ref = jquant.roundtrip_stacked(round_key,
                                   jax.tree.map(jnp.asarray, stacked), bits)
    out = tquant.roundtrip_stacked(torch.from_numpy(u),
                                   interop.to_torch(stacked, "cpu"), bits)
    for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_full_width_bits_are_the_identity_and_tree_bits_match():
    tree = interop.to_torch(_disc(3), "cpu")
    assert tquant.roundtrip(None, tree, 32) is tree
    assert tquant.roundtrip_stacked(None, tree, 32) is tree
    for bits in (16, 8, 32):
        assert tquant.tree_bits(tree, bits) == jquant.tree_bits(
            interop.to_numpy(tree), bits)


def test_uniforms_must_cover_the_payload():
    tree = interop.to_torch(_disc(4), "cpu")
    n = sum(x.numel() for x in tree_leaves(tree))
    with pytest.raises(ValueError, match="uniforms"):
        tquant.quantize_tree(torch.rand(n - 1), tree)
    stacked = interop.to_torch(_disc(4, 2), "cpu")
    with pytest.raises(ValueError, match="uniforms"):
        tquant.roundtrip_stacked(torch.rand(3, n), stacked)
