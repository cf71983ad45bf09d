"""Port parity: Algorithm 2 — the wavg kernel's plain version and the
flat (K, N) weighted average against both JAX implementations.

On the CPU the wrapper takes the plain version (a CUDA tensor would
launch the hand-written kernel; `chip_smoke.py` holds the two against
each other on the card).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import averaging as javg
from repro.kernels.wavg import ops as jwavg_ops
from repro.kernels.wavg.ref import wavg_ref as jwavg_ref
from repro_torch import interop
from repro_torch.core import averaging as tavg
from repro_torch.kernels.wavg import ops
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _payload(k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, k).astype(np.float32)
    return x, (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2048, 2049])
def test_plain_wavg_matches_jax_ref_and_pallas(n):
    """At the TPU kernel's block edges (BLOCK_N = 2048)."""
    x, w = _payload(4, n, seed=n)
    out = ops.weighted_average(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (n,) and out.dtype == torch.float32
    for ref in (jwavg_ref(jnp.asarray(x), jnp.asarray(w)),
                jwavg_ops.weighted_average(jnp.asarray(x), jnp.asarray(w),
                                           interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x, w = _payload(3, 10)
    before = ops.launches
    out = ops.weighted_average(torch.from_numpy(x), torch.from_numpy(w))
    assert ops.launches == before
    torch.testing.assert_close(out, ops.wavg_ref(torch.from_numpy(x),
                                                 torch.from_numpy(w)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "rank", "k_mismatch",
                                  "strided", "empty", "too_many_k"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w = torch.ones(4, 6), torch.full((4,), 0.25)
    if case == "dtype":
        x = x.double()
    elif case == "rank":
        x = x.reshape(4, 2, 3)
    elif case == "k_mismatch":
        w = w[:3]
    elif case == "strided":
        x = torch.ones(6, 4).t()
    elif case == "empty":
        x = torch.ones(4, 0)
    else:
        x, w = torch.ones(ops.MAX_K + 1, 1), torch.ones(ops.MAX_K + 1)
    with pytest.raises(ValueError):
        ops.weighted_average(x, w)


def _stacked_disc(k, seed):
    from repro.configs.dcgan import DCGANConfig
    from repro.models import dcgan
    params = dcgan.discriminator_init(
        jax.random.PRNGKey(seed), DCGANConfig(nz=8, ngf=8, ndf=8, nc=1,
                                              image_size=16))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x)[None] + rng.standard_normal(
        (k,) + x.shape) * 0.05).astype(np.float32), params)


def test_flat_payload_has_the_jax_column_order():
    """Keys inserted out of order (as the DCGAN init inserts "conv"
    before "bn") still flatten in the JAX order: sorted keys, lists in
    order."""
    stacked = _stacked_disc(3, 0)
    layer = stacked["layers"][1]
    stacked["layers"][1] = {"conv": layer["conv"],
                            "bn": {"scale": layer["bn"]["scale"],
                                   "bias": layer["bn"]["bias"]}}
    ref, _, _ = javg._flatten_stacked(jax.tree.map(jnp.asarray, stacked))
    port = {"layers": [
        {name: ({k: torch.from_numpy(v) for k, v in part.items()})
         for name, part in layer.items()}
        for layer in stacked["layers"]]}
    assert list(port["layers"][1]) == ["conv", "bn"]
    out = tavg.flatten_stacked(port)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("weights", [[4.0, 0.0, 4.0, 2.0], [1.0] * 4])
def test_weighted_average_matches_jax(impl, weights):
    stacked = _stacked_disc(4, 1)
    w = np.asarray(weights, np.float32)
    ref = javg.weighted_average(jax.tree.map(jnp.asarray, stacked),
                                jnp.asarray(w), impl=impl)
    out = tavg.weighted_average(interop.to_torch(stacked, "cpu"),
                                torch.from_numpy(w))
    for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_no_survivor_round_keeps_the_fallback_exactly():
    stacked = interop.to_torch(_stacked_disc(3, 2), "cpu")
    fallback = interop.to_torch(jax.tree.map(
        lambda x: np.asarray(x)[0] * 3, interop.to_numpy(stacked)), "cpu")
    zeros = torch.zeros(3)
    out = tavg.weighted_average(stacked, zeros, fallback=fallback)
    ref = javg.weighted_average(
        jax.tree.map(jnp.asarray, interop.to_numpy(stacked)), jnp.zeros(3),
        fallback=jax.tree.map(jnp.asarray, interop.to_numpy(fallback)))
    for a, b, c in zip(tree_leaves(out), tree_leaves(fallback),
                       jax.tree_util.tree_leaves(ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    # with a survivor the fallback is ignored
    some = tavg.weighted_average(stacked, torch.tensor([0.0, 2.0, 0.0]),
                                 fallback=fallback)
    for a, x in zip(tree_leaves(some), tree_leaves(stacked)):
        torch.testing.assert_close(a, x[1], rtol=0, atol=0)


def test_broadcast_like_tiles_copies():
    params = {"a": torch.arange(6.0).reshape(2, 3)}
    out = tavg.broadcast_like(params, 4)
    assert out["a"].shape == (4, 2, 3)
    assert out["a"].data_ptr() != params["a"].data_ptr()
    torch.testing.assert_close(out["a"][3], params["a"])
