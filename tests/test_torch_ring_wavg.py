"""Port parity: the ring collective of Algorithm 2 (`repro_torch.kernels.
ring_wavg`) against the JAX package's (`repro.kernels.ring_wavg`).

The kernel's plain version against the Pallas kernel in interpret mode;
the wire helpers and the encoder against JAX's, the encoded blocks bit
for bit; and `ring_average_psum` over K in {2, 3, 4} gloo ranks on the
CPU against JAX's `ring_average_psum` under `jax.vmap(axis_name=...)`
(the harness of tests/test_ring_wavg_property.py, whose cases these
are) and against the float64 `ring_average_ref`. The port's ranks take
the uniforms of JAX's `quantize.device_uplink_key` streams, so both
sides quantize the same values.

The ranks are spawned once per K (a module-scoped fixture runs every
case of that K), initialised through a file in a temporary directory,
with timeouts on the process group and on the wait for results.
"""
import ctypes
import dataclasses
import functools
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import quantize as jquant
from repro.kernels.ring_wavg import ops as jring
from repro.kernels.ring_wavg.kernel import ring_accum_pallas
from repro.models import dcgan as jdcgan
from repro.configs.dcgan import DCGANConfig as JaxDCGANConfig
from repro_torch.kernels.ring_wavg import ops
from repro_torch.kernels.ring_wavg.ref import (ring_accum_ref,
                                               ring_average_ref)
from repro_torch.launch import mesh
from repro_torch.tree import tree_leaves
import torch_mesh_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLOCK_N = ops.BLOCK_N
TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# The kernel's plain version and the wire helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int16", "int32", "float32"])
def test_ring_accum_ref_matches_pallas_kernel(dtype):
    """acc + coef * float(q) per block, the int16 extremes included."""
    rng = np.random.default_rng(0)
    nb = 3
    acc = rng.standard_normal((nb, BLOCK_N)).astype(np.float32)
    coef = rng.standard_normal(nb).astype(np.float32)
    if dtype == "float32":
        q = rng.standard_normal((nb, BLOCK_N)).astype(np.float32)
    else:
        q = rng.integers(-1000, 1000, (nb, BLOCK_N)).astype(dtype)
        q[0, :2] = np.iinfo(np.int16).min, np.iinfo(np.int16).max
    want = np.asarray(ring_accum_pallas(jnp.asarray(acc), jnp.asarray(q),
                                        jnp.asarray(coef), interpret=True))
    got = ring_accum_ref(torch.from_numpy(acc.copy()), torch.from_numpy(q),
                         torch.from_numpy(coef))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the wrapper takes the plain version on the CPU, in place, and only
    # on the rows it is given
    full = torch.from_numpy(np.concatenate([acc, acc]))
    out = ops.ring_accum_(full[nb:], torch.from_numpy(q),
                          torch.from_numpy(coef))
    assert out.data_ptr() == full[nb:].data_ptr()
    np.testing.assert_array_equal(full[:nb].numpy(), acc)
    np.testing.assert_array_equal(full[nb:].numpy(), got.numpy())


def test_ring_accum_refuses_what_the_kernel_does_not_take():
    acc = torch.zeros(2, BLOCK_N)
    coef = torch.ones(2)
    for q, c in ((torch.zeros(2, BLOCK_N, dtype=torch.int8), coef),
                 (torch.zeros(2, BLOCK_N - 1, dtype=torch.int16), coef),
                 (torch.zeros(2, BLOCK_N, dtype=torch.int16), torch.ones(3)),
                 (torch.zeros(BLOCK_N, 2, dtype=torch.int16).T, coef)):
        with pytest.raises(ValueError, match="ring_accum"):
            ops.ring_accum_(acc, q, c)


@pytest.mark.parametrize("dtype", ["int16", "int32", "float32"])
def test_row_accumulator_matches_ring_accum_chunk_by_chunk(dtype):
    """The ring's launcher, checked once over whole tensors, gives what
    `ring_accum_` gives on each chunk's slices (the plain version on the
    CPU), in the ring's ragged chunks, and leaves the other rows alone."""
    rng = np.random.default_rng(1)
    nb = 7
    acc = torch.from_numpy(rng.standard_normal((nb, BLOCK_N))
                           .astype(np.float32))
    coef = torch.from_numpy(rng.standard_normal(nb).astype(np.float32))
    q = (torch.from_numpy(rng.standard_normal((nb, BLOCK_N))
                          .astype(np.float32)) if dtype == "float32" else
         torch.from_numpy(rng.integers(-1000, 1000, (nb, BLOCK_N))
                          .astype(dtype)))
    got, want = acc.clone(), acc.clone()
    accumulate = ops.RowAccumulator(got, q, coef)
    for r0, r1 in ops._chunk_bounds(nb, ops.DEFAULT_CHUNKS):
        accumulate(r0, r1)
        ops.ring_accum_(want[r0:r1], q[r0:r1], coef[r0:r1])
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got[r1:].numpy(), acc[r1:].numpy())
    np.testing.assert_array_equal(
        got.numpy(), ring_accum_ref(acc.clone(), q, coef).numpy())


def test_row_accumulator_refuses_rows_outside_its_tensors():
    acc, q, coef = torch.zeros(4, BLOCK_N), torch.zeros(4, BLOCK_N), \
        torch.ones(4)
    accumulate = ops.RowAccumulator(acc, q, coef)
    for r0, r1 in ((-1, 2), (2, 2), (3, 1), (0, 5), (4, 5)):
        with pytest.raises(ValueError, match="outside"):
            accumulate(r0, r1)
    with pytest.raises(ValueError, match="ring_accum"):
        ops.RowAccumulator(acc, q[:3], coef)


def test_ctypes_signature_matches_the_cuda_entry_points():
    """The wrapper's argtypes against each `extern "C" int ring_accum_*`
    in csrc/ring_accum.cu: one ctypes type per C parameter, of its
    kind."""
    src = (pathlib.Path(ops.__file__).parents[2] / "csrc"
           / "ring_accum.cu").read_text()
    decls = re.findall(r'extern "C" int (ring_accum_\w+)\(([^)]*)\)', src)
    assert sorted(name for name, _ in decls) == sorted(ops._ENTRY.values())
    for _, decl in decls:
        params = [" ".join(p.split()) for p in decl.split(",")]
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_longlong if p.startswith("long long") else
                 ctypes.c_int for p in params]
        assert ops.ARGTYPES == kinds


def test_wire_helpers_match_jax():
    for bits in (4, 8, 16, 17, 24, 31, 32):
        assert (str(ops.wire_dtype(bits)).split(".")[-1]
                == jnp.dtype(jring.wire_dtype(bits)).name)
    for nb in (1, 2, 4, 5, 9, 64):
        for nc in (1, 2, 4, 7):
            assert ops._chunk_bounds(nb, nc) == jring._chunk_bounds(nb, nc)
    sizes = [(BLOCK_N + 1,), (5,), (3, 7, 11)]
    jtree = {f"l{i}": jnp.zeros(s) for i, s in enumerate(sizes)}
    ttree = {f"l{i}": torch.zeros(s) for i, s in enumerate(sizes)}
    for bits in (16, 24, 32):
        for k in (1, 2, 8):
            assert (ops.ring_wire_bytes_per_rank(ttree, bits, k)
                    == jring.ring_wire_bytes_per_rank(jtree, bits, k))


def test_dcgan_discriminator_wire_blocks():
    """The full-width DCGAN discriminator: 1,356 wire blocks (each leaf
    padded to whole blocks), the ring's per-rank bytes at K=10 as JAX's."""
    shapes = jax.eval_shape(lambda k: jdcgan.gan_init(k, JaxDCGANConfig()),
                            jax.random.PRNGKey(0))["disc"]
    jtree = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    ttree = jax.tree.map(lambda s: torch.empty(s.shape), shapes)
    assert sum(x.numel() for x in tree_leaves(ttree)) == 2_765_568
    assert ops._n_blocks(ttree) == 1_356
    for bits in (16, 32):
        assert (ops.ring_wire_bytes_per_rank(ttree, bits, 10)
                == jring.ring_wire_bytes_per_rank(jtree, bits, 10))
    assert ops.ring_wire_bytes_per_rank(ttree, 16, 10) == \
        9 * 1_356 * (BLOCK_N * 2 + 4)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_encode_matches_jax_bitwise(bits):
    """Same leaves and uniforms: the same wire blocks and block scales."""
    rng = np.random.default_rng(bits)
    leaves = {"a": (rng.standard_normal(BLOCK_N + 3) * 4, "float32"),
              "b": (rng.standard_normal((5, 3)), "bfloat16"),
              "c": (rng.standard_normal(300) * 1e-3, "float32")}
    jtree = {n: jnp.asarray(a, d) for n, (a, d) in leaves.items()}
    ttree = {n: torch.from_numpy(a.astype(np.float32)).to(getattr(torch, d))
             for n, (a, d) in leaves.items()}
    key = jquant.device_uplink_key(jax.random.PRNGKey(bits), 1)
    n = sum(x.size for x in jax.tree_util.tree_leaves(jtree))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    jpay, jscales, _, _ = jring._encode(jtree, key if bits < 32 else None,
                                        bits)
    tpay, tscales = ops._encode(ttree, u if bits < 32 else None, bits)
    assert tpay.dtype == ops.wire_dtype(bits)
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(jscales))
    back = ops._decode(tpay.float(), ttree)
    assert [x.dtype for x in tree_leaves(back)] == \
        [x.dtype for x in tree_leaves(ttree)]
    if bits == 16:
        with pytest.raises(ValueError, match="uniforms"):
            ops._encode(ttree, None, bits)


# ---------------------------------------------------------------------------
# ring_average_psum over gloo ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    seed: int
    sizes: tuple
    dtypes: tuple = ("float32",)
    bits: int = 32
    zero_weights: bool = False


# test_ring_wavg_property.py's cases: payload sizes 1 and BLOCK_N +- 1,
# n_blocks 1, 4 (= DEFAULT_CHUNKS) and 5 (a ragged chunk split), bf16
# leaves, the quantized wire at 16 and 24 bits, zero total weight.
CASES = {
    2: {"mixed_q16": Case(11, (513, 40), bits=16),
        "mixed": Case(12, (513, 40))},
    3: {"size_1": Case(13, (1,)),
        "size_block_minus_1": Case(13, (BLOCK_N - 1,)),
        "size_block_plus_1": Case(13, (BLOCK_N + 1,), bits=16),
        "blocks_1": Case(29, (BLOCK_N - 7,), bits=16),
        "blocks_4": Case(29, (4 * BLOCK_N - 7,), bits=16),
        "blocks_5": Case(29, (5 * BLOCK_N - 7,), bits=16),
        "bf16": Case(5, (300, 40, 7), ("bfloat16", "float32", "bfloat16")),
        "bf16_q16": Case(6, (300, 7), ("bfloat16", "float32"), bits=16),
        "zero_weights": Case(41, (300, 5), zero_weights=True)},
    4: {"mixed_q16": Case(17, (513, 40, 2), bits=16),
        "mixed_q24": Case(18, (513, 40), bits=24),
        "mixed": Case(19, (2049, 3))},
}
PARAMS = [(k, name) for k in CASES for name in CASES[k]]
IDS = [f"k{k}-{name}" for k, name in PARAMS]


@functools.cache
def case_inputs(k, name):
    """(tree of (K, n) float32 arrays with their dtype names, weights,
    uniforms (K, N) or None, JAX round key) from the case's seed."""
    c = CASES[k][name]
    rng = np.random.default_rng(c.seed)
    dtypes = c.dtypes * len(c.sizes) if len(c.dtypes) == 1 else c.dtypes
    tree = {f"leaf{i}": ((rng.standard_normal((k, n))
                          * rng.uniform(0.1, 10.0)).astype(np.float32), dt)
            for i, (n, dt) in enumerate(zip(c.sizes, dtypes))}
    if c.zero_weights:
        w = np.zeros(k, np.float32)
    else:
        w = rng.uniform(0.5, 5.0, k).astype(np.float32)
        w[rng.integers(k)] = 0.0                 # one worker dropped
    round_key = jax.random.PRNGKey(c.seed)
    uniforms = None
    if c.bits < 32:
        n = sum(c.sizes)
        uniforms = np.stack([np.asarray(jax.random.uniform(
            jquant.device_uplink_key(round_key, i), (n,)))
            for i in range(k)])
    return tree, w, uniforms, round_key


def jax_tree(tree):
    return {n: jnp.asarray(a, d) for n, (a, d) in tree.items()}


@functools.cache
def jax_ring(k, name):
    """JAX's ring under vmap: every slice's result, as float32 numpy."""
    c = CASES[k][name]
    tree, w, _, round_key = case_inputs(k, name)
    fb = ({n: jnp.ones(a.shape[1:], d) for n, (a, d) in tree.items()}
          if c.zero_weights else None)
    if c.bits < 32:
        keys = jnp.stack([jquant.device_uplink_key(round_key, i)
                          for i in range(k)])
        out = jax.vmap(lambda t, wi, kk: jring.ring_average_psum(
            t, wi, axis_names="k", quantize_key=kk, bits=c.bits,
            fallback=fb), axis_name="k")(jax_tree(tree), jnp.asarray(w),
                                         keys)
    else:
        out = jax.vmap(lambda t, wi: jring.ring_average_psum(
            t, wi, axis_names="k", fallback=fb),
            axis_name="k")(jax_tree(tree), jnp.asarray(w))
    return {n: np.asarray(x, np.float32) for n, x in out.items()}


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """k -> every rank's [(result, wire bytes, dtypes)] for CASES[k], from
    one spawn of k gloo ranks per k."""
    runs = {}

    def get(k):
        if k not in runs:
            cases = []
            for name, c in CASES[k].items():
                tree, w, uniforms, _ = case_inputs(k, name)
                cases.append(dict(tree=tree, w=w, uniforms=uniforms,
                                  bits=c.bits, n_chunks=None,
                                  fallback=c.zero_weights))
            init = tmp_path_factory.mktemp(f"ring{k}") / "init"
            runs[k] = mesh.spawn(
                functools.partial(torch_mesh_ranks.ring_cases, cases), k,
                device="cpu", init_method=f"file://{init}",
                timeout_s=TIMEOUT_S)
        return runs[k]
    return get


def _port(ring_runs, k, name):
    """Per rank: (result tree, wire bytes, dtypes) of the case."""
    i = list(CASES[k]).index(name)
    return [rank_out[i][:3] for rank_out in ring_runs(k)]


def _atol(dtype_name, f32, bf16):
    return bf16 if dtype_name == "bfloat16" else f32


@pytest.mark.parametrize("k,name", PARAMS, ids=IDS)
def test_ring_matches_jax_ring(ring_runs, k, name):
    """Each rank's average equals JAX's slice of the same index (the same
    hop order) to f32 round-off, in the leaves' dtypes; the ranks agree."""
    want = jax_ring(k, name)
    tree = case_inputs(k, name)[0]
    per_rank = _port(ring_runs, k, name)
    for r, (got, _, dtypes) in enumerate(per_rank):
        assert dtypes == {n: f"torch.{d}" for n, (_, d) in tree.items()}
        for n, (_, d) in tree.items():
            np.testing.assert_allclose(
                got[n], want[n][r], rtol=_atol(d, 1e-6, 2 ** -8),
                atol=_atol(d, 1e-6, 1e-6), err_msg=f"rank {r} {n}")
            np.testing.assert_allclose(
                got[n], per_rank[0][0][n], rtol=_atol(d, 1e-6, 2 ** -8),
                atol=_atol(d, 1e-6, 1e-6), err_msg=f"rank {r} vs 0, {n}")


@pytest.mark.parametrize("k,name", PARAMS, ids=IDS)
def test_ring_matches_float64_ref(ring_runs, k, name):
    """Against the order-independent float64 twin, at the tolerances of
    tests/test_ring_wavg_property.py; zero total weight returns the
    fallback exactly."""
    c = CASES[k][name]
    tree, w, uniforms, _ = case_inputs(k, name)
    stacked = {n: torch.from_numpy(a).to(getattr(torch, d))
               for n, (a, d) in tree.items()}
    ref = ring_average_ref(stacked, w, bits=c.bits,
                           uniforms=None if uniforms is None
                           else torch.from_numpy(uniforms))
    for got, _, _ in _port(ring_runs, k, name):
        for n, (_, d) in tree.items():
            if c.zero_weights:
                np.testing.assert_array_equal(got[n], 1.0)
                continue
            np.testing.assert_allclose(got[n], ref[n].float().numpy(),
                                       rtol=0, atol=_atol(d, 2e-5, 0.02))


@pytest.mark.parametrize("k,name", PARAMS, ids=IDS)
def test_ring_wire_bytes_sent(ring_runs, k, name):
    """Every rank hands (k-1) * n_blocks * (BLOCK_N * itemsize + 4) bytes
    to send: `ring_wire_bytes_per_rank`, the JAX package's formula."""
    tree = case_inputs(k, name)[0]
    one = {n: torch.zeros(a.shape[1:]) for n, (a, _) in tree.items()}
    want = ops.ring_wire_bytes_per_rank(one, CASES[k][name].bits, k)
    assert want == jring.ring_wire_bytes_per_rank(
        {n: jnp.zeros(a.shape[1:]) for n, (a, _) in tree.items()},
        CASES[k][name].bits, k)
    assert [sent for _, sent, _ in _port(ring_runs, k, name)] == [want] * k


@pytest.mark.parametrize("k,name", PARAMS, ids=IDS)
def test_ring_accumulates_through_one_launcher_a_chunk(ring_runs, k, name):
    """Every rank accumulates its own payload whole (hop 0), then each
    of the k - 1 hops chunk by chunk: 1 + (k - 1) * chunks launcher
    calls, 1 + (k - 1) * 4 once the payload has 4 wire blocks."""
    i = list(CASES[k]).index(name)
    tree = case_inputs(k, name)[0]
    one = {n: torch.zeros(a.shape[1:]) for n, (a, _) in tree.items()}
    nb = ops._n_blocks(one)
    bounds = ops._chunk_bounds(nb, ops.DEFAULT_CHUNKS)
    assert len(bounds) == min(nb, ops.DEFAULT_CHUNKS)
    for rank_out in ring_runs(k):
        assert rank_out[i][3] == [(0, nb)] + bounds * (k - 1)
