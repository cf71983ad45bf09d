"""Port parity: the robust Algorithm 2 reducers (trimmed mean, norm
clipping, multi-Krum) against the JAX package.

On the CPU the trimmed-mean wrapper takes its plain version (a CUDA
tensor would launch the hand-written kernel in
`src/repro_torch/csrc/trimmed_wavg.cu`; `chip_smoke.py` holds the two
against each other on the card). The JAX side runs as its own tests run
it on the CPU: the Pallas kernel in interpret mode and the numpy
reference.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import averaging as javg
from repro.kernels.robust_avg import ops as jrobust
from repro.kernels.robust_avg import ref as jref
from repro_torch import interop
from repro_torch.core import averaging as tavg
from repro_torch.kernels.robust_avg import ops
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 sums of the survivors in another order than the JAX kernel's (and
# than the float64 numpy reference's)
RTOL, ATOL = 1e-5, 1e-6


def _payload(k, n, seed, *, n_zero=0, ties=False):
    """x (K, N) float32 with row K-1 a copy of row 0 (exact ties, as
    free-riders replaying one stale payload make), raw weights w (K,)
    with `n_zero` dropped rows. `ties` draws small integers, so nearly
    every column holds ties between rows of different weights."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-2, 3, (k, n)).astype(np.float32)
    else:
        x = rng.standard_normal((k, n)).astype(np.float32)
    if k >= 3:
        x[k - 1] = x[0]
    w = rng.uniform(0.5, 2.0, k).astype(np.float32)
    w[rng.permutation(k)[:n_zero]] = 0.0
    return x, w


def _port_trimmed(x, w, trim):
    return ops.trimmed_average(torch.from_numpy(x), torch.from_numpy(w),
                               trim=trim).numpy()


def _check_trimmed(x, w, trim):
    out = _port_trimmed(x, w, trim)
    assert out.shape == (x.shape[1],) and out.dtype == np.float32
    pallas = jrobust.trimmed_average(jnp.asarray(x), jnp.asarray(w),
                                     trim=trim)
    for ref in (np.asarray(pallas), jref.trimmed_mean_ref(x, w, trim=trim)):
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("trim", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 3, 2049])
@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_trimmed_average_matches_jax(k, n, trim):
    """K below and above the gate, N at the TPU kernel's block edges
    (BLOCK_N = 2048), one dropped row where K allows, duplicated rows."""
    x, w = _payload(k, n, seed=100 * k + n, n_zero=1 if k >= 5 else 0)
    _check_trimmed(x, w, trim)


@pytest.mark.parametrize("n_part", [0, 1, 2, 3, 4, 5, 6, 7, 8])
def test_trimmed_average_gate_counts_the_rounds_participants(n_part):
    """Pair i is removed only while n_part >= 2i + 3: at K=8, trim=3 the
    pairs removed go 0, 0, 0, 1, 1, 2, 2, 3, 3 as n_part goes 0..8."""
    x, w = _payload(8, 2049, seed=7, n_zero=8 - n_part)
    _check_trimmed(x, w, trim=3)


@pytest.mark.parametrize("trim", [1, 2])
def test_trimmed_average_breaks_ties_by_lowest_index(trim):
    """Integer-valued rows of different weights: which tied row goes
    decides the result, so this pins the tie rule to the JAX kernel's."""
    x, w = _payload(7, 2049, seed=3, n_zero=1, ties=True)
    _check_trimmed(x, w, trim)


def test_trimmed_average_tie_rule_by_hand():
    """Column [5, 5, 0, 0, 2], w [1, 2, 3, 4, 5], one pair: the max pass
    removes row 0 (the first 5), the min pass row 2 (the first 0), so
    rows 1, 3, 4 survive: (2*5 + 4*0 + 5*2) / 11. An all-equal column
    loses the first participant to the max pass and the next one to the
    min pass."""
    x = np.array([[5, 1], [5, 1], [0, 1], [0, 1], [2, 1]], np.float32)
    w = np.array([1, 2, 3, 4, 5], np.float32)
    out = _port_trimmed(x, w, 1)
    np.testing.assert_allclose(out, [20 / 11, 1.0], rtol=1e-7)
    np.testing.assert_allclose(
        out, np.asarray(jrobust.trimmed_average(jnp.asarray(x),
                                                jnp.asarray(w), trim=1)),
        rtol=1e-7)
    x[:, 1] = [3, 3, 3, 3, 3]
    w[0] = 0.0              # row 0 is out: rows 1 and 2 are trimmed
    out = _port_trimmed(x, w, 1)
    np.testing.assert_allclose(out[1], 3.0, rtol=0)
    np.testing.assert_allclose(out[0], (4 * 0 + 5 * 2) / 9, rtol=1e-7)


def kernel_selection(x, w, trim):
    """The passes of csrc/trimmed_wavg.cu in plain torch: each scans k
    DOWNWARD and takes row k while it is included and x[k] >= the best so
    far (the max pass, from -inf) or <= it (the min pass, from +inf); the
    last row taken goes. Pair i only while n_part >= 2i + 3. Returns the
    survivors (K, N)."""
    k, n = x.shape
    part = w > 0
    n_part = int(part.sum())
    pairs = min(trim, (n_part - 1) // 2) if n_part >= 3 else 0
    inc = part[:, None].repeat(1, n)
    cols = torch.arange(n)
    for _ in range(pairs):
        for better, start in ((torch.ge, -torch.inf), (torch.le, torch.inf)):
            best = torch.full((n,), start)
            pick = torch.zeros(n, dtype=torch.long)
            for r in range(k - 1, -1, -1):
                take = inc[r] & better(x[r], best)
                best = torch.where(take, x[r], best)
                pick = torch.where(take, r, pick)
            inc[pick, cols] = False
    return inc


@pytest.mark.parametrize("k,trim,n_zero", [(3, 1, 0), (10, 2, 1), (10, 3, 0),
                                           (17, 2, 2)])
def test_kernel_downward_scan_keeps_the_lowest_index_rule(k, trim, n_zero):
    """The kernel's downward non-strict scan removes the same rows as the
    reference's first occurrence (lowest index) among ties: on integer
    payloads, where nearly every column ties, the survivors' mean is the
    plain version's bit for bit and JAX's to its tolerance."""
    x, w = _payload(k, 2053, seed=k + trim, n_zero=n_zero, ties=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    wk = torch.where(kernel_selection(tx, tw, trim), tw[:, None], 0.0)
    got = (wk * tx).sum(0) / torch.clamp(wk.sum(0), min=1e-12)
    torch.testing.assert_close(got, ops.trimmed_mean_ref(tx, tw, trim),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(),
                               jref.trimmed_mean_ref(x, w, trim=trim),
                               rtol=RTOL, atol=ATOL)


def test_trimmed_average_keeps_the_honest_range():
    """8 honest rows and 2 rows of 10x noise, trim=2: every coordinate
    lies inside the honest rows' range."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((10, 4099)).astype(np.float32)
    x[[3, 8]] *= 10.0
    w = np.ones(10, np.float32)
    out = _port_trimmed(x, w, 2)
    honest = np.delete(x, [3, 8], axis=0)
    assert np.all(out >= honest.min(0)) and np.all(out <= honest.max(0))


def test_clip_weights_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 3001)).astype(np.float32)
    x[2] *= 10.0                                # one row clips
    x[6] = x[0]
    w = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    w[4] = 0.0
    for factor in (0.5, 2.0):
        out = ops.clip_weights(torch.from_numpy(x), torch.from_numpy(w),
                               clip_factor=factor)
        ref = jrobust.clip_weights(jnp.asarray(x), jnp.asarray(w),
                                   clip_factor=factor)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
        assert out[4] == 0.0


@pytest.mark.parametrize("case", ["byzantine", "identical_rows",
                                  "dropped", "explicit_m", "one_left"])
def test_krum_selection_matches_jax_bitwise(case):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 2049)).astype(np.float32) * 0.1
    w = np.ones(8, np.float32)
    f, m = 1, None
    if case == "byzantine":
        x[[2, 5]] = rng.standard_normal((2, 2049)) * 10.0
        f = 2
    elif case == "identical_rows":
        x[3] = x[1]
        x[6] = x[1]
    elif case == "dropped":
        w[[0, 4]] = 0.0
        x[7] *= 30.0
    elif case == "explicit_m":
        m = 3
    elif case == "one_left":
        w[1:] = 0.0
    sel = ops.krum_weights(torch.from_numpy(x), torch.from_numpy(w), f=f,
                           m=m).numpy() > 0
    jsel = np.asarray(jrobust.krum_weights(jnp.asarray(x), jnp.asarray(w),
                                           f=f, m=m)) > 0
    np.testing.assert_array_equal(sel, jsel)
    np.testing.assert_array_equal(sel, jref.krum_selection_ref(x, w, f=f,
                                                               m=m))
    assert sel.any()


def test_identity_regimes_are_the_plain_weights():
    """trim=0, krum_f=0 and a clip_factor no row reaches give the plain
    normalized wavg weights (clip and Krum bit for bit)."""
    x, w = _payload(6, 2049, seed=2, n_zero=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    plain = tw / torch.clamp(tw.sum(), min=1e-12)
    assert torch.equal(ops.clip_weights(tx, tw, clip_factor=1e6), plain)
    assert torch.equal(ops.krum_weights(tx, tw, f=0), plain)
    np.testing.assert_allclose(_port_trimmed(x, w, 0),
                               (plain[:, None] * tx).sum(0).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["trimmed_mean", "norm_clip", "krum"])
def test_weighted_average_robust_matches_jax(method):
    """The tree path: flatten in the JAX leaf order, one robust
    reduction, unflatten; the no-survivor round keeps the fallback."""
    rng = np.random.default_rng(4)
    tree = {"b": rng.standard_normal((6, 3)).astype(np.float32),
            "a": [rng.standard_normal((6, 4, 5)).astype(np.float32),
                  rng.standard_normal((6, 2)).astype(np.float32)]}
    tree["b"][5] = tree["b"][0]
    fallback = jax.tree.map(lambda v: v[0] * 0 + 7.0, tree)
    w = np.array([1, 1, 0, 1, 1, 1], np.float32)
    cfg = ops.RobustConfig(method=method, trim=1, krum_f=1)
    jcfg = jrobust.RobustConfig(method=method, trim=1, krum_f=1)
    for weights in (w, np.zeros(6, np.float32)):
        out = tavg.weighted_average(interop.to_torch(tree, "cpu"),
                                    torch.from_numpy(weights), robust=cfg,
                                    fallback=interop.to_torch(fallback,
                                                              "cpu"))
        ref = javg.weighted_average(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(weights),
            robust=jcfg, fallback=jax.tree.map(jnp.asarray, fallback))
        for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    assert all(bool((a == 7.0).all()) for a in tree_leaves(out))


def test_robust_config_validates_as_the_jax_one():
    for bad in (dict(method="median"), dict(trim=-1), dict(clip_factor=0),
                dict(krum_f=-1)):
        with pytest.raises(ValueError):
            ops.RobustConfig(**bad)
        with pytest.raises(ValueError):
            jrobust.RobustConfig(**bad)
    assert ops.ROBUST_METHODS == jrobust.ROBUST_METHODS


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x, w = _payload(5, 10, seed=1, n_zero=1)
    before = ops.launches
    out = ops.trimmed_average(torch.from_numpy(x), torch.from_numpy(w),
                              trim=1)
    assert ops.launches == before
    torch.testing.assert_close(out, ops.trimmed_mean_ref(
        torch.from_numpy(x), torch.from_numpy(w), 1), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "rank", "k_mismatch", "strided",
                                  "empty", "too_many_k", "negative_trim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w, trim = torch.ones(4, 6), torch.ones(4), 1
    if case == "dtype":
        x = x.double()
    elif case == "rank":
        x = x[None]
    elif case == "k_mismatch":
        w = torch.ones(3)
    elif case == "strided":
        x = torch.ones(6, 4).T
    elif case == "empty":
        x = torch.ones(4, 0)
    elif case == "too_many_k":
        x, w = torch.ones(ops.MAX_K + 1, 6), torch.ones(ops.MAX_K + 1)
    elif case == "negative_trim":
        trim = -1
    with pytest.raises(ValueError):
        ops.trimmed_average(x, w, trim=trim)
