"""Port parity: checkpoints (`repro_torch.checkpoint`) and the Trainer's
`save_checkpoint` / `restore`, against the JAX package.

The on-disk format is the JAX package's, so a checkpoint crosses
packages both ways bit for bit (bfloat16 leaves included), and a run
saved by one package continues in the other as it would have at home
(host driver, the JAX draws through `JaxDraws`). Resume is exact: 2
rounds, a checkpoint, 2 rounds and a restore, then 2 rounds, equal 4
uninterrupted rounds bit for bit, on the restoring Trainer and on a
fresh one.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import ml_dtypes
import torch

from repro import checkpoint as jckpt
from repro.core.channel import ChannelConfig as JaxChannelConfig
from repro.core.engine import Trainer as JaxTrainer
from repro.models import specs as jspecs
from repro_torch import checkpoint, interop
from repro_torch.configs import ProtocolConfig
from repro_torch.core import Trainer, faults
from repro_torch.core.channel import ChannelConfig
from repro_torch.kernels.robust_avg.ops import RobustConfig
from repro_torch.launch import mesh
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
import torch_mesh_ranks
from test_torch_protocol import (JCFG, KEY, SMALL, TCFG, JaxDraws, _configs,
                                 quant_step_close)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, N_LOCAL = 4, 8


def level0(fn):
    """`fn`, a JAX function, compiled at XLA's backend optimisation level
    0 on its first call (later calls take the same shapes): the JAX
    package's own function, compiled in a fraction of the default's CPU
    time."""
    compiled = None

    def call(*args):
        nonlocal compiled
        if compiled is None:
            compiled = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled(*args)
    return call


def quick_jax_trainer(*args, **kw):
    """The JAX package's Trainer with its round compiled at level 0."""
    tr = JaxTrainer(*args, **kw)
    tr._round = level0(tr._round)
    return tr


def port_params(cfg, seed=0):
    """The port's seeded DCGAN parameters for `cfg` (either package's
    DCGANConfig) as a numpy tree. Both packages start from them: the
    JAX initialiser compiles a PRNG kernel for each leaf shape, which
    would take most of a test's CPU time."""
    tcfg = dataclasses.replace(TCFG, **{
        f: getattr(cfg, f) for f in ("nz", "ngf", "ndf", "nc", "image_size")})
    return interop.to_numpy(tdcgan.gan_init(
        torch.Generator().manual_seed(seed), tcfg))


def jax_init(params):
    """A JAX init_fn(key) that returns `params`."""
    return lambda _key: jax.tree_util.tree_map(jnp.asarray, params)


def _data(k=K):
    rng = np.random.default_rng(5)
    return np.tanh(rng.standard_normal(
        (k, N_LOCAL, 16, 16, 1))).astype(np.float32)


def _bits(x):
    """A leaf as (dtype name, shape, raw bytes): equal iff bit for bit."""
    if torch.is_tensor(x):
        x = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _flat_bits(tree):
    return [_bits(x) for x in jax.tree_util.tree_leaves(
        tree, is_leaf=torch.is_tensor)]


# ---------------------------------------------------------------------------
# The format
# ---------------------------------------------------------------------------

def _tree(bf16):
    """Every kind of leaf the format carries; `bf16` makes the bfloat16
    leaf (a torch or an ml_dtypes array)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"f32": w, "bf16": bf16(rng.standard_normal((2, 7))),
            "i64": np.int64(2**40 + 3), "f64": np.float64(1 / 3),
            "i32": np.arange(4, dtype=np.int32), "flag": np.array([True]),
            "none": None, "empty_dict": {}, "empty_list": [],
            "nested": [[w[0], {"x": w[1]}], [], [w[2]] * 11],
            "opt": {"t": np.int32(7), "m": {"a": w * 2}}}


TORCH_BF16 = lambda a: torch.tensor(a, dtype=torch.bfloat16)
JAX_BF16 = lambda a: jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_checkpoint_format_round_trips_bit_for_bit(tmp_path, writer,
                                                   reader):
    """Every leaf back with its dtype, shape and bits: bfloat16 (a torch
    bfloat16 tensor in the port, ml_dtypes in JAX), None, empty dict and
    list, nested lists, 0-dim int64 and float64 host scalars."""
    tree = _tree(TORCH_BF16 if writer == "port" else JAX_BF16)
    save = (checkpoint.save_checkpoint if writer == "port"
            else jckpt.save_checkpoint)
    load = (checkpoint.load_checkpoint if reader == "port"
            else jckpt.load_checkpoint)
    save(str(tmp_path), 3, tree, metadata={"who": writer})
    got, step, meta = load(str(tmp_path))
    assert (step, meta) == (3, {"who": writer})
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert not list(tmp_path.glob("*.tmp*"))
    if reader == "port":   # bfloat16 comes back as a torch tensor
        assert got["bf16"].dtype == torch.bfloat16
    assert got["none"] is None and got["empty_dict"] == {}
    assert got["empty_list"] == [] and len(got["nested"][2]) == 11
    assert got["i64"].dtype == np.int64 and got["f64"].dtype == np.float64
    want = jax.tree_util.tree_map(
        lambda x: x if torch.is_tensor(x) else np.asarray(x), tree,
        is_leaf=torch.is_tensor)
    assert _flat_bits(got) == _flat_bits(want)


# ---------------------------------------------------------------------------
# A run saved by one package continues in the other
# ---------------------------------------------------------------------------

def _jax_trainer(jpcfg, data, params):
    return quick_jax_trainer(
        jspecs.make_dcgan_spec(JCFG), jpcfg, jax_init(params),
        jnp.asarray(data), KEY, driver="host",
        channel_cfg=JaxChannelConfig(n_devices=K, fading=False))


def _port_trainer(tpcfg, data, params):
    n_params = sum(int(np.size(x)) for x in
                   jax.tree_util.tree_leaves(params["disc"]))
    return Trainer(tspecs.make_dcgan_spec(TCFG), tpcfg,
                   lambda g: interop.to_torch(params, "cpu"), data, seed=0,
                   sampler=JaxDraws(KEY, tpcfg, TCFG.nz, N_LOCAL, n_params),
                   driver="host", device="cpu",
                   channel_cfg=ChannelConfig(n_devices=K, fading=False))


def _same_continuation(got, want):
    """Masks, weights and the wallclock bit for bit; metrics to f32
    round-off."""
    assert [r.round for r in got] == [r.round for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.mask.sum() == 2
        assert (a.wallclock_s, a.cumulative_s) == (b.wallclock_s,
                                                   b.cumulative_s)
        for name, value in b.metrics.items():
            np.testing.assert_allclose(a.metrics[name], value, rtol=0,
                                       atol=1e-5)


def test_a_run_resumes_across_packages(tmp_path):
    """round_robin at 0.5, Adam, the host driver. JAX runs 2 rounds,
    saves and runs 2 more; the port restores round 2 (the saved state
    bit for bit) and runs rounds 2-3 as JAX did, then saves round 4;
    the JAX Trainer restores that and runs round 4 as the port does.
    Masks, weights and the wallclock continue bit for bit, the metrics
    and parameters to f32 round-off (one quantization step where a
    stochastic rounding flips)."""
    jpcfg, tpcfg = _configs(n_devices=K, scheduler="round_robin",
                            scheduling_ratio=0.5, optimizer="adam",
                            n_g=1)
    data = _data()
    params = port_params(JCFG)
    jtr = _jax_trainer(jpcfg, data, params)
    jtr.run(2)
    jtr.save_checkpoint(str(tmp_path / "jax"))
    saved = jax.device_get(jtr.state)
    want = jtr.run(2)[2:]

    ttr = _port_trainer(tpcfg, data, params)
    assert ttr.restore(str(tmp_path / "jax")) == 2
    assert _flat_bits(interop.to_numpy(ttr.state)) == _flat_bits(saved)
    _same_continuation(ttr.run(2), want)
    np.testing.assert_array_equal(ttr.sched.ewma_rate, jtr.sched.ewma_rate)
    assert ttr.sched.rr_cursor == jtr.sched.rr_cursor
    for part in ("disc", "gen"):
        quant_step_close(ttr.state[part], jtr.state[part], atol=1e-6)

    ttr.save_checkpoint(str(tmp_path / "port"))
    saved = interop.to_numpy(ttr.state)
    assert jtr.restore(str(tmp_path / "port")) == 4
    assert _flat_bits(jax.device_get(jtr.state)) == _flat_bits(saved)
    _same_continuation(jtr.run(1)[-1:], ttr.run(1)[-1:])
    for part in ("disc", "gen"):
        quant_step_close(ttr.state[part], jtr.state[part], atol=1e-6)


# ---------------------------------------------------------------------------
# Exact resume in the port
# ---------------------------------------------------------------------------

HOSTILE = faults.FaultConfig(n_devices=K, dropout_prob=0.25,
                             n_free_riders=1, n_byzantine=1,
                             straggler_factor=2.0, seed=2)
RESUME_CASES = {
    # fused runs draw fading from the (seed, round) stream: exact with it on
    "proposed-fused": dict(driver="fused", fading=True),
    "hostile-fused": dict(driver="fused", fading=True, faults=HOSTILE,
                          reducer=RobustConfig("trimmed_mean", trim=1)),
    "fedgan-fused": dict(driver="fused", fading=True, algorithm="fedgan"),
    # the host driver's numpy streams are not saved: fading off
    "proposed-host": dict(driver="host", fading=False),
}


def _resume_trainer(case):
    case = dict(case)
    fading = case.pop("fading")
    pcfg = ProtocolConfig(n_devices=K, n_d=1, n_g=1, sample_size=4,
                          server_sample_size=4, lr_d=1e-3, lr_g=1e-3,
                          optimizer="adam", scheduler="round_robin",
                          scheduling_ratio=0.5)
    return Trainer(tspecs.make_dcgan_spec(TCFG), pcfg,
                   lambda g: tdcgan.gan_init(g, TCFG), _data(), seed=3,
                   channel_cfg=ChannelConfig(n_devices=K, fading=fading),
                   device="cpu", **case)


def _same_run(got, want, got_state, want_state):
    assert [r.round for r in got] == [r.round for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_array_equal(a.weights, b.weights)
        assert a.metrics == b.metrics
        assert (a.wallclock_s, a.cumulative_s) == (b.wallclock_s,
                                                   b.cumulative_s)
    assert _flat_bits(interop.to_numpy(got_state)) == _flat_bits(
        interop.to_numpy(want_state))


@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resume_is_exact(tmp_path, name):
    """4 uninterrupted rounds against 2 rounds, a checkpoint, 2 more
    rounds, a restore of round 2 into the same Trainer (its round graph
    bound, on the fused driver) and 2 rounds; and against a fresh
    Trainer restored from round 2. The JAX package reads the checkpoint
    with the same bits as the port."""
    case = RESUME_CASES[name]
    whole = _resume_trainer(case)
    want = whole.run(4)[2:]
    if case.get("faults"):       # the free-rider takes part: it replays
        rider = faults.fault_program(case["faults"]).free_rider_idx[0]
        assert any(w.weights[rider] > 0 for w in want)
    part = _resume_trainer(case)
    part.run(2)
    path = part.save_checkpoint(str(tmp_path))
    part.run(2)
    assert part.restore(str(tmp_path), step=2) == 2
    if part.driver == "fused":
        assert part._graph.bound and part.state is part._graph.state
    _same_run(part.run(2)[-2:], want, part.state, whole.state)
    fresh = _resume_trainer(case)
    fresh.restore(str(tmp_path))
    _same_run(fresh.run(2), want, fresh.state, whole.state)

    tree, step, meta = checkpoint.load_checkpoint(str(tmp_path))
    jtree, jstep, jmeta = jckpt.load_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_00000002.npz") and step == jstep == 2
    assert meta == jmeta == {"algorithm": part.algorithm,
                             "layout": "stacked", "driver": part.driver}
    assert _flat_bits(tree) == _flat_bits(jtree)
    assert tree["trainer"]["round_index"].dtype == np.int64
    assert tree["trainer"]["clock"].dtype == np.float64
    carry_dtype = np.float32 if part.driver == "fused" else np.float64
    assert tree["trainer"]["sched_carry"]["ewma_rate"].dtype == carry_dtype
    assert ("fault" in tree["state"]) == bool(case.get("faults"))


def test_restore_refuses_another_state(tmp_path):
    """A checkpoint of another algorithm's state does not fit."""
    fed = _resume_trainer(dict(driver="host", fading=False,
                               algorithm="fedgan"))
    fed.save_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="does not fit"):
        _resume_trainer(dict(driver="host", fading=False)).restore(
            str(tmp_path))


# ---------------------------------------------------------------------------
# The mesh layout: a global-shaped checkpoint
# ---------------------------------------------------------------------------

MESH_RUN = dict(pcfg=dict(n_devices=2, n_d=1, n_g=1, sample_size=4,
                          server_sample_size=4, lr_d=1e-3, lr_g=1e-3,
                          optimizer="adam"),
                seed=4, algorithm="proposed", impl="pallas",
                driver="fused")


def test_mesh_checkpoint_is_the_stacked_one(tmp_path):
    """2 gloo ranks, one fused round each, then `save_checkpoint`: rank 0
    writes the stacked (K, ...) optimizer states, and the file equals a
    stacked Trainer's of the same seed and driver (same keys, dtypes and
    shapes; the trainer entries bit for bit; the state to round-off).
    A mesh Trainer restores its own rank's slice; the stacked Trainer
    loads the mesh checkpoint and goes on."""
    data = _data(2)
    mesh_dir, stacked_dir = tmp_path / "mesh", tmp_path / "stacked"
    per_rank = mesh.spawn(
        functools.partial(torch_mesh_ranks.checkpoint_run, SMALL, data,
                          MESH_RUN, str(mesh_dir)),
        2, device="cpu", init_method=f"file://{tmp_path / 'init'}",
        timeout_s=150)
    assert per_rank[0][2].endswith("ckpt_00000001.npz")
    assert per_rank[1][2] is None
    for before, after, _ in per_rank:   # each rank restored its own slice
        assert _flat_bits(after) == _flat_bits(before)

    def stacked():
        return Trainer(tspecs.make_dcgan_spec(TCFG),
                       ProtocolConfig(**MESH_RUN["pcfg"]),
                       lambda g: tdcgan.gan_init(g, TCFG), data,
                       seed=MESH_RUN["seed"], driver=MESH_RUN["driver"],
                       device="cpu")

    tr = stacked()
    tr.run(1)
    tr.save_checkpoint(str(stacked_dir))
    (m_tree, _, m_meta), (s_tree, _, s_meta) = (
        checkpoint.load_checkpoint(str(d)) for d in (mesh_dir, stacked_dir))
    assert m_meta == {**s_meta, "layout": "mesh"}
    m_flat, s_flat = (checkpoint.ckpt._flatten(t) for t in (m_tree, s_tree))
    assert m_flat.keys() == s_flat.keys()
    for key in s_flat:
        assert (m_flat[key].dtype, m_flat[key].shape) == (
            s_flat[key].dtype, s_flat[key].shape), key
    assert _flat_bits(m_tree["trainer"]) == _flat_bits(s_tree["trainer"])
    for part in ("disc", "gen"):
        quant_step_close(interop.to_torch(m_tree["state"][part], "cpu"),
                         s_tree["state"][part], atol=1e-6)
    for r, (before, _, _) in enumerate(per_rank):
        for a, b in zip(tree_leaves(before["disc_opt"]),
                        tree_leaves(m_tree["state"]["disc_opt"])):
            np.testing.assert_array_equal(a, b[r])

    into = stacked()
    into.restore(str(mesh_dir))
    assert _flat_bits(interop.to_numpy(into.state)) == _flat_bits(
        m_tree["state"])
    assert [r.round for r in into.run(1)] == [1]
