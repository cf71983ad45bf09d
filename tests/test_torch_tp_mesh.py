"""Port parity: tensor parallelism on gloo ranks, 2 workers x tp=2 (four
ranks on the CPU, `launch.mesh.spawn(..., tp=2)`: global rank 2k + r is
worker k's model rank r).

* `nn.tp`'s collective pairs, and a TP SwiGLU MLP's forward and
  gradients (input and every weight shard) against the plain MLP;
* the MLP-GAN's slice rounds of both algorithms (`shard_round.
  mesh_round` / `fedgan_mesh_round` with a `TpCtx`) against the JAX
  package's `_proposed_slice_round` / `_fedgan_slice_round` with its
  `TpCtx`, under nested `jax.vmap(axis_name="data")` of
  `jax.vmap(axis_name="model")` on the same weights and draws (the
  harness of tests/test_torch_mesh.py with a model axis);
* `Trainer(layout="mesh", tp=2)` on the host and fused drivers, both
  algorithms, and one reduced granite-3-2b round, against the stacked
  tp=1 Trainer of the same seed (itself held to the JAX package in
  test_torch_fused.py and test_torch_dense_backbone.py): masks, weights
  and the wallclock bit for bit, metrics within 1e-4 and parameters
  within JAX's own tp=2 against tp=1 tolerance
  (tests/test_tp_equivalence.py: 5e-5 at 16 bits, 2e-5 at 32);
* a checkpoint written at tp=2: global-shaped, restored by a tp=1 mesh
  Trainer, by a stacked Trainer and by the JAX package's Trainer.

Every port computation runs in ONE spawn of four ranks (a module-scoped
fixture).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs.base import ProtocolConfig as JaxProtocolConfig
from repro.core import fedgan as jfedgan
from repro.core import protocol as jprotocol
from repro.core import shard_round as jshard
from repro.core.channel import ChannelConfig as JaxChannelConfig
from repro.core.engine import Trainer as JaxTrainer
from repro.models import gan as jgan
from repro.sharding import rules as jrules
from repro_torch import checkpoint, interop
from repro_torch.configs import ProtocolConfig, get_arch_config
from repro_torch.core import Trainer, shard_round
from repro_torch.core.channel import ChannelConfig
from repro_torch.launch import mesh
from repro_torch.models import gan as tgan
from repro_torch.models import specs as tspecs
from repro_torch.nn import mlp
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves
import torch_mesh_ranks
from test_torch_protocol import JaxDraws, quant_step_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, TP, N_LOCAL, DIM, HID = 2, 2, 8, 64, 16
TIMEOUT_S = 400
KEY = jax.random.PRNGKey(0)
ROUND_KEY = jax.random.fold_in(KEY, 5)
PCFG = dict(n_devices=K, n_d=2, n_g=1, sample_size=4, server_sample_size=4,
            lr_d=1e-3, lr_g=1e-3, optimizer="adam")
CHANNEL = dict(n_devices=K, seed=3, fading=False)
MLP = dict(d_z=8, d_hidden=HID, d_data=DIM)
SEQ = 16
GRANITE = dict(arch="granite-3-2b", seq=SEQ)


def _data():
    return np.tanh(np.random.default_rng(3).standard_normal(
        (K, N_LOCAL, DIM))).astype(np.float32)


def _tokens():
    vocab = get_arch_config("granite-3-2b").reduced().vocab
    return np.random.default_rng(4).integers(
        0, vocab, (K, N_LOCAL, SEQ)).astype(np.int32)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundCase:
    algorithm: str
    impl: str = "pallas"
    schedule: str = "serial"
    bits: int = 16
    weights: tuple = (4.0, 4.0)


ROUND_CASES = {
    "proposed-serial-pallas-16bit": RoundCase("proposed"),
    "proposed-parallel-jnp-32bit-dropped": RoundCase(
        "proposed", "jnp", "parallel", 32, (4.0, 0.0)),
    "fedgan-serial-pallas-16bit": RoundCase("fedgan"),
    "fedgan-parallel-pallas-8bit-dropped": RoundCase(
        "fedgan", "pallas", "parallel", 8, (0.0, 4.0)),
}

# (algorithm, driver, schedule, bits, rounds) of the MLP-GAN, then one
# reduced granite-3-2b round on the host driver
TRAINER_RUNS = {
    "proposed-host-serial-16bit": ("proposed", "host", "serial", 16, 3),
    "proposed-fused-parallel-16bit": ("proposed", "fused", "parallel", 16, 3),
    "fedgan-host-parallel-16bit": ("fedgan", "host", "parallel", 16, 3),
    "fedgan-fused-serial-32bit": ("fedgan", "fused", "serial", 32, 3),
    "granite-host-serial-16bit": ("proposed", "host", "serial", 16, 1),
}
CKPT_RUN = dict(model={"mlp": MLP}, algorithm="proposed", driver="fused",
                seed=2, pcfg=dict(PCFG, quantize_bits=16,
                                  scheduler="round_robin",
                                  scheduling_ratio=0.5), channel=CHANNEL)


def _run(name):
    algorithm, driver, schedule, bits, rounds = TRAINER_RUNS[name]
    granite = name.startswith("granite")
    return dict(model=GRANITE if granite else {"mlp": MLP},
                data="tokens" if granite else "mlp", algorithm=algorithm,
                driver=driver, seed=1, rounds=rounds, channel=CHANNEL,
                # FID (a stand-in reading the gathered generator) on the
                # 16-bit runs of the MLP-GAN, every second round
                eval_every=2 if bits == 16 and not granite else 0,
                # granite on SGD: Adam's first step divides a gradient
                # by its own size, so an element whose gradient is
                # round-off moves by up to the learning rate
                pcfg=dict(PCFG, schedule=schedule, quantize_bits=bits,
                          scheduler="round_robin", scheduling_ratio=0.5,
                          n_d=1 if granite else 2,
                          optimizer="sgd" if granite else "adam"))


def _jax_pcfg(case):
    return JaxProtocolConfig(**PCFG, schedule=case.schedule,
                             quantize_bits=case.bits)


def _jax_state(algorithm):
    make = (jfedgan.make_fedgan_state if algorithm == "fedgan"
            else jprotocol.make_train_state)
    return jax.device_get(make(KEY, lambda k: jgan.mlp_gan_init(k, **MLP),
                               JaxProtocolConfig(**PCFG), K))


def _payload(algorithm):
    return (jshard.FEDGAN_PAYLOAD if algorithm == "fedgan"
            else jshard.PROPOSED_PAYLOAD)


def _draws(case):
    st = _jax_state(case.algorithm)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(
        _payload(case.algorithm)(st)))
    draws = JaxDraws(KEY, ProtocolConfig(**PCFG, schedule=case.schedule,
                                         quantize_bits=case.bits),
                     8, N_LOCAL, n_params).for_key(ROUND_KEY)
    return {f.name: (getattr(draws, f.name).numpy()
                     if torch.is_tensor(getattr(draws, f.name))
                     else getattr(draws, f.name))
            for f in dataclasses.fields(draws)}


def _expand(entry, stacked):
    """Every leaf of a state entry as (K, TP, ...local): per-device
    entries split over K, TP-named leaves into their two shards, the
    rest broadcast."""
    dims = jrules.tp_tree_dims(entry, TP)
    leaves, treedef = jax.tree_util.tree_flatten(entry)
    out = []
    for x, d in zip(leaves, dims):
        x = np.asarray(x)
        if not stacked:
            x = np.broadcast_to(x, (K,) + x.shape)
        if d is None:
            x = np.broadcast_to(x[:, None], (K, TP) + x.shape[1:])
        else:
            x = np.stack(np.split(x, TP, axis=d), axis=1)
        out.append(jnp.asarray(x))
    return jax.tree_util.tree_unflatten(treedef, out)


def _join(entry_kt, like):
    """Worker k's global entry from (K, TP, ...) slices: (K, ...) leaves,
    the shards concatenated on their dim (rank 0's for the rest)."""
    dims = jrules.tp_tree_dims(like, TP)
    leaves, treedef = jax.tree_util.tree_flatten(entry_kt)
    out = []
    for x, d in zip(leaves, dims):
        x = np.asarray(x)
        out.append(x[:, 0] if d is None else np.concatenate(
            [x[:, r] for r in range(TP)], axis=d))
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.cache
def jax_tp_round(name):
    """The JAX package's TP slice round of the case under nested vmap:
    (new state as (K, ...) global entries, metrics (K, TP))."""
    case = ROUND_CASES[name]
    fedgan = case.algorithm == "fedgan"
    jstate = _jax_state(case.algorithm)
    keys = jshard.FEDGAN_STACKED_KEYS if fedgan else jshard.PROPOSED_STACKED_KEYS
    ctx = jshard.TpCtx("model", TP, jrules.tp_tree_dims(
        _payload(case.algorithm)(jstate), TP))
    body = functools.partial(
        jshard._fedgan_slice_round if fedgan else jshard._proposed_slice_round,
        jgan.mlp_gan_spec(d_z=8, tp_axis="model"), _jax_pcfg(case), "data",
        None, None, case.impl, ctx)

    def slice_round(st, data_k, w_k):
        my = jax.lax.axis_index("data")
        weights = jax.lax.all_gather(w_k, "data")
        wsum = jax.lax.psum(w_k.astype(jnp.float32), "data")
        return body(my, st, data_k, w_k, weights, wsum, ROUND_KEY)

    expanded = {k: _expand(v, k in keys) for k, v in jstate.items()}
    data = jnp.broadcast_to(jnp.asarray(_data())[:, None],
                            (K, TP) + _data().shape[1:])
    w = jnp.broadcast_to(jnp.asarray(case.weights, jnp.float32)[:, None],
                         (K, TP))
    new_st, metrics = jax.vmap(jax.vmap(slice_round, axis_name="model"),
                               axis_name="data")(expanded, data, w)
    unstacked = {k: (jax.tree.map(lambda x: x[0], v) if k in keys else v)
                 for k, v in jstate.items()}
    return ({k: _join(v, unstacked[k]) for k, v in new_st.items()},
            jax.device_get(metrics))


def _mlp_params():
    rng = np.random.default_rng(5)
    return {"w_in": rng.standard_normal((12, 8)).astype(np.float32) * .3,
            "w_gate": rng.standard_normal((12, 8)).astype(np.float32) * .3,
            "w_out": rng.standard_normal((8, 12)).astype(np.float32) * .3}


def _mlp_io():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((3, 5, 12)).astype(np.float32),
            rng.standard_normal((3, 5, 12)).astype(np.float32))


# ---------------------------------------------------------------------------
# The one spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{part: [result on rank 0, ..., on rank 3]} for every port
    computation of this module, from one spawn of K x TP gloo ranks."""
    states = {alg: _jax_state(alg) for alg in ("proposed", "fedgan")}
    rounds = [dict(algorithm=c.algorithm, impl=c.impl,
                   pcfg=dict(PCFG, schedule=c.schedule,
                             quantize_bits=c.bits),
                   w=np.asarray(c.weights, np.float32), draws=_draws(c))
              for c in ROUND_CASES.values()]
    ckpt_dir = tmp_path_factory.mktemp("tp_ckpt")
    x, cot = _mlp_io()
    parts = {
        "collectives": ("tp_collectives", (_mlp_params(), x, cot)),
        "rounds": ("tp_round_cases", (states, _data(), rounds)),
        "trainers": ("tp_trainer_runs", (
            {"mlp": _data(), "tokens": _tokens()},
            [_run(n) for n in TRAINER_RUNS])),
        "checkpoint": ("tp_checkpoint", (_data(), CKPT_RUN, str(ckpt_dir))),
    }
    init = tmp_path_factory.mktemp("tp_mesh") / "init"
    per_rank = mesh.spawn(functools.partial(torch_mesh_ranks.suite, parts),
                          K * TP, device="cpu", init_method=f"file://{init}",
                          timeout_s=TIMEOUT_S, tp=TP)
    out = {part: [r[part] for r in per_rank] for part in parts}
    out["ckpt_dir"] = str(ckpt_dir)
    return out


def _unshard(shards, like):
    """The global tree from the two model ranks' shards (numpy trees)."""
    dims = rules.tp_tree_dims(like, TP)
    return rules.unshard_tree([interop.to_torch(s, "cpu") for s in shards],
                              dims)


# ---------------------------------------------------------------------------
# nn.tp and the TP MLP
# ---------------------------------------------------------------------------

def test_tp_collectives_forward_and_backward(ranks):
    """reduce_from_tp sums the model group's tensors; copy_to_tp's
    backward sums the cotangents; gather_from_tp concatenates and hands
    each rank its own slice of the cotangent; tp_rank is the model
    rank. Each model group is on its own."""
    for g, out in enumerate(ranks["collectives"]):
        k, r = divmod(g, TP)
        base = np.arange(6, dtype=np.float32).reshape(2, 3)
        mine = lambda rr: base * (rr + 1) + k
        np.testing.assert_array_equal(out["reduce"], mine(0) + mine(1))
        np.testing.assert_array_equal(out["copy_grad"],
                                      np.full((2, 3), 2.0 + 3.0))
        np.testing.assert_array_equal(
            out["gather"], np.concatenate([mine(0), mine(1)], axis=0))
        weights = np.arange(12, dtype=np.float32).reshape(4, 3)
        np.testing.assert_array_equal(out["gather_grad"],
                                      weights[2 * r:2 * r + 2])
        assert out["tp_rank"] == r


def test_tp_mlp_forward_and_gradients_match_the_plain_mlp(ranks):
    """The TP SwiGLU block on each rank's shards: the output and dx on
    every rank, and the weight gradients put back together, against the
    plain block's (autograd on one process) to f32 round-off. dx
    checks copy_to_tp's backward all-reduce, the gradient JAX found
    silently dropped without it."""
    params = interop.to_torch(_mlp_params(), "cpu")
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x, cot = (torch.from_numpy(a) for a in _mlp_io())
    x.requires_grad_(True)
    y = mlp.mlp_apply(params, x)
    (y * cot).sum().backward()
    for k in range(K):
        outs = ranks["collectives"][k * TP:(k + 1) * TP]
        for out in outs:
            np.testing.assert_allclose(out["y"], y.detach().numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out["dx"], x.grad.numpy(),
                                       rtol=1e-5, atol=1e-5)
        grads = _unshard([o["grads"] for o in outs], params)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), params[name].grad.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        assert outs[0]["grads"]["w_out"].shape == (4, 12)   # half of d_ff


# ---------------------------------------------------------------------------
# The slice rounds against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_tp_mesh_round_matches_jax_tp_slice_round(ranks, name):
    """Worker k's state, its shards put back together from its two
    model ranks, against JAX slice k: the uploaded nets to one
    quantization step (the quantized uplink is bit for bit the same
    given the same values), the rest to 1e-5; metrics to 1e-5 on every
    rank; the two workers' globals agree."""
    case = ROUND_CASES[name]
    i = list(ROUND_CASES).index(name)
    jst, jm = jax_tp_round(name)
    fedgan = case.algorithm == "fedgan"
    quantized = ("gen", "disc") if fedgan else ("disc",)
    like = _jax_state(case.algorithm)
    per_rank = ranks["rounds"]
    for k in range(K):
        pair = [per_rank[k * TP + r][i] for r in range(TP)]
        for part in jst:
            ref = jax.tree.map(lambda x: x[k], jst[part])
            unstacked_like = (jax.tree.map(lambda x: x[0], like[part])
                              if part in (shard_round.FEDGAN_STACKED_KEYS
                                          if fedgan else
                                          shard_round.PROPOSED_STACKED_KEYS)
                              else like[part])
            got = _unshard([st[part] for st, _ in pair], unstacked_like)
            if part in quantized and case.bits < 32:
                quant_step_close(got, ref, atol=1e-6)
            else:
                for a, b in zip(tree_leaves(got),
                                jax.tree_util.tree_leaves(ref)):
                    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                               atol=1e-5, err_msg=part)
        for r, (_, metrics) in enumerate(pair):
            assert set(metrics) == set(jm)
            for key, value in metrics.items():
                np.testing.assert_allclose(value, float(jm[key][k, r]),
                                           rtol=0, atol=1e-5)
    for r in range(TP):          # both workers hold the same globals
        a, b = per_rank[r][i][0], per_rank[TP + r][i][0]
        for part in ("gen", "disc"):
            for x, y in zip(tree_leaves(a[part]), tree_leaves(b[part])):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Trainer(layout="mesh", tp=2) against the stacked tp=1 Trainer
# ---------------------------------------------------------------------------

def _stacked_trainer(run):
    from torch_mesh_ranks import _tp_model
    spec, init_fn = _tp_model(run["model"], 1)
    data = {"mlp": _data(), "tokens": _tokens()}[run["data"]]
    return Trainer(spec, ProtocolConfig(**run["pcfg"]), init_fn, data,
                   seed=run["seed"], algorithm=run["algorithm"],
                   driver=run["driver"], device="cpu",
                   channel_cfg=ChannelConfig(**run["channel"]))


@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_tp_mesh_trainer_matches_stacked_trainer(ranks, name):
    """Every rank's history against the stacked Trainer's: masks,
    weights and the wallclock bit for bit (the channel times the
    worker's whole model), metrics within 1e-4, FIDs of the gathered
    generator within 1e-5 relative where a run takes them; the gathered
    global
    state within 5e-5 at 16 bits (2e-5 at 32), one quantization step
    on the quantized nets, as JAX's tp=2 against tp=1 test; the MLP
    leaves are half-width on each rank."""
    run = _run(name)
    stacked = _stacked_trainer(run)
    want = stacked.run(run["rounds"], eval_every=run["eval_every"],
                       fid_fn=torch_mesh_ranks.weights_fid)
    i = list(TRAINER_RUNS).index(name)
    atol = 5e-5 if run["pcfg"]["quantize_bits"] < 32 else 2e-5
    assert any(not rec.mask.all() for rec in want)    # a worker sat out
    for per_run in ranks["trainers"]:
        hist, state, shard_shapes = per_run[i]
        assert len(hist) == len(want)
        for rec, (mask, weights, metrics, wall, cum, fid) in zip(want,
                                                                 hist):
            assert (fid is None) == (rec.fid is None)
            if fid is not None:
                np.testing.assert_allclose(fid, rec.fid, rtol=1e-5)
            np.testing.assert_array_equal(mask, rec.mask)
            np.testing.assert_array_equal(weights, rec.weights)
            assert (wall, cum) == (rec.wallclock_s, rec.cumulative_s)
            assert metrics.keys() == rec.metrics.keys()
            for key, value in rec.metrics.items():
                assert abs(metrics[key] - value) < 1e-4, (key, metrics[key],
                                                          value)
        state = interop.to_torch(state, "cpu")
        quantized = ("gen", "disc") if run["algorithm"] == "fedgan" else (
            "disc",)
        for part in stacked.state:
            if part in quantized and run["pcfg"]["quantize_bits"] < 32:
                quant_step_close(state[part],
                                 interop.to_numpy(stacked.state[part]),
                                 atol=atol)
            else:
                for a, b in zip(tree_leaves(state[part]),
                                tree_leaves(stacked.state[part])):
                    torch.testing.assert_close(a, b, rtol=0, atol=atol)
        if shard_shapes is not None:
            assert shard_shapes == {"w_in": (DIM, HID // TP),
                                    "w_out": (HID // TP, 1)}


def test_tp_spec_and_trainer_refuse_as_jax():
    """The JAX Trainer's and builders' refusals at tp > 1: a dense spec on
    a TP mesh, MoE and fuse_proj backbones, faults or a robust reducer,
    the ring; and tp_mesh_error without a model group."""
    with pytest.raises(ValueError, match="fuse_proj=True cannot"):
        tspecs.make_backbone_spec(dataclasses.replace(
            get_arch_config("qwen3-1.7b").reduced(), fuse_proj=True), 8,
            tp_axis="model")
    moe = dataclasses.replace(get_arch_config("qwen3-1.7b").reduced(),
                              family="moe", moe=object())
    with pytest.raises(ValueError, match="MoE feed-forward has no"):
        tspecs.make_backbone_spec(moe, 8, tp_axis="model")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        shard_round.check_faults_tp(None, object(), 2)
    with pytest.raises(NotImplementedError, match="worker-global"):
        shard_round.check_ring_support("ring", 2, None, None)
    assert "model process group of size 2" in mesh.tp_mesh_error(None, 2)
    assert mesh.tp_mesh_error(None, 1) is None
    with pytest.raises(ValueError, match="tp must be >= 1"):
        Trainer(tgan.mlp_gan_spec(), ProtocolConfig(**PCFG),
                lambda g: tgan.mlp_gan_init(g, **MLP), _data(), tp=0,
                device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints across tp widths and packages
# ---------------------------------------------------------------------------

def test_tp2_checkpoint_is_global_and_restores_at_tp1_and_in_jax(ranks):
    """Written at tp=2 by rank (0, 0) alone: global shapes (a stacked
    tp=1 Trainer's), restored bit for bit by a tp=1 mesh Trainer on
    every rank (its worker's slice) which then runs round 1, by a
    stacked Trainer, and by the JAX package's Trainer."""
    d = ranks["ckpt_dir"]
    paths = [path for _, _, _, path in ranks["checkpoint"]]
    assert paths[0].endswith("ckpt_00000001.npz")
    assert paths[1:] == [None] * (K * TP - 1)
    tree, step, _ = checkpoint.load_checkpoint(d)
    assert step == 1
    before = ranks["checkpoint"][0][0]
    for a, b in zip(tree_leaves(before), tree_leaves(tree["state"])):
        np.testing.assert_array_equal(a, b)
    stacked = _stacked_trainer(dict(CKPT_RUN, data="mlp"))
    assert ([tuple(x.shape) for x in tree_leaves(tree["state"])]
            == [tuple(x.shape) for x in tree_leaves(stacked.state)])
    for g, (_, restored, (t, mask, _), _) in enumerate(ranks["checkpoint"]):
        k = g // TP
        for key, entry in restored.items():
            want = tree["state"][key]
            if key in shard_round.PROPOSED_STACKED_KEYS:
                want = jax.tree.map(lambda x: x[k], want)
            for a, b in zip(tree_leaves(entry), tree_leaves(want)):
                np.testing.assert_array_equal(a, b)
        assert t == 1
    stacked.restore(d)
    for a, b in zip(tree_leaves(stacked.state), tree_leaves(tree["state"])):
        np.testing.assert_array_equal(a.numpy(), b)
    jtrainer = JaxTrainer(
        jgan.mlp_gan_spec(d_z=8), JaxProtocolConfig(**CKPT_RUN["pcfg"]),
        lambda k: jgan.mlp_gan_init(k, **MLP), jnp.asarray(_data()), KEY,
        channel_cfg=JaxChannelConfig(**CHANNEL), driver="host")
    assert jtrainer.restore(d) == 1
    for a, b in zip(jax.tree_util.tree_leaves(jtrainer.state),
                    tree_leaves(tree["state"])):
        np.testing.assert_array_equal(np.asarray(a), b)
