"""Port parity: the launch layer's step builders (`repro_torch.launch.
steps`) against `repro.launch.steps` — the abstract inputs of the train
(stacked and mesh), prefill and decode steps, the bfloat16 start state,
one bfloat16 round of the stacked train step against the JAX package's
`protocol.gan_round` (what its launch train step computes, without its
sharding constraints), and prefill plus one decode step against
`generator_lm_apply` in bfloat16.

The JAX builders run on a (1, 1) host mesh, for their abstract inputs
only. The rounds start from the same bfloat16 state (the JAX package's
cast of the port's float32 init) and consume the JAX package's draws
(its bfloat16 noise); JAX compiles at XLA backend optimisation level 0.

Tolerances of the bfloat16 round (`round_matches_jax`), measured on
reduced granite-3-2b at seq_len 520 (the flash branch) and reduced
mamba2-130m, K=2, one local and one server SGD step, at the launch
step's learning rate 2e-4 and at WIDE_LR = 0.1, where the updates span
many bfloat16 steps (at 2e-4 most are below one step of their
parameter, so the values alone would not show a wrong gradient):
- the objectives within 1.8e-3 relative (held to 2e-2);
- at 2e-4, every leaf's elements that did not start at zero within two
  bfloat16 steps of JAX's (the spacing at the larger magnitude) on at
  least 99.992 % of each leaf (held to 99.9 %). Elements that start at
  zero (mamba2's conv_b, A_log's log(1)) hold this round's update
  alone, whose bfloat16 gradient differs from JAX's by a few per cent of
  itself: XLA keeps float32 between the fused elementwise operations
  that torch rounds to bfloat16 one by one;
- at both rates, each leaf's update (new - start) against JAX's beyond
  one step of rounding (`update_norms`): at most 5.4e-2 of the norm of
  JAX's update (mamba2 at 2e-4; 2.3e-2 at 0.1; granite 4e-4 and
  2.2e-2), held to UPDATE_TOL = 0.1. Each of three faults planted in
  the port fails it: the flash backward without its softmax-Jacobian
  term (0.53), the RMSNorm variance detached (0.35; granite's two-step
  check fails too), the SSD scan without B's gradient (0.13).
Prefill and decode logits: within 2e-2 of the logits' largest magnitude
(bfloat16 activations through two layers).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import ml_dtypes
import torch

from repro.configs import get_arch_config as jget_arch_config
from repro.configs.base import MeshConfig as JaxMeshConfig
from repro.configs.base import ProtocolConfig as JaxProtocolConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.core import protocol as jprotocol
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import gan as jgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.configs import ShapeConfig, get_arch_config
from repro_torch.core import protocol as tprotocol
from repro_torch.launch import steps
from repro_torch.models import gan as tgan
from repro_torch.tree import tree_leaves, tree_map
from test_torch_checkpoint import level0
from test_torch_protocol import JaxDraws
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEY = jax.random.PRNGKey(0)
ARCHS = ("granite-3-2b", "mamba2-130m", "whisper-base")


@functools.cache
def cfgs(name):
    return jget_arch_config(name).reduced(), get_arch_config(name).reduced()


@functools.cache
def host_mesh():
    return make_mesh((1, 1), ("data", "model"))


def described(tree):
    """A tree's leaves as (path, shape, dtype name), in the JAX package's
    leaf order (dict keys sorted), for JAX stand-ins and meta tensors."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", s, d) for k in sorted(tree)
                for p, s, d in described(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", s, d) for i, c in enumerate(tree)
                for p, s, d in described(c)]
    dtype = str(tree.dtype).replace("torch.", "")
    return [("", tuple(tree.shape), dtype)]


def to_numpy(tree):
    """`interop.to_numpy` that also carries bfloat16 leaves (as
    ml_dtypes bfloat16 arrays, bit for bit)."""
    return tree_map(lambda x: x.view(torch.int16).numpy().view(
        ml_dtypes.bfloat16) if x.dtype == torch.bfloat16 else
        x.detach().numpy(), tree)


def shapes(kind, seq=64, batch=2):
    return (JaxShapeConfig(kind, seq, batch, kind),
            ShapeConfig(kind, seq, batch, kind))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_abstract_args_are_the_jax_builders(name, kind):
    """The stacked train, prefill and decode steps' abstract inputs
    (`input_specs`, `build_step`'s) have the JAX builders' tree, shapes
    and dtypes (K = 1, the host mesh's one device), bfloat16 state and
    parameters included."""
    jcfg, tcfg = cfgs(name)
    jshape, tshape = shapes(kind)
    jargs = jsteps.input_specs(jcfg, jshape, host_mesh(), JaxMeshConfig())
    targs = steps.input_specs(tcfg, tshape, 1)
    assert all(x.device.type == "meta" for x in tree_leaves(targs))
    assert described(targs) == described(jargs)


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_abstract_args_are_the_jax_builders(name):
    """The mesh layout's (state, sched_carry, tokens, seed, start_round):
    JAX's shapes and dtypes, but for the seed, an integer where JAX
    takes a PRNG key. The conditioned families raise, as in JAX."""
    jcfg, tcfg = cfgs(name)
    jshape, tshape = shapes("train", seq=520)
    if name == "whisper-base":
        for build, args in ((jsteps.build_train_step,
                             (jcfg, jshape, host_mesh(), JaxMeshConfig())),
                            (steps.build_train_step, (tcfg, tshape, 1))):
            with pytest.raises(NotImplementedError, match="encdec"):
                build(*args, layout="mesh")
        return
    _, jargs = jsteps.build_train_step(jcfg, jshape, host_mesh(),
                                       JaxMeshConfig(), layout="mesh")
    _, targs = steps.build_train_step(tcfg, tshape, 1, layout="mesh")
    assert described([targs[i] for i in (0, 1, 2, 4)]) == described(
        [jargs[i] for i in (0, 1, 2, 4)])
    assert targs[3].shape == () and not targs[3].is_floating_point()


def test_bf16_start_state_is_the_jax_cast_bit_for_bit():
    """`_bf16_floats` of the float32 init, as the CLI casts it, is the
    JAX CLI's `jnp.asarray(x, bfloat16)` bit for bit; integers stay."""
    _, tcfg = cfgs("granite-3-2b")
    pcfg = tprotocol.ProtocolConfig(n_devices=2, optimizer="adam")
    state = tprotocol.make_train_state(
        lambda g: tgan.gan_init(g, tcfg), pcfg, 2, device="cpu")
    got = steps._bf16_floats(state)
    want = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16) if np.issubdtype(
            x.dtype, np.floating) else jnp.asarray(x),
        interop.to_numpy(state))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def bf16_step(x, y):
    """The bfloat16 spacing at the larger of |x| and |y|, elementwise."""
    mag = np.maximum(np.abs(x), np.abs(y))
    return 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)


def _leaves(port_tree, ref_tree, start_tree=None):
    """(port, reference, start) leaves as float32 numpy arrays; the port's
    must be bfloat16."""
    starts = (tree_leaves(start_tree) if start_tree is not None
              else [None] * len(tree_leaves(port_tree)))
    for x, y, x0 in zip(tree_leaves(port_tree), tree_leaves(ref_tree),
                        starts):
        assert x.dtype == torch.bfloat16
        y = (y.float().numpy() if torch.is_tensor(y)
             else np.asarray(y).astype(np.float32))
        yield (x.float().numpy(), y,
               None if x0 is None else x0.float().numpy())


def within_two_steps(port_tree, ref_tree, start_tree, share=0.999):
    """Each leaf within two bfloat16 steps of the reference on at least
    `share` of its elements that did not start at zero (an element that
    did holds this round's update alone, held by `update_residuals`)."""
    for x, y, x0 in _leaves(port_tree, ref_tree, start_tree):
        ok = (np.abs(x - y) <= 2 * bf16_step(x, y))[x0 != 0]
        assert ok.size == 0 or ok.mean() >= share, (x.shape, (~ok).sum(),
                                                    ok.size)


def update_norms(port_tree, ref_tree, start_tree):
    """Per leaf, how far the port's update (new - start) lies from the
    reference's beyond the rounding of the stored results: (the norm of
    each element's |port - reference| less one bfloat16 step, at least 0
    (two roundings to bfloat16 of the same float32 value differ by
    less), the norm of the reference's update)."""
    out = []
    for x, y, x0 in _leaves(port_tree, ref_tree, start_tree):
        out.append((float(np.linalg.norm(np.maximum(
            np.abs(x - y) - bf16_step(x, y), 0.0))),
            float(np.linalg.norm(y - x0))))
    return out


def update_residuals(port_tree, ref_tree, start_tree):
    """`update_norms`' residual over the reference update, leaf by leaf
    (inf where the reference leaves a leaf unmoved and the port moves it
    by more than a step)."""
    return [r / u if u > 0 else (0.0 if r == 0 else np.inf)
            for r, u in update_norms(port_tree, ref_tree, start_tree)]


ONE_STEP = {"n_d": 1, "n_g": 1}
# the learning rate of the update check: every leaf that moves, moves by
# many bfloat16 steps of its elements on the discriminator's head
WIDE_LR = 0.1
UPDATE_TOL = 0.1


def round_matches_jax(name, seq):
    """One round of the stacked train step (the launch pcfg with one
    local and one server step, K=2, one sample a device) from the
    bfloat16 state against JAX's `gan_round` with
    `make_backbone_spec(dtype=bfloat16)` on the same state and draws,
    at the launch step's learning rate and at WIDE_LR (one JAX compile,
    the rate a weakly typed argument), held as the module docstring
    says."""
    k = 2
    jcfg, tcfg = cfgs(name)
    shape = ShapeConfig("t", seq, k, "train")
    step, args = steps.build_train_step(tcfg, shape, k,
                                        pcfg_overrides=ONE_STEP)
    pcfg = step.pcfg
    assert pcfg.lr_d == pcfg.lr_g
    jpcfg = JaxProtocolConfig(**dataclasses.asdict(pcfg))
    start = steps._bf16_floats(tprotocol.make_train_state(
        lambda g: tgan.gan_init(g, tcfg), pcfg, k, device="cpu"))
    assert described(start) == described(args[0])
    jstate = to_numpy(start)
    jspec = jspecs.make_backbone_spec(jcfg, seq, dtype=jnp.bfloat16)
    data = np.random.default_rng(0).integers(
        0, jcfg.vocab, (k, 1, seq)).astype(np.int32)
    w = np.ones(k, np.float32)
    round_key = jax.random.PRNGKey(3)
    jround = level0(lambda s, d, w, key, lr: jprotocol.gan_round(
        jspec, dataclasses.replace(jpcfg, lr_d=lr, lr_g=lr), s, d, w, key))
    draws = JaxDraws(KEY, pcfg, jcfg.d_z, 1,
                     tprotocol.count_params(start["disc"]),
                     sample_z=lambda key, n: jspec.sample_z(key, n).astype(
                         jnp.float32)).for_key(round_key)
    draws = dataclasses.replace(draws, z_dev=draws.z_dev.bfloat16(),
                                z_srv=draws.z_srv.bfloat16())
    for lr in (pcfg.lr_d, WIDE_LR):
        jnew, jm = jround(jstate, jnp.asarray(data), jnp.asarray(w),
                          round_key, lr)
        run, _ = steps.build_train_step(
            tcfg, shape, k, pcfg_overrides={**ONE_STEP, "lr_d": lr,
                                            "lr_g": lr})
        run.sampler = lambda t: draws
        new, metrics = run(tree_map(torch.clone, start),
                           {"tokens": torch.tensor(data)}, torch.tensor(w),
                           3)
        for name_ in ("disc_objective", "gen_objective", "participation"):
            np.testing.assert_allclose(float(metrics[name_]),
                                       float(jm[name_]), rtol=2e-2)
        for part in ("gen", "disc"):
            within = jax.tree.map(np.asarray, jnew[part])
            if lr == pcfg.lr_d:
                within_two_steps(new[part], within, start[part])
            residuals = update_residuals(new[part], within, start[part])
            assert max(residuals) <= UPDATE_TOL, (part, lr, residuals)


@pytest.mark.parametrize("name,seq", [("mamba2-130m", 64)])
def test_bf16_round_matches_jax_gan_round(name, seq):
    """`round_matches_jax` on reduced mamba2-130m (reduced granite-3-2b
    at seq_len 520, the flash branch, is in test_torch_launch_round.py:
    each file's JAX compiles stay within its time)."""
    round_matches_jax(name, seq)


def test_adam_on_the_bf16_state_raises_as_in_jax():
    """Adam's float32 update would turn the bfloat16 parameters float32:
    JAX's `gan_round` refuses it while tracing (its local steps are a
    `lax.scan`, whose carry must keep its dtype) and the port's step
    raises TypeError at the first update (`optim.apply_updates`); SGD
    keeps the state bfloat16 in both."""
    jcfg, tcfg = cfgs("mamba2-130m")
    shape = ShapeConfig("t", 16, 2, "train")
    for optimizer in ("adam", "sgd"):
        step, args = steps.build_train_step(
            tcfg, shape, 2, pcfg_overrides={"n_d": 1, "n_g": 1,
                                            "optimizer": optimizer})
        jpcfg = JaxProtocolConfig(**dataclasses.asdict(step.pcfg))
        jstate = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            a.shape, jnp.dtype(str(a.dtype).replace("torch.", ""))),
            to_numpy(tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                              args[0])))
        jspec = jspecs.make_backbone_spec(jcfg, 16, dtype=jnp.bfloat16)
        run = lambda s: jprotocol.gan_round(
            jspec, jpcfg, s, jnp.zeros((2, 1, 16), jnp.int32),
            jnp.ones(2), KEY)
        state = steps._bf16_floats(tprotocol.make_train_state(
            lambda g: tgan.gan_init(g, tcfg), step.pcfg, 2, device="cpu"))
        batch = {"tokens": torch.zeros((2, 1, 16), dtype=torch.int32)}
        if optimizer == "adam":
            with pytest.raises(TypeError, match="scan"):
                jax.eval_shape(run, jstate)
            with pytest.raises(TypeError, match="scan"):
                step(state, batch, torch.ones(2), 0)
        else:
            jout = jax.eval_shape(run, jstate)[0]
            new, _ = step(state, batch, torch.ones(2), 0)
            assert described(new) == described(jout)


def test_fused_chunk_is_the_chained_single_rounds():
    """fuse_rounds=2 (rounds 5 and 6 through `core.graphs.RoundGraph`,
    uncaptured on the CPU) gives two chained single-round steps bit for
    bit: metrics and every leaf. Reduced granite at seq_len 16."""
    _, tcfg = cfgs("granite-3-2b")
    shape = ShapeConfig("t", 16, 4, "train")
    overrides = {"n_d": 1, "n_g": 1}
    fused, _ = steps.build_train_step(tcfg, shape, 2, fuse_rounds=2,
                                      pcfg_overrides=overrides)
    single, _ = steps.build_train_step(tcfg, shape, 2,
                                       pcfg_overrides=overrides)
    init = lambda: steps._bf16_floats(tprotocol.make_train_state(
        lambda g: tgan.gan_init(g, tcfg), fused.pcfg, 2, device="cpu"))
    tokens = torch.randint(0, tcfg.vocab, (2, 2, 16),
                           generator=torch.Generator().manual_seed(1))
    batch, w = {"tokens": tokens.int()}, torch.full((2,), 2.0)
    got, gm = fused(init(), batch, w, 5)
    want = init()
    wm = []
    for r in (5, 6):
        want, m = single(want, batch, w, r)
        wm.append(m)
    for k, v in gm.items():
        assert v.shape == (2,)
        assert torch.equal(v, torch.stack([m[k].float() for m in wm]))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["granite-3-2b", "mamba2-130m"])
def test_prefill_and_decode_match_jax_in_bf16(name):
    """The prefill step's last logits and caches, then one decode step
    from them, against JAX's `generator_lm_apply` on the same bfloat16
    parameters and tokens (the JAX steps' own calls)."""
    jcfg, tcfg = cfgs(name)
    b, s = 2, 24
    shape = ShapeConfig("p", s, b, "prefill")
    prefill, pargs = steps.build_prefill_step(tcfg, shape)
    decode, dargs = steps.build_decode_step(
        tcfg, dataclasses.replace(shape, kind="decode"))
    params = steps._bf16_floats(tgan.generator_init(
        torch.Generator().manual_seed(0), tcfg))
    assert described(params) == described(pargs[0])
    jparams = to_numpy(params)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (b, s)).astype(np.int32)
    logits, caches = prefill(params, {"tokens": torch.tensor(tokens)})
    jout = level0(lambda p, t: jgan.generator_lm_apply(
        p, jcfg, t, mode="prefill", remat=False, prefill_cache_len=s))(
            jparams, jnp.asarray(tokens))
    want = np.asarray(jout["logits"][:, -1, :]).astype(np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=2e-2 * scale)
    # the prefill's caches are the decode step's (its abstract caches'
    # tree, shapes and dtypes); one decode step at the last slot, as the
    # JAX package computes it
    assert described(caches) == described(dargs[2])
    nxt = np.argmax(want, axis=-1).astype(np.int32)[:, None]
    jd = level0(lambda p, t, c: jgan.generator_lm_apply(
        p, jcfg, t, mode="decode", caches=c, cache_index=s - 1,
        remat=False))(jparams, jnp.asarray(nxt), jout["caches"])
    dlogits, _ = decode(params, torch.tensor(nxt), caches, s - 1)
    want = np.asarray(jd["logits"][:, 0, :]).astype(np.float32)
    np.testing.assert_allclose(dlogits.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
