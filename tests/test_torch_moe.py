"""Port parity: the routed feed-forward (`repro_torch.nn.moe`) and the MoE
backbone-GAN (reduced granite-moe-3b-a800m, reduced mixtral-8x22b's
config) against the JAX package.

The same parameters (the port's seeded draws, carried by
`repro_torch.interop`) and the same inputs (numpy, seeded) go through
`repro.nn.moe` and its port. The discrete outcome of a dispatch, which
(token, slot) pairs keep a place in their expert's buffer and at which
position, is held bit for bit: the expert buffers themselves (every
row a token's input, or zeros) are compared exactly, JAX's read where
it hands them to the experts (`jax.vmap` of the expert MLP). Token rows
are distinct, so equal buffers mean the same kept pairs at the same
positions. Values, the aux loss and gradients: 1e-5 (float32 sums in
another order); the backbone forwards 1e-4 relative and 1e-5 absolute;
the round as tests/test_torch_dense_backbone.py holds it.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs import get_arch_config as jget_arch_config
from repro.models import backbone as jbackbone
from repro.nn import moe as jmoe
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.configs import get_arch_config
from repro_torch.models import backbone as tbackbone
from repro_torch.models import gan as tgan
from repro_torch.nn import moe
from repro_torch.tree import tree_leaves
from test_torch_dense_backbone import round_matches_jax
from test_torch_serving_engine import (level0_jax_engine,  # noqa: F401
                                       make_engine, model, prompts,
                                       serve_all)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D, F, E, TOP_K = 16, 24, 4, 2


@functools.cache
def params():
    """The port's seeded MoE block as numpy."""
    return interop.to_numpy(moe.moe_init(torch.Generator().manual_seed(0),
                                         D, F, E))


def normals(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class _RecordingJax:
    """The `jax` module as `repro.nn.moe` sees it, with `vmap` recording
    the batched input of what it maps: the expert buffers."""

    def __init__(self, buffers):
        self.buffers = buffers

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn):
        mapped = jax.vmap(fn)

        def call(p, x):
            self.buffers.append(np.asarray(x))
            return mapped(p, x)
        return call


def run_both(x, monkeypatch, **kw):
    """JAX's and the port's moe_apply on x with the same parameters:
    ((y, aux, expert buffers) of JAX, (y, aux, buffers) of the port);
    JAX's buffers as (E, rows, d)."""
    jbufs, tbufs = [], []
    monkeypatch.setattr(jmoe, "jax", _RecordingJax(jbufs))
    jy, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, params()),
                              jnp.asarray(x), n_experts=E, top_k=TOP_K, **kw)
    monkeypatch.undo()
    experts = moe._experts
    monkeypatch.setattr(moe, "_experts", lambda p, b: (
        tbufs.append(b.detach().numpy().copy()), experts(p, b))[1])
    ty, taux = moe.moe_apply(interop.to_torch(params(), "cpu"),
                             torch.tensor(x), n_experts=E, top_k=TOP_K, **kw)
    monkeypatch.undo()
    (jbuf,), (tbuf,) = jbufs, tbufs
    return ((np.asarray(jy), float(jaux), jbuf.reshape(E, -1, D)),
            (ty.numpy(), float(taux), tbuf))


# (b, s, moe_apply keywords): groups with padded tokens (2 x 37 tokens in
# groups of 16), a capacity of 1 a group (factor 0.1) that forces drops,
# and dropless below, at and above _DROPLESS_EXACT_LIMIT (b s top_k of
# 4,060, 4,096 and 4,160: sort, sort, then einsum with factor 2)
DISPATCH_CASES = {
    "einsum": (2, 37, dict(group_size=16)),
    "sort": (2, 37, dict(group_size=16, dispatch="sort")),
    "einsum-drops": (3, 20, dict(group_size=64, capacity_factor=0.1)),
    "sort-drops": (3, 20, dict(group_size=64, capacity_factor=0.1,
                               dispatch="sort")),
    "dropless-under": (2, 1015, dict(group_size=64, dropless=True)),
    "dropless-at": (2, 1024, dict(group_size=64, dropless=True)),
    "dropless-over": (2, 1040, dict(group_size=64, dropless=True)),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_matches_jax(case, monkeypatch):
    """The expert buffers bit for bit (the kept pairs and their
    positions), the output and the aux loss to 1e-5."""
    b, s, kw = DISPATCH_CASES[case]
    x = normals(b, s, D, seed=1)
    (jy, jaux, jbuf), (ty, taux, tbuf) = run_both(x, monkeypatch, **kw)
    assert tbuf.shape == jbuf.shape
    np.testing.assert_array_equal(tbuf, jbuf)
    kept = int((np.abs(tbuf).sum(-1) > 0).sum())
    pairs = b * s * TOP_K
    if "drops" in case:
        assert kept < pairs // 2                  # capacity binds
    elif case.startswith("dropless"):
        assert kept == pairs                      # every pair routed
        # up to the limit a buffer of every pair, the padded tokens' too
        # (2,048 tokens); past it 33 groups of 64 at capacity 64
        assert tbuf.shape[1] == {"dropless-under": 4096, "dropless-at": 4096,
                                 "dropless-over": 33 * 64}[case]
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    assert abs(taux - jaux) <= 1e-5


def test_route_matches_jax_and_ties_take_the_lower_expert():
    """Probabilities, gates and the aux loss to 1e-5, the expert indices
    and their one-hots bit for bit; with experts 1 and 3 given the same
    router column every token ties between them, and the lower index
    comes first, as with `jax.lax.top_k`."""
    p = params()
    tied = dict(p, router=p["router"].copy())
    tied["router"][:, 3] = tied["router"][:, 1]
    x = normals(40, D, seed=2)
    for tree in (p, tied):
        want = jmoe._route(jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.asarray(x), E, 3)
        got = moe._route(interop.to_torch(tree, "cpu"), torch.tensor(x), E,
                         3)
        for g, w in zip(got, want):
            if g.dtype == torch.int64:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)
    probs, idx = got[0].numpy(), got[2].numpy()
    assert (probs[:, 1] == probs[:, 3]).all()
    # expert 3 is never chosen without expert 1, and never before it
    one, three = (idx == 1).any(-1), (idx == 3).any(-1)
    assert three.sum() > 10 and not (three & ~one).any()
    assert (np.argmax(idx[three] == 1, -1)
            < np.argmax(idx[three] == 3, -1)).all()


@pytest.mark.parametrize("case", ["sort", "einsum-drops"])
def test_gradients_match_jax_grad(case):
    """Gradients of sum(y * w) + aux into the router, every expert leaf
    and x, against `jax.grad`, to 1e-5."""
    b, s, kw = DISPATCH_CASES[case]
    x = normals(b, s, D, seed=3)
    w = normals(b, s, D, seed=4)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, n_experts=E, top_k=TOP_K, **kw)
        return jnp.sum(y * w) + aux

    jp = jax.tree_util.tree_map(jnp.asarray, params())
    want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = interop.to_torch(params(), "cpu")
    tx = torch.tensor(x)
    leaves = tree_leaves(tp) + [tx]
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, aux = moe.moe_apply(tp, tx, n_experts=E, top_k=TOP_K, **kw)
    got = torch.autograd.grad((y * torch.tensor(w)).sum() + aux, leaves)
    for g, ref in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The MoE backbone-GAN
# ---------------------------------------------------------------------------

@functools.cache
def cfgs(name):
    return (jget_arch_config(name).reduced(), get_arch_config(name).reduced())


@functools.cache
def gan_params(name):
    return interop.to_numpy(tgan.gan_init(torch.Generator().manual_seed(0),
                                          cfgs(name)[1]))


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_configs_and_backbone_forwards_match_jax(name):
    """The configs field for field, full and reduced; the reduced
    backbone's leaf shapes in JAX's leaf order; its forwards, train
    (capacity dispatch) and prefill (dropless, with the caches), against
    `backbone_apply`: hidden states, the summed aux loss and the caches.
    48 tokens: granite-moe's groups of 64 pad; mixtral's window of 8
    binds."""
    for full in (False, True):
        got, want = (get(name) if full else get(name).reduced()
                     for get in (get_arch_config, jget_arch_config))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    jcfg, tcfg = cfgs(name)
    shapes = jax.eval_shape(lambda k: jbackbone.backbone_init(k, jcfg),
                            jax.random.PRNGKey(0))
    tparams = tgan.gan_init(torch.Generator().manual_seed(0),
                            tcfg)["gen"]["backbone"]
    assert ([tuple(x.shape) for x in tree_leaves(tparams)]
            == [x.shape for x in jax.tree_util.tree_leaves(shapes)])
    params = gan_params(name)["gen"]["backbone"]
    h = normals(2, 48, tcfg.d_model, seed=5)
    for mode in ("train", "prefill"):
        want = jbackbone.backbone_apply(
            jax.tree_util.tree_map(jnp.asarray, params), jcfg,
            jnp.asarray(h), mode=mode, remat=False)
        with torch.no_grad():
            got = tbackbone.backbone_apply(interop.to_torch(params, "cpu"),
                                           tcfg, torch.tensor(h), mode=mode)
        assert float(got["aux"]) > 0
        tree = {"h": got["h"], "aux": got["aux"]}
        ref = {"h": want["h"], "aux": want["aux"]}
        if mode == "prefill":
            tree["caches"], ref["caches"] = got["caches"], want["caches"]
        got_leaves = tree_leaves(tree)
        want_leaves = jax.tree_util.tree_leaves(ref)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_moe_gan_round_matches_jax():
    """One parallel Adam round of the reduced granite-moe-3b-a800m
    backbone-GAN (K=3, one local and one server step of one sample,
    16-bit uplink) from the same state and draws; the aux loss is
    dropped by the spec, as in JAX."""
    round_matches_jax(*cfgs("granite-moe-3b-a800m"),
                      gan_params("granite-moe-3b-a800m"), 24)


def test_moe_engine_tokens_match_jax_engine(level0_jax_engine):  # noqa: F811
    """Reduced granite-moe-3b-a800m served by the port's engine, paged
    and dense, and by the JAX engine: the same greedy tokens, which are
    those of the full dropless forward (mode="prefill"; the training
    forward drops tokens at capacity)."""
    name = "granite-moe-3b-a800m"
    cfg, params = model(name)
    # prompts of whole 4-token chunks or one padded: two step programs
    work = [(p, 5, 0.0) for p in prompts(cfg.vocab, (4, 8, 3), 0)]
    kw = dict(batch_size=2, max_len=32, prefill_chunk=4)
    jeng = JServingEngine(jget_arch_config(name).reduced(),
                          jax.tree_util.tree_map(jnp.asarray, params),
                          block_size=8, **kw)
    for i, (p, n, _) in enumerate(work):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
    want = {r.rid: list(r.out_tokens) for r in jeng.run()}
    for block_size in (8, None):
        got = serve_all(make_engine(name, block_size=block_size, **kw), work)
        assert got == want and len(got) == 3
    tparams = interop.to_torch(params, "cpu")
    for i, (p, n, _) in enumerate(work):
        toks = torch.tensor(p, dtype=torch.int64)[None]
        with torch.no_grad():
            for _ in range(n):
                logits = tgan.generator_lm_apply(tparams, cfg, toks,
                                                 mode="prefill")["logits"]
                toks = torch.cat([toks, logits[:, -1:].argmax(-1)], dim=1)
        assert want[i] == toks[0, len(p):].tolist()
