"""Port parity: the hybrid family (zamba2-2.7b: Mamba-2 layers and one
shared attention + MLP block called once a group) against the JAX
package.

The reduced config runs at 2 groups (12 Mamba-2 layers, the shared
block called twice), so the shared block's gradient sums two calls. Both
packages start from the port's seeded parameters (carried by
`repro_torch.interop`; the shared block's per-group subtree is empty,
`sub6: {}`, as JAX's) and consume the same inputs. Tolerances: forwards
1e-4 relative and 1e-5 absolute, the round as
tests/test_torch_dense_backbone.py holds it; checkpoints bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ProtocolConfig as JaxProtocolConfig
from repro.configs import get_arch_config as jget_arch_config
from repro.core.engine import Trainer as JaxTrainer
from repro.models import backbone as jbackbone
from repro.models import gan as jgan
from repro.models import specs as jspecs
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.configs import ProtocolConfig, get_arch_config
from repro_torch.core import Trainer, protocol
from repro_torch.models import backbone as tbackbone
from repro_torch.models import gan as tgan
from repro_torch.models import specs as tspecs
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves
from test_torch_checkpoint import level0
from test_torch_dense_backbone import round_matches_jax
from test_torch_serving_engine import level0_jax_engine  # noqa: F401
from test_torch_serving_engine import prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "zamba2-2.7b"
KEY = jax.random.PRNGKey(0)


@functools.cache
def cfgs():
    """(JAX config, port config): reduced zamba2-2.7b at 2 groups."""
    return tuple(dataclasses.replace(get(NAME).reduced(), n_layers=12)
                 for get in (jget_arch_config, get_arch_config))


@functools.cache
def gan_params():
    return interop.to_numpy(tgan.gan_init(torch.Generator().manual_seed(0),
                                          cfgs()[1]))


def normals(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("groups", [2, 9])
def test_zamba2_config_and_tree_match_jax(groups):
    """The config field for field, full and reduced; the backbone-GAN's
    tree at full width (on fake tensors) and reduced: JAX's structure,
    the empty per-group subtree of the shared block included, and every
    leaf's shape in JAX's leaf order."""
    for full in (False, True):
        got, want = (get(NAME) if full else get(NAME).reduced()
                     for get in (get_arch_config, jget_arch_config))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.group_pattern == want.group_pattern == ("ssm",) * 6 + (
            "shared_attn",)
    for reduced in (False, True):
        tcfg, jcfg = (dataclasses.replace(
            get(NAME).reduced() if reduced else get(NAME),
            n_layers=6 * groups) for get in (get_arch_config,
                                             jget_arch_config))
        shapes = jax.eval_shape(lambda k: jgan.gan_init(k, jcfg), KEY)
        with FakeTensorMode():
            params = tgan.gan_init(torch.Generator().manual_seed(0), tcfg)
        structure = jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, params))
        assert structure == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, shapes))
        assert params["gen"]["backbone"]["groups"]["sub6"] == {}
        assert ([tuple(x.shape) for x in tree_leaves(params)]
                == [x.shape for x in jax.tree_util.tree_leaves(shapes)])
        if groups == 2 and not reduced:   # chip_smoke.py's cut
            sizes = tuple(protocol.count_params(params[p])
                          for p in ("gen", "disc"))
            assert sizes == (754_245_440, 672_000_320)


def test_zamba2_forwards_match_jax():
    """The 2-group backbone, train and prefill, against `backbone_apply`:
    hidden states and the prefill caches (a Mamba-2 state and conv carry
    a layer, a k/v cache a shared-block call); 24 tokens, the last chunk
    of 16 ragged."""
    jcfg, tcfg = cfgs()
    params = gan_params()["gen"]["backbone"]
    h = normals(2, 24, tcfg.d_model, seed=1)
    for mode in ("train", "prefill"):
        want = level0(lambda p, x: jbackbone.backbone_apply(
            p, jcfg, x, mode=mode, remat=False))(
                jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(h))
        with torch.no_grad():
            got = tbackbone.backbone_apply(interop.to_torch(params, "cpu"),
                                           tcfg, torch.tensor(h), mode=mode)
        tree, ref = {"h": got["h"]}, {"h": want["h"]}
        if mode == "prefill":
            tree["caches"], ref["caches"] = got["caches"], want["caches"]
            assert set(got["caches"]) == {f"sub{i}" for i in range(7)}
        got_leaves = tree_leaves(tree)
        want_leaves = jax.tree_util.tree_leaves(ref)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_shared_block_gradient_sums_its_calls():
    """The 2-group backbone of the real 6:1 groups: its gradients into
    every leaf against `jax.grad` of `backbone_apply`, each leaf's within
    1e-4 of its largest magnitude, the forwards' relative tolerance
    (float32 sums over 20 tokens and 12 Mamba-2 layers in another order,
    JAX's order hanging on XLA's CPU threads: at most 9.2e-6 on one core
    and 2.2e-5 on eight when written); with
    each group recomputed in the backward (`torch.utils.checkpoint`, the
    shared leaves passed in) equal to those without, bit for bit; the
    shared block's the sum of its two calls, not the first call's
    alone."""
    jcfg, tcfg = cfgs()
    params = gan_params()["gen"]["backbone"]
    tparams = interop.to_torch(params, "cpu")
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    h, w = (normals(1, 20, tcfg.d_model, seed=s) for s in (2, 3))
    grads = [torch.autograd.grad((tbackbone.backbone_apply(
        tparams, cfg, torch.tensor(h), remat=remat)["h"]
        * torch.tensor(w)).sum(), leaves, allow_unused=True,
        materialize_grads=True)
        for cfg, remat in ((tcfg, True), (tcfg, False),
                           (dataclasses.replace(tcfg, n_layers=6), True))]
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    want = jax.tree_util.tree_leaves(level0(jax.grad(
        lambda p, x: jnp.sum(jbackbone.backbone_apply(
            p, jcfg, x, remat=False)["h"] * w)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(h)))
    assert len(want) == len(leaves)
    for g, ref in zip(grads[0], want):
        ref = np.asarray(ref)
        assert g.shape == ref.shape
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    wq = [i for i, x in enumerate(leaves)
          if x is tparams["shared"]["attn"]["wq"]][0]
    assert float((grads[0][wq] - grads[2][wq]).abs().max()) > 1e-3


def test_zamba2_gan_round_matches_jax():
    """One parallel Adam round (K=3, one local and one server step of one
    sample, 16-bit uplink: one scale a leaf, the empty subtree holding
    none) from the same state and draws, at seq_len 24, each group
    recomputed in the backward in both packages: the reduced zamba2-2.7b
    cut to groups of one Mamba-2 layer and the shared block, 2 groups,
    so that the shared block's gradient (into Adam) sums two calls. (The
    6-layer group's round compiles for a minute in JAX; its gradients are
    held to `jax.grad` in `test_shared_block_gradient_sums_its_calls`.)"""
    jcfg, tcfg = (dataclasses.replace(cfg, attn_every=1, n_layers=2)
                  for cfg in cfgs())
    params = interop.to_numpy(tgan.gan_init(torch.Generator().manual_seed(0),
                                            tcfg))
    round_matches_jax(jcfg, tcfg, params, 24, remat=True)


def test_zamba2_checkpoint_crosses_packages(tmp_path):
    """A JAX Trainer's checkpoint restores into the port's Trainer bit for
    bit, and the port's into JAX's: the state's structure (the empty
    `sub6` subtrees of G, D and the Adam moments) and every leaf."""
    jcfg, tcfg = cfgs()
    kw = dict(n_devices=2, n_d=1, n_g=1, sample_size=1,
              server_sample_size=1, optimizer="adam")
    data = np.random.default_rng(4).integers(
        0, tcfg.vocab, (2, 2, 8)).astype(np.int32)
    params = gan_params()
    jtr = JaxTrainer(jspecs.make_backbone_spec(jcfg, 8), JaxProtocolConfig(
        **kw), lambda k: jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(data), KEY, driver="host")
    ttr = Trainer(tspecs.make_backbone_spec(tcfg, 8), ProtocolConfig(**kw),
                  lambda g: interop.to_torch(params, "cpu"), data, seed=1,
                  driver="host", device="cpu")
    jtr.save_checkpoint(str(tmp_path / "jax"))
    assert ttr.restore(str(tmp_path / "jax")) == 0
    want = jax.device_get(jtr.state)
    assert (jax.tree_util.tree_structure(interop.to_numpy(ttr.state))
            == jax.tree_util.tree_structure(want))
    for g, w in zip(tree_leaves(ttr.state), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert ttr.state["disc"]["backbone"]["groups"]["sub6"] == {}
    with torch.no_grad():
        for leaf in tree_leaves(ttr.state):
            if leaf.is_floating_point():
                leaf.add_(0.5)
    ttr.save_checkpoint(str(tmp_path / "port"))
    assert jtr.restore(str(tmp_path / "port")) == 0
    for g, w in zip(tree_leaves(ttr.state),
                    jax.tree_util.tree_leaves(jax.device_get(jtr.state))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_zamba2_engine_tokens_match_jax_engine(level0_jax_engine):  # noqa: F811
    """The 1-group reduced zamba2-2.7b generator served by the port's
    engine, paged (each shared-block call its own pool) and dense, and
    by the JAX engine: the same greedy tokens, the full forward's."""
    cfg = get_arch_config(NAME).reduced()
    params = interop.to_numpy(tgan.generator_lm_init(
        torch.Generator().manual_seed(0), cfg))
    # prompts of whole 4-token chunks or one padded: two step programs
    work = prompts(cfg.vocab, (4, 8, 3), 0)
    kw = dict(batch_size=2, max_len=32, prefill_chunk=4)
    jeng = JServingEngine(jget_arch_config(NAME).reduced(),
                          jax.tree_util.tree_map(jnp.asarray, params),
                          block_size=8, **kw)
    for i, p in enumerate(work):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: list(r.out_tokens) for r in jeng.run()}
    tparams = interop.to_torch(params, "cpu")
    for block_size in (8, None):
        eng = ServingEngine(cfg, tparams, block_size=block_size,
                            device="cpu", **kw)
        if block_size:
            assert sorted(eng._paged_subs) == ["sub6"]
        for i, p in enumerate(work):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        assert {r.rid: list(r.out_tokens) for r in eng.run()} == want
    for i, p in enumerate(work):
        toks = torch.tensor(p, dtype=torch.int64)[None]
        with torch.no_grad():
            for _ in range(5):
                logits = tgan.generator_lm_apply(tparams, cfg, toks,
                                                 mode="train")["logits"]
                toks = torch.cat([toks, logits[:, -1:].argmax(-1)], dim=1)
        assert want[i] == toks[0, len(p):].tolist()
