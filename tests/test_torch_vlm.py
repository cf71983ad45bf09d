"""Port parity: the vision family (llama-3.2-vision-90b: a group of four
self-attention layers and one gated cross-attention layer over image
embeddings, with its own gated MLP) against the JAX package.

Reduced llama-3.2-vision-90b (one group, d_model 256, 8 heads of 32
over 8 kv heads, vocab 512) with image embeddings drawn by numpy and
passed to both packages. Both gates start at 0 (tanh(0) hides the cross
layer and the gradients of its weights), so every comparison sets them
to 0.5 and -0.4 in the parameters both packages start from (the port's
seeded ones, carried by `repro_torch.interop`). Tolerances: forwards 1e-4
relative and 1e-5 absolute; the SGD round as
tests/test_torch_dense_backbone.py holds it; served tokens bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_arch_config as jget_arch_config
from repro.models import gan as jgan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.configs import get_arch_config
from repro_torch.core import protocol
from repro_torch.examples import train_distgan
from repro_torch.models import gan as tgan
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves
from test_torch_checkpoint import level0
from test_torch_dense_backbone import round_matches_jax
from test_torch_serving_engine import level0_jax_engine  # noqa: F401
from test_torch_serving_engine import prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "llama-3.2-vision-90b"
KEY = jax.random.PRNGKey(0)


@functools.cache
def cfgs(n_image_tokens=None):
    """(JAX config, port config): reduced llama-3.2-vision-90b, one group
    in both nets, at n_image_tokens (the reduced config's 8 by
    default)."""
    changes = {"disc_layers": None}
    if n_image_tokens is not None:
        changes["n_image_tokens"] = n_image_tokens
    return tuple(dataclasses.replace(get(NAME).reduced(), **changes)
                 for get in (jget_arch_config, get_arch_config))


def open_gates(params):
    """The gates of every cross layer set to 0.5 and -0.4 (tanh 0.46 and
    -0.38), in place; returns params."""
    for net in [params[k] for k in ("gen", "disc") if k in params] or [
            params]:
        for sub in net["backbone"]["groups"].values():
            if "gate_attn" in sub:
                sub["gate_attn"][...] = 0.5
                sub["gate_ff"][...] = -0.4
    return params


@functools.cache
def gan_params():
    return open_gates(interop.to_numpy(tgan.gan_init(
        torch.Generator().manual_seed(0), cfgs()[1])))


def normals(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got_tree, want_tree, rtol=1e-4, atol=1e-5):
    got = tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("cut", [False, True])
def test_vlm_config_and_tree_match_jax(cut):
    """The config field for field, full and reduced; the backbone-GAN's
    tree (on fake tensors) against `jax.eval_shape` of the JAX init:
    structure and every leaf's shape in JAX's leaf order (the cross
    layer's scalar gates, stacked to one a group, its own feed-forward),
    at full width and depth, and at the chip's cut: one group in G and D
    at vocab 32,768, with its sizes."""
    for full in (False, True):
        got, want = (get(NAME) if full else get(NAME).reduced()
                     for get in (get_arch_config, jget_arch_config))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.group_pattern == want.group_pattern == ("attn",) * 4 + (
            "cross",)
    cfg = get_arch_config(NAME)
    if cut:
        cfg = dataclasses.replace(cfg, n_layers=5, disc_layers=None,
                                  vocab=32_768)
    shapes = jax.eval_shape(lambda k: jgan.gan_init(k, cfg), KEY)
    with FakeTensorMode():
        params = tgan.gan_init(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda x: 0, params)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, shapes)))
    assert ([tuple(x.shape) for x in tree_leaves(params)]
            == [x.shape for x in jax.tree_util.tree_leaves(shapes)])
    cross = params["gen"]["backbone"]["groups"]["sub4"]
    assert cross["gate_attn"].shape == (cfg.n_groups_stack,)
    if cut:
        assert (protocol.count_params(params["gen"]),
                protocol.count_params(params["disc"])) == (
                    4_883_308_546, 4_613_832_706)
        with FakeTensorMode():
            served = tgan.generator_lm_init(
                torch.Generator().manual_seed(0),
                dataclasses.replace(cfg, vocab=128_256))
        assert protocol.count_params(served) == 6_447_783_938


def test_vlm_forwards_match_jax():
    """Both nets at 520 tokens over 520 image tokens (the causal
    self-attention and the cross-attention on the flash branch), and the
    generator as an LM: a prefill of 12 tokens over 8 image tokens (its
    caches: four self-attention k/v and the cross layer's projected
    image k/v) and two decode steps, which equal the full forward."""
    jcfg, tcfg = cfgs(520)
    params = gan_params()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = interop.to_torch(params, "cpu")
    img = normals(1, 520, tcfg.d_model, seed=1)
    z = normals(1, 520, tcfg.d_z, seed=2)
    want = level0(lambda p, z, e: jgan.generator_apply(
        p, jcfg, z, enc_feats=e, remat=False)[0])(
        jp["gen"], jnp.asarray(z), jnp.asarray(img))
    with torch.no_grad():
        fake, _ = tgan.generator_apply(tp["gen"], tcfg, torch.tensor(z),
                                       enc_feats=torch.tensor(img))
    close(fake, want)
    want = level0(lambda p, x, e: jgan.discriminator_apply(
        p, jcfg, x, enc_feats=e, remat=False)[0])(
        jp["disc"], want, jnp.asarray(img))
    with torch.no_grad():
        logits, _ = tgan.discriminator_apply(tp["disc"], tcfg, fake,
                                             enc_feats=torch.tensor(img))
    close(logits, want)

    jcfg, tcfg = cfgs()
    img = normals(2, tcfg.n_image_tokens, tcfg.d_model, seed=3)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 14))
    with torch.no_grad():
        full = tgan.generator_lm_apply(tp["gen"], tcfg, torch.tensor(toks),
                                       enc_feats=torch.tensor(img))
        out = tgan.generator_lm_apply(tp["gen"], tcfg,
                                      torch.tensor(toks[:, :12]),
                                      mode="prefill",
                                      enc_feats=torch.tensor(img),
                                      prefill_cache_len=16)
    jout = level0(lambda p, x, e: jgan.generator_lm_apply(
        p, jcfg, x, mode="prefill", enc_feats=e, prefill_cache_len=16))(
        jp["gen"], jnp.asarray(toks[:, :12]), jnp.asarray(img))
    close(out, jout)
    caches, jcaches = out["caches"], jout["caches"]
    jdecode = level0(lambda p, x, c, i: jgan.generator_lm_apply(
        p, jcfg, x, mode="decode", caches=c, cache_index=i))
    for i in (12, 13):
        with torch.no_grad():
            out = tgan.generator_lm_apply(
                tp["gen"], tcfg, torch.tensor(toks[:, i:i + 1]),
                mode="decode", caches=caches, cache_index=i)
        jout = jdecode(jp["gen"], jnp.asarray(toks[:, i:i + 1]), jcaches, i)
        jcaches = jout["caches"]
        close(out["logits"], jout["logits"])
        torch.testing.assert_close(out["logits"][:, 0],
                                   full["logits"][:, i], rtol=1e-5,
                                   atol=1e-5)


def test_vlm_gan_round_matches_jax():
    """One parallel SGD round (K=3, 16-bit uplink) at seq_len 24 over 8
    image tokens, the gates open, from the same state and draws: the
    gradients reach the gates and the cross layer's weights (each moves
    off its start), and both nets agree with JAX's."""
    jcfg, tcfg = cfgs()
    state = round_matches_jax(jcfg, tcfg, gan_params(), 24, optimizer="sgd",
                              enc_feats=normals(1, tcfg.n_image_tokens,
                                                tcfg.d_model, seed=5))
    for net in ("gen", "disc"):
        start = gan_params()[net]["backbone"]["groups"]["sub4"]
        end = state[net]["backbone"]["groups"]["sub4"]
        for name in ("gate_attn", "gate_ff"):
            assert float(np.abs(end[name].numpy() - start[name]).max()) > 0
        for name in ("wk", "wv", "wq"):
            moved = np.abs(end["attn"][name].numpy() - start["attn"][name])
            assert float(moved.max()) > 1e-6, (net, name)


def test_vlm_engine_tokens_match_jax_engine(level0_jax_engine):  # noqa: F811
    """The generator served by the port's engine, paged and dense (the
    cross cache dense, filled once from the image embeddings), and by
    the JAX engine: the same greedy tokens, and those of the full
    forward."""
    jcfg, tcfg = cfgs()
    params = open_gates(interop.to_numpy(tgan.generator_lm_init(
        torch.Generator().manual_seed(1), tcfg)))
    img = normals(1, tcfg.n_image_tokens, tcfg.d_model, seed=6)
    work = prompts(tcfg.vocab, (4, 8, 3), 2)
    kw = dict(batch_size=2, max_len=24, prefill_chunk=4)
    jeng = JServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                          block_size=8, enc_feats_fn=lambda n: jnp.asarray(
                              img), **kw)
    for i, p in enumerate(work):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: list(r.out_tokens) for r in jeng.run()}
    tparams = interop.to_torch(params, "cpu")
    for block_size in (8, None):
        eng = ServingEngine(tcfg, tparams, block_size=block_size,
                            device="cpu",
                            enc_feats_fn=lambda n: torch.tensor(img), **kw)
        if block_size:
            assert sorted(eng._paged_subs) == [f"sub{i}" for i in range(4)]
        for i, p in enumerate(work):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        assert {r.rid: list(r.out_tokens) for r in eng.run()} == want
    for i, p in enumerate(work):
        toks = torch.tensor(p, dtype=torch.int64)[None]
        with torch.no_grad():
            for _ in range(5):
                logits = tgan.generator_lm_apply(
                    tparams, tcfg, toks, enc_feats=torch.tensor(img))[
                        "logits"]
                toks = torch.cat([toks, logits[:, -1:].argmax(-1)], dim=1)
        assert want[i] == toks[0, len(p):].tolist()


def test_train_distgan_twin_runs_a_round_on_both_drivers(capsys):
    """`python -m repro_torch.examples.train_distgan` on the CPU: one
    round of reduced llama-3.2-vision-90b with the stub image embeddings,
    on the host and the fused driver, the same metrics and FID."""
    hist = {driver: train_distgan.main(
        ["--arch", NAME, "--rounds", "1", "--devices", "2", "--seq-len",
         "8", "--driver", driver, "--device", "cpu"])
        for driver in ("host", "fused")}
    for a, b in zip(hist["host"], hist["fused"]):
        assert a.metrics == b.metrics and a.fid == b.fid
        assert np.isfinite(a.fid)
        assert all(np.isfinite(v) for v in a.metrics.values())
    assert "llama-3.2-vision-90b (vlm)" in capsys.readouterr().out
