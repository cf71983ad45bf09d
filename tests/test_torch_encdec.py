"""Port parity: the encoder-decoder family (whisper-base: LayerNorm, the
bidirectional encoder, the decoder's cross-attention to its states)
against the JAX package.

Reduced whisper-base (2 decoder and 2 encoder layers, d_model 256, 8
heads of 32, vocab 512) with the stub frontend's features drawn by
numpy and passed to both packages. The forwards run the encoder over
520 frames, so its self-attention and the decoder's cross-attention of
520 tokens take the flash branch (the kernel wrapper's plain version);
the round runs at the reduced config's 16 frames. Both packages start
from the port's seeded parameters (carried by `repro_torch.interop`).
Tolerances: forwards 1e-4 relative and 1e-5 absolute; the round as
tests/test_torch_dense_backbone.py holds it.
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
from repro.models import backbone as jbackbone
from repro.models import gan as jgan
from repro.nn import norms as jnorms
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.configs import get_arch_config
from repro_torch.core import protocol
from repro_torch.models import backbone as tbackbone
from repro_torch.models import gan as tgan
from repro_torch.models import specs as tspecs
from repro_torch.nn import norms
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves
from test_torch_checkpoint import level0
from test_torch_dense_backbone import round_matches_jax
from test_torch_serving_engine import level0_jax_engine  # noqa: F401
from test_torch_serving_engine import prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "whisper-base"
KEY = jax.random.PRNGKey(0)


@functools.cache
def cfgs(enc_seq=None):
    """(JAX config, port config): reduced whisper-base, its encoder at
    enc_seq frames (the reduced config's 16 by default)."""
    return tuple(dataclasses.replace(
        get(NAME).reduced(), **({} if enc_seq is None else
                                {"enc_seq": enc_seq}))
        for get in (jget_arch_config, get_arch_config))


@functools.cache
def gan_params():
    """The port's seeded backbone-GAN, as numpy; LayerNorm's scales and
    biases moved off 1 and 0, so that they are exercised."""
    params = interop.to_numpy(tgan.gan_init(torch.Generator().manual_seed(0),
                                            cfgs()[1]))
    rng = np.random.default_rng(9)
    for path in (("gen", "encoder", "layers", "ln_attn"),
                 ("gen", "backbone", "groups", "sub1", "ln"),
                 ("disc", "encoder", "final_norm")):
        leaf = functools.reduce(dict.__getitem__, path, params)
        leaf["scale"] += 0.3 * rng.standard_normal(leaf["scale"].shape)
        leaf["bias"] += 0.3 * rng.standard_normal(leaf["bias"].shape)
    return params


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


def test_whisper_config_and_tree_match_jax():
    """The config field for field, full and reduced; the backbone-GAN's
    tree at full width and depth (on fake tensors) against `jax.eval_
    shape` of the JAX init: structure, every leaf's shape in JAX's leaf
    order (each net's encoder, LayerNorm's scale and bias, the decoder's
    cross sublayer without a feed-forward), and the sizes; and the stub
    frontend's features."""
    for full in (False, True):
        got, want = (get(NAME) if full else get(NAME).reduced()
                     for get in (get_arch_config, jget_arch_config))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.group_pattern == want.group_pattern == ("attn", "cross")
    cfg = get_arch_config(NAME)
    shapes = jax.eval_shape(lambda k: jgan.gan_init(k, cfg), KEY)
    with FakeTensorMode():
        params = tgan.gan_init(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda x: 0, params)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, shapes)))
    assert ([tuple(x.shape) for x in tree_leaves(params)]
            == [x.shape for x in jax.tree_util.tree_leaves(shapes)])
    assert set(params["gen"]["backbone"]["groups"]["sub1"]) == {"ln", "attn"}
    assert (protocol.count_params(params["gen"]),
            protocol.count_params(params["gen"]["encoder"]),
            protocol.count_params(params["disc"])) == (
                97_577_984, 18_915_328, 70_958_080)
    feats = tspecs.make_stub_enc_feats(cfg, device="cpu")
    x = feats(3)
    assert x.shape == (3, 1500, 512) and torch.equal(x[0], x[2])
    assert torch.equal(x, tspecs.make_stub_enc_feats(cfg, device="cpu")(3))
    assert tspecs.make_stub_enc_feats(get_arch_config("qwen3-1.7b")) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """LayerNorm in float32 with eps 1e-5 (not the config's norm_eps),
    the result in x's dtype."""
    x = normals(3, 5, 64, seed=1) * 3 + 1
    p = {"scale": normals(64, seed=2), "bias": normals(64, seed=3)}
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jnorms.layernorm_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x, jdtype))
    got = norms.layernorm_apply(interop.to_torch(p, "cpu"),
                                torch.tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6 if dtype == "float32" else 0)
    assert set(norms.layernorm_init(8)) == {"scale", "bias"}


def test_encoder_and_backbone_forwards_match_jax():
    """The encoder over 520 frames (bidirectional self-attention on the
    flash branch, at explicit positions) and the decoder backbone on its
    states, against `encoder_apply` and `backbone_apply`: train at 520
    tokens (causal self-attention and the 520 x 520 cross-attention on
    the flash branch), prefill at 24 (its caches: each self-attention's
    k/v and each cross sublayer's projected k/v of 520 frames) and two
    decode steps from those caches, the cross caches left as they are."""
    jcfg, tcfg = cfgs(520)
    params = gan_params()["gen"]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = interop.to_torch(params, "cpu")
    feats = normals(1, 520, tcfg.d_model, seed=1)
    want_enc = level0(lambda p, f: jbackbone.encoder_apply(
        p, jcfg, f, remat=False))(jp["encoder"], jnp.asarray(feats))
    with torch.no_grad():
        enc = tbackbone.encoder_apply(tp["encoder"], tcfg,
                                      torch.tensor(feats))
    close(enc, want_enc)
    enc_h = np.asarray(want_enc)
    h = normals(1, 520, tcfg.d_model, seed=2)
    want = level0(lambda p, x, e: jbackbone.backbone_apply(
        p, jcfg, x, enc_h=e, remat=False)["h"])(
        jp["backbone"], jnp.asarray(h), jnp.asarray(enc_h))
    with torch.no_grad():
        got = tbackbone.backbone_apply(tp["backbone"], tcfg, torch.tensor(h),
                                       enc_h=torch.tensor(enc_h))["h"]
    close(got, want)
    want = level0(lambda p, x, e: jbackbone.backbone_apply(
        p, jcfg, x, mode="prefill", enc_h=e, prefill_cache_len=32))(
        jp["backbone"], jnp.asarray(h[:, :24]), jnp.asarray(enc_h))
    with torch.no_grad():
        got = tbackbone.backbone_apply(
            tp["backbone"], tcfg, torch.tensor(h[:, :24]), mode="prefill",
            enc_h=torch.tensor(enc_h), prefill_cache_len=32)
    close(got, want)
    assert got["caches"]["sub1"]["k"].shape == (2, 1, 520, 8, 32)
    cross = [t.clone() for t in tree_leaves(got["caches"]["sub1"])]
    jcaches, tcaches = want["caches"], got["caches"]
    jdecode = level0(lambda p, x, c, i: jbackbone.backbone_apply(
        p, jcfg, x, mode="decode", caches=c, cache_index=i))
    for i in (24, 25):
        x = normals(1, 1, tcfg.d_model, seed=i)
        want = jdecode(jp["backbone"], jnp.asarray(x), jcaches, i)
        jcaches = want["caches"]
        with torch.no_grad():
            got = tbackbone.backbone_apply(tp["backbone"], tcfg,
                                           torch.tensor(x), mode="decode",
                                           caches=tcaches, cache_index=i)
        close(got, want)
    assert all(torch.equal(a, b) for a, b in
               zip(cross, tree_leaves(tcaches["sub1"])))


def test_prefill_and_decode_give_the_full_forward():
    """The generator as an LM: a prefill of 10 tokens (the encoder run
    over the features) and three decode steps (the encoder skipped: the
    cross caches hold its states) give the logits of the full forward
    over the 13 tokens, and JAX's decode logits."""
    jcfg, tcfg = cfgs()
    params = gan_params()["gen"]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = interop.to_torch(params, "cpu")
    feats = normals(2, tcfg.enc_seq, tcfg.d_model, seed=4)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 13))
    with torch.no_grad():
        full = tgan.generator_lm_apply(tp, tcfg, torch.tensor(toks),
                                       enc_feats=torch.tensor(feats))
        out = tgan.generator_lm_apply(tp, tcfg, torch.tensor(toks[:, :10]),
                                      mode="prefill",
                                      enc_feats=torch.tensor(feats),
                                      prefill_cache_len=16)
    torch.testing.assert_close(out["logits"], full["logits"][:, :10],
                               rtol=1e-5, atol=1e-5)
    jout = level0(lambda p, x, e: jgan.generator_lm_apply(
        p, jcfg, x, mode="prefill", enc_feats=e, prefill_cache_len=16))(
        jp, jnp.asarray(toks[:, :10]), jnp.asarray(feats))
    jdecode = level0(lambda p, x, c, i: jgan.generator_lm_apply(
        p, jcfg, x, mode="decode", caches=c, cache_index=i))
    close(out["logits"], jout["logits"])
    caches, jcaches = out["caches"], jout["caches"]
    for i in range(10, 13):
        with torch.no_grad():
            # no features: decode must not run the encoder
            out = tgan.generator_lm_apply(tp, tcfg, torch.tensor(
                toks[:, i:i + 1]), mode="decode", caches=caches,
                cache_index=i)
        torch.testing.assert_close(out["logits"][:, 0],
                                   full["logits"][:, i], rtol=1e-5,
                                   atol=1e-5)
        jout = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches, i)
        jcaches = jout["caches"]
        close(out["logits"], jout["logits"])
    with pytest.raises(ValueError, match="encoder features"):
        tgan.generator_lm_apply(tp, tcfg, torch.tensor(toks))


def test_whisper_gan_round_matches_jax():
    """One parallel Adam round (K=3, 16-bit uplink) at seq_len 24, both
    nets encoding the same 16 frames with their own encoders (D's under
    its config), each group recomputed in the backward in both
    packages. The cross-attention's key bias has no gradient in exact
    arithmetic (no RoPE: it shifts all of a query's scores alike), so
    Adam turns each package's round-off into steps of up to lr: it is
    held to the Adam bound alone."""
    jcfg, tcfg = cfgs()
    round_matches_jax(jcfg, tcfg, gan_params(), 24, remat=True,
                      enc_feats=normals(1, tcfg.enc_seq, tcfg.d_model,
                                        seed=6),
                      zero_grad=[("backbone", "groups", "sub1", "attn",
                                  "bk")])


def test_whisper_engine_tokens_match_jax_engine(level0_jax_engine):  # noqa: F811
    """The generator served by the port's engine, paged and dense (its
    cross caches dense, filled once through the encoder), and by the JAX
    engine from the same features: the same greedy tokens."""
    jcfg, tcfg = cfgs()
    params = gan_params()["gen"]
    feats = normals(1, tcfg.enc_seq, tcfg.d_model, seed=7)
    work = prompts(tcfg.vocab, (4, 7, 3), 1)
    kw = dict(batch_size=2, max_len=24, prefill_chunk=4)
    jeng = JServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                          block_size=8, enc_feats_fn=lambda n: jnp.asarray(
                              feats), **kw)
    for i, p in enumerate(work):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    want = {r.rid: list(r.out_tokens) for r in jeng.run()}
    for block_size in (8, None):
        eng = ServingEngine(tcfg, interop.to_torch(params, "cpu"),
                            block_size=block_size, device="cpu",
                            enc_feats_fn=lambda n: torch.tensor(feats), **kw)
        for i, p in enumerate(work):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        assert {r.rid: list(r.out_tokens) for r in eng.run()} == want
    with pytest.raises(ValueError, match="enc_feats_fn"):
        ServingEngine(tcfg, interop.to_torch(params, "cpu"), device="cpu")
