"""Port parity: the backbone-GAN on mamba2-130m (the `ssm` family) against
the JAX package — configs, parameter trees, forwards, one protocol round,
the Trainer's host driver, token data and token FID.

The reduced mamba2-130m (2 layers, d_model 256, d_state 16, head_dim 32,
chunk 16, vocab 512) runs at seq_len 20, so the last chunk is padded.
Both packages start from the JAX parameters (carried by
`repro_torch.interop`) and consume the JAX draws (`JaxDraws` with the JAX
spec's own `sample_z`).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs import get_arch_config as jget_arch_config
from repro.configs import list_archs as jlist_archs
from repro.core import protocol as jprotocol
from repro.core.engine import Trainer as JaxTrainer
from repro.data import synthetic as jsynthetic
from repro.metrics import fid as jfid
from repro.models import backbone as jbackbone
from repro.models import gan as jgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch import nn as tnn
from repro_torch.configs import get_arch_config, list_archs
from repro_torch.core import Trainer, protocol as tprotocol
from repro_torch.data import synthetic as tsynthetic
from repro_torch.metrics import fid as tfid
from repro_torch.models import backbone as tbackbone
from repro_torch.models import gan as tgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_protocol import JaxDraws, quant_step_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import world_of_one

JCFG = jget_arch_config("mamba2-130m").reduced()
TCFG = get_arch_config("mamba2-130m").reduced()
SEQ, K, N_LOCAL = 20, 3, 6
KEY = jax.random.PRNGKey(0)


@functools.cache
def jax_params():
    return jax.device_get(jax.jit(lambda k: jgan.gan_init(k, JCFG))(KEY))


def tokens(k=K, n=N_LOCAL, seed=0):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab, (k, n, SEQ)).astype(np.int32)


def configs(**kw):
    from repro.configs.base import ProtocolConfig as JaxProtocolConfig
    from repro_torch.configs import ProtocolConfig
    common = dict(n_devices=K, n_d=2, n_g=2, sample_size=4,
                  server_sample_size=4, lr_d=1e-3, lr_g=1e-3,
                  optimizer="adam")
    common.update(kw)
    return JaxProtocolConfig(**common), ProtocolConfig(**common)


def jax_spec():
    return jspecs.make_backbone_spec(JCFG, SEQ, remat=False,
                                     gen_loss_variant="nonsaturating")


def port_spec():
    return tspecs.make_backbone_spec(TCFG, SEQ, remat=False,
                                     gen_loss_variant="nonsaturating")


def test_arch_configs_match_jax():
    for port, ref in ((get_arch_config("mamba2-130m"),
                       jget_arch_config("mamba2-130m")), (TCFG, JCFG)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.group_pattern == ref.group_pattern
        assert port.n_groups_stack == ref.n_groups_stack
    # every config of the JAX package, in its order, and no other (the
    # encoder-decoder and vision configs, once refused, included)
    assert list_archs() == jlist_archs() == [
        "mamba2-130m", "mixtral-8x22b", "whisper-base", "granite-3-2b",
        "qwen3-1.7b", "granite-moe-3b-a800m", "zamba2-2.7b", "gemma3-12b",
        "minitron-4b", "llama-3.2-vision-90b"]
    for name in list_archs():
        assert dataclasses.asdict(get_arch_config(name)) == \
            dataclasses.asdict(jget_arch_config(name))
    assert dataclasses.asdict(get_arch_config("dcgan")) == \
        dataclasses.asdict(jget_arch_config("dcgan"))
    for get in (get_arch_config, jget_arch_config):
        with pytest.raises(KeyError, match="unknown architecture"):
            get("whisper-large")


def test_full_width_parameter_counts_and_shapes_match_jax():
    """The full mamba2-130m backbone-GAN, built on the CPU, against
    `jax.eval_shape` of the JAX init: every leaf's shape in leaf order."""
    cfg = get_arch_config("mamba2-130m")
    jshapes = jax.eval_shape(lambda k: jgan.gan_init(k, cfg), KEY)
    params = tgan.gan_init(torch.Generator().manual_seed(0), cfg)
    for part, count in (("gen", 168_286_656), ("disc", 129_574_080)):
        ref = jax.tree_util.tree_leaves(jshapes[part])
        leaves = tree_leaves(params[part])
        assert [tuple(x.shape) for x in leaves] == [x.shape for x in ref]
        assert all(x.dtype == torch.float32 for x in leaves)
        assert tprotocol.count_params(params[part]) == count
    assert tuple(params["disc"]["backbone"]["groups"]["sub0"]["mixer"]
                 ["in_proj"].shape) == (24, 768, 3352)


def test_interop_carries_the_backbone_gan_tree():
    jparams = jax_params()
    tparams = interop.to_torch(jparams, "cpu")
    assert (jax.tree_util.tree_structure(interop.to_numpy(tparams))
            == jax.tree_util.tree_structure(jparams))
    for x, y in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_port_init_follows_the_jax_recipe():
    """Same leaves, and the recipe's deterministic ones equal (A_log,
    D, norms, conv bias); random ones at the recipe's scale."""
    params = tgan.gan_init(torch.Generator().manual_seed(1), TCFG)
    jparams = jax_params()
    for x, y in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        assert tuple(x.shape) == np.shape(y)
    mixer, jmixer = (p["disc"]["backbone"]["groups"]["sub0"]["mixer"]
                     for p in (params, jparams))
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(mixer[name].numpy(),
                                   np.asarray(jmixer[name]), rtol=1e-6)
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all())
    std = float(mixer["in_proj"].std())
    assert abs(std - 256 ** -0.5) < 0.1 * 256 ** -0.5


def test_generator_and_discriminator_match_jax():
    jparams = jax_params()
    tparams = interop.to_torch(jparams, "cpu")
    z = np.random.default_rng(1).standard_normal(
        (3, SEQ, JCFG.d_z)).astype(np.float32)
    toks = tokens()[0, :3]
    jfake, _ = jax.jit(lambda p, z: jgan.generator_apply(
        p, JCFG, z, remat=False))(jparams["gen"], jnp.asarray(z))
    tfake, _ = tgan.generator_apply(tparams["gen"], TCFG, torch.tensor(z))
    np.testing.assert_allclose(tfake.detach().numpy(), np.asarray(jfake),
                               rtol=1e-4, atol=1e-5)
    for real in (True, False):
        jx = (jgan.discriminator_embed(jparams["disc"], jnp.asarray(toks))
              if real else jfake)
        tx = (tgan.discriminator_embed(tparams["disc"],
                                       torch.tensor(toks).long())
              if real else tfake)
        jl, _ = jax.jit(lambda p, x: jgan.discriminator_apply(
            p, JCFG, x, remat=False))(jparams["disc"], jx)
        tl, _ = tgan.discriminator_apply(tparams["disc"], TCFG, tx)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-5)


def test_remat_gives_the_same_values_and_gradients():
    """remat=True (torch.utils.checkpoint per group) is the same math."""
    params = tgan.gan_init(torch.Generator().manual_seed(2), TCFG)["disc"]
    x = torch.randn((2, SEQ, TCFG.d_model),
                    generator=torch.Generator().manual_seed(3))
    out = []
    for remat in (False, True):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        logits, _ = tgan.discriminator_apply(tree_unflatten(params, leaves),
                                             TCFG, x, remat=remat)
        grads = torch.autograd.grad(logits.sum(), leaves, allow_unused=True,
                                    materialize_grads=True)
        out.append((logits.detach(), grads))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backbone_refuses_what_is_not_ported(tmp_path):
    # the encoder-decoder and vision families, once refused, build JAX's
    # trees and give its hidden states (here on qwen3's reduced widths,
    # with qk-norm in the cross sublayers and the vision gates open)
    rng = np.random.default_rng(1)
    h, e = (rng.standard_normal((1, n, 256)).astype(np.float32)
            for n in (6, 5))
    for changes in (dict(family="encdec", n_enc_layers=2),
                    dict(family="vlm", cross_attn_every=2, n_layers=3)):
        cfg, jcfg = (dataclasses.replace(get("qwen3-1.7b").reduced(),
                                         **changes)
                     for get in (get_arch_config, jget_arch_config))
        params = tgan.gan_init(torch.Generator().manual_seed(0), cfg)
        shapes = jax.eval_shape(lambda k: jgan.gan_init(k, jcfg), KEY)
        assert ([tuple(x.shape) for x in tree_leaves(params)]
                == [x.shape for x in jax.tree_util.tree_leaves(shapes)])
        assert ("encoder" in params["gen"]) == (cfg.family == "encdec")
        bb = params["gen"]["backbone"]
        for sub in bb["groups"].values():
            if "gate_attn" in sub:
                sub["gate_attn"].fill_(0.5)
                sub["gate_ff"].fill_(-0.4)
        want = jbackbone.backbone_apply(
            jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(bb)), jcfg,
            jnp.asarray(h), enc_h=jnp.asarray(e), remat=False)["h"]
        with torch.no_grad():
            got = tbackbone.backbone_apply(bb, cfg, torch.tensor(h),
                                           enc_h=torch.tensor(e))["h"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    # prefill, once refused, gives JAX's hidden states and decode state;
    # encoder states, once refused, are ignored by a family without
    # cross sublayers, as in JAX; tensor parallelism, once refused, needs
    # a model group and is the identity on a group of one rank (mamba2's
    # backbone has no feed-forward to shard)
    params = tbackbone.backbone_init(torch.Generator().manual_seed(0), TCFG)
    h = np.random.default_rng(2).standard_normal(
        (1, 4, TCFG.d_model)).astype(np.float32)
    want = jbackbone.backbone_apply(
        jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(params)), JCFG,
        jnp.asarray(h), mode="prefill")
    got = tbackbone.backbone_apply(params, TCFG, torch.tensor(h),
                                   mode="prefill")
    for g, w in zip(tree_leaves({"h": got["h"], "c": got["caches"]}),
                    jax.tree_util.tree_leaves({"h": want["h"],
                                               "c": want["caches"]})):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    th = torch.tensor(h)
    with torch.no_grad():
        got = tbackbone.backbone_apply(params, TCFG, th, enc_h=th)["h"]
        assert torch.equal(got, tbackbone.backbone_apply(params, TCFG,
                                                         th)["h"])
    want = jbackbone.backbone_apply(
        jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(params)), JCFG,
        jnp.asarray(h), enc_h=jnp.asarray(h), remat=False)["h"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(RuntimeError, match="no 'model' process group"):
        dense = get_arch_config("qwen3-1.7b").reduced()
        tbackbone.backbone_apply(
            tbackbone.backbone_init(torch.Generator(), dense), dense,
            torch.zeros(1, 2, dense.d_model), tp_axis="model")
    with world_of_one(tmp_path) as group:
        with torch.no_grad():
            assert torch.equal(
                tbackbone.backbone_apply(params, TCFG, th,
                                         tp_axis=group)["h"],
                tbackbone.backbone_apply(params, TCFG, th)["h"])


def jax_draws(tpcfg, n_params):
    return JaxDraws(KEY, tpcfg, JCFG.d_z, N_LOCAL, n_params,
                    sample_z=jax_spec().sample_z)


def adam_close(port_tree, jax_tree, *, atol, lr, steps):
    """`quant_step_close` for Adam-trained trees, with one allowance.
    Adam's first steps move an element by about lr * g / (|g| + 1e-8),
    so an element whose gradient is at the float32 round-off level of
    the two computations can move by up to lr the other way. Such
    elements (at most 1e-4 of a leaf) may differ by 2 * steps * lr;
    every other element agrees to atol plus one quantization step."""
    a = tree_leaves(port_tree)
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        diff = np.abs(x.detach().numpy() - y)
        off = diff > atol + float(np.abs(y).max()) / 32767
        assert off.sum() <= max(1, 1e-4 * y.size), (off.sum(), y.shape)
        assert diff.max() <= 2 * steps * lr, diff.max()


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_gan_round_matches_jax(schedule):
    """One round (Adam, 16-bit uplink, one device unscheduled) from the
    same state and draws: both nets to one quantization step up to
    `adam_close`'s allowance, the metrics to 1e-5 but the generator
    objective (taken after the server's first Adam step) to 1e-4. The
    SGD rounds of `test_trainer_matches_jax_host_driver` hold every
    element to one quantization step."""
    jpcfg, tpcfg = configs(schedule=schedule)
    jstate = jprotocol.make_train_state(KEY, lambda k: jax_params(), jpcfg, K)
    tstate = interop.to_torch(jax.device_get(jstate), "cpu")
    n_params = tprotocol.count_params(tstate["disc"])
    data = tokens()
    w = np.asarray([4.0, 0.0, 4.0], np.float32)
    round_key = jax.random.fold_in(KEY, 0)
    jstate, jm = jax.jit(lambda s, d, w, k: jprotocol.gan_round(
        jax_spec(), jpcfg, s, d, w, k))(jstate, jnp.asarray(data),
                                        jnp.asarray(w), round_key)
    tstate, tm = tprotocol.gan_round(
        port_spec(), tpcfg, tstate, torch.tensor(data).long(),
        torch.tensor(w), jax_draws(tpcfg, n_params).for_key(round_key))
    for name in ("disc_objective", "gen_objective", "participation"):
        atol = 1e-4 if name == "gen_objective" else 1e-5
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=0,
                                   atol=atol)
    for part, steps in (("disc", tpcfg.n_d), ("gen", tpcfg.n_g)):
        adam_close(tstate[part], jstate[part], atol=1e-5, lr=1e-3,
                   steps=steps)


def _jax_token_fid_weights(vocab, d, feat_dim=64, seed=42):
    """The table and projection `repro.metrics.fid.
    make_token_feature_extractor` draws."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"table": np.asarray(jax.random.normal(k1, (vocab, feat_dim))
                                * 0.3),
            "proj": np.asarray(jax.random.normal(k2, (d, feat_dim))
                               * d ** -0.5)}


def test_trainer_matches_jax_host_driver():
    """Two rounds (SGD), best-channel scheduling of 2 of 3 devices, a
    token FID on the last: masks, weights and the wallclock bit for bit,
    metrics to 1e-5, the uploaded discriminator to one quantization step
    and the server's generator to 1e-5."""
    jpcfg, tpcfg = configs(scheduler="best_channel", scheduling_ratio=0.5,
                           optimizer="sgd")
    data = tokens(seed=4)
    jparams = jax_params()
    n_params = sum(int(np.size(x)) for x in
                   jax.tree_util.tree_leaves(jparams["disc"]))
    z = np.random.default_rng(5).standard_normal(
        (8, SEQ, JCFG.d_z)).astype(np.float32)
    real = data.reshape(-1, SEQ)
    jfeat = jfid.make_token_feature_extractor(JCFG.vocab)
    tfeat = tfid.make_token_feature_extractor(
        TCFG.vocab, device="cpu",
        weights=_jax_token_fid_weights(TCFG.vocab, TCFG.d_model))

    def jax_fid(gen, _key):
        fake, _ = jgan.generator_apply(gen, JCFG, jnp.asarray(z),
                                       remat=False)
        return jfid.fid_score(jfeat(jnp.asarray(real)), jfeat(fake))

    def port_fid(gen, _generator):
        with torch.no_grad():
            fake, _ = tgan.generator_apply(gen, TCFG, torch.tensor(z))
        return tfid.fid_score(tfeat(torch.tensor(real)), tfeat(fake))

    jtr = JaxTrainer(jax_spec(), jpcfg, lambda k: jparams, jnp.asarray(data),
                     KEY, driver="host")
    ttr = Trainer(port_spec(), tpcfg,
                  lambda g: interop.to_torch(jparams, "cpu"), data, seed=0,
                  sampler=jax_draws(tpcfg, n_params), driver="host",
                  device="cpu")
    assert ttr.data.dtype == torch.int64
    jhist = jtr.run(2, eval_every=2, fid_fn=jax_fid)
    thist = ttr.run(2, eval_every=2, fid_fn=port_fid)
    for jr, tr in zip(jhist, thist):
        np.testing.assert_array_equal(tr.mask, jr.mask)
        assert tr.mask.sum() == 2
        np.testing.assert_array_equal(
            tr.weights, np.where(jr.mask, np.float32(tpcfg.sample_size),
                                 np.float32(0)))
        assert tr.wallclock_s == jr.wallclock_s
        for name, value in jr.metrics.items():
            np.testing.assert_allclose(tr.metrics[name], value, rtol=0,
                                       atol=1e-5)
    np.testing.assert_allclose(thist[-1].fid, jhist[-1].fid, rtol=1e-3)
    quant_step_close(ttr.state["disc"], jtr.state["disc"], atol=1e-5)
    for x, y in zip(tree_leaves(ttr.state["gen"]),
                    jax.tree_util.tree_leaves(jtr.state["gen"])):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-5)


def test_token_trainer_indexes_the_embedding_with_integer_ids(monkeypatch):
    """Integer shards stay integers (int64 on the device) and reach the
    discriminator's embedding lookup as integer ids; float ids raise."""
    _, tpcfg = configs(n_d=1, n_g=1)
    seen = []
    lookup = tnn.embedding_apply

    def spy(params, ids, **kw):
        seen.append(ids.dtype)
        return lookup(params, ids, **kw)

    monkeypatch.setattr(tnn, "embedding_apply", spy)
    tr = Trainer(port_spec(), tpcfg, lambda g: tgan.gan_init(g, TCFG),
                 tokens(), seed=0, device="cpu")
    assert tr.data.dtype == torch.int64
    rec = tr.run(1)[-1]
    assert seen and set(seen) == {torch.int64}
    assert all(np.isfinite(v) for v in rec.metrics.values())
    with pytest.raises(TypeError, match="integers"):
        lookup(tr.state["disc"]["embed"], torch.zeros(2, 3))


def test_draw_sampler_draws_sequence_noise():
    _, tpcfg = configs()
    d = tprotocol.DrawSampler(port_spec(), tpcfg, seed=1, n_local=N_LOCAL,
                              n_params=10, device="cpu")(0)
    assert d.z_dev.shape == (2, 4, SEQ, TCFG.d_z)
    assert d.z_srv.shape == (2, 4, SEQ, TCFG.d_z)
    torch.testing.assert_close(d.z_srv, d.z_dev, rtol=0, atol=0)


def test_token_dataset_matches_jax_bitwise():
    jt, jl = jsynthetic.make_token_dataset(24, 17, 300, seed=3)
    tt, tl = tsynthetic.make_token_dataset(24, 17, 300, seed=3)
    assert tt.dtype == jt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)


def test_token_features_match_jax_with_injected_weights():
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 64, (5, 9)).astype(np.int32)
    emb = rng.standard_normal((5, 9, 24)).astype(np.float32)
    jfeat = jfid.make_token_feature_extractor(64)
    tfeat = tfid.make_token_feature_extractor(
        64, device="cpu", weights=_jax_token_fid_weights(64, 24))
    for x in (toks, emb):
        np.testing.assert_allclose(tfeat(torch.tensor(x)).numpy(),
                                   np.asarray(jfeat(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
    own = tfid.make_token_feature_extractor(64, device="cpu")
    assert own(torch.tensor(emb)).shape == (5, 128)
    assert own(torch.tensor(toks)).shape == (5, 128)
