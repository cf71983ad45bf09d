"""Port parity: the backbone-GAN on the dense attention family
(granite-3-2b, qwen3-1.7b, minitron-4b, gemma3-12b) against the JAX
package — configs, the full-width parameter trees, forwards, protocol
rounds and one round of the Trainer's host driver.

The reduced configs (2 layers, d_model 256, 8 heads of 32, d_ff 512,
vocab 512) run at seq_len 520, so that s * s passes the flash threshold
and attention takes the flash path (the kernel wrapper's plain version
and the port's FlashAttention-2 backward). Reduced granite has as many
kv heads as heads; the `kv2` variant (2 kv heads, 4 query heads each)
exercises grouped-query indexing. Reduced gemma3-12b is one 5:1 group
of 6 layers (5 with a sliding window of 8 keys, 1 global), with qk-norm
and RoPE base 1e6: at seq_len 520 the window masks most keys. Both
packages start from the same parameters (carried by `repro_torch.interop`)
and consume the JAX draws.

Tolerances: forwards to 1e-4 relative and 1e-5 absolute; rounds as in
tests/test_torch_backbone.py (one quantization step for the uploads,
`adam_close` for Adam, 1e-5 for metrics, 1e-4 for the generator
objective taken after the server's first Adam step).
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
from repro.core import protocol as jprotocol
from repro.core.engine import Trainer as JaxTrainer
from repro.models import gan as jgan
from repro.models import specs as jspecs
from repro_torch import interop
from repro_torch.configs import get_arch_config
from repro_torch.core import Trainer, protocol as tprotocol
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import gan as tgan
from repro_torch.models import specs as tspecs
from repro_torch.tree import tree_leaves
from test_torch_backbone import adam_close
from test_torch_protocol import JaxDraws, quant_step_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ, K, N_LOCAL = 520, 3, 6
KEY = jax.random.PRNGKey(0)
VARIANTS = {"granite": ("granite-3-2b", {}),
            "granite-kv2": ("granite-3-2b", {"n_kv_heads": 2}),
            "qwen3": ("qwen3-1.7b", {}),
            "minitron": ("minitron-4b", {}),
            "gemma3": ("gemma3-12b", {})}
# The depths and vocabularies `chip_smoke.py` cuts the full-width
# configs to: one 5:1 group of gemma3-12b, 2 layers of minitron-4b, and
# a 32,768-token vocabulary for both.
CUT_VOCAB = {("minitron-4b", 2): 32_768, ("gemma3-12b", 6): 32_768}


@functools.cache
def cfgs(variant):
    """(JAX config, port config) of a reduced variant."""
    name, changes = VARIANTS[variant]
    return tuple(dataclasses.replace(get(name).reduced(), **changes)
                 for get in (jget_arch_config, get_arch_config))


@functools.cache
def jax_params(variant):
    """The port's initial backbone-GAN as the numpy tree both packages
    start from (its leaves follow the JAX recipe's shapes; the values are
    the port's draws, which spares the JAX init's compile)."""
    tcfg = cfgs(variant)[1]
    return interop.to_numpy(tgan.gan_init(torch.Generator().manual_seed(0),
                                          tcfg))


def tokens(vocab, k=K, n=N_LOCAL, seed=0, seq=SEQ):
    return np.random.default_rng(seed).integers(
        0, vocab, (k, n, seq)).astype(np.int32)


def protocol_configs(**kw):
    from repro.configs.base import ProtocolConfig as JaxProtocolConfig
    from repro_torch.configs import ProtocolConfig
    common = dict(n_devices=K, n_d=1, n_g=1, sample_size=1,
                  server_sample_size=1, lr_d=1e-3, lr_g=1e-3)
    common.update(kw)
    return JaxProtocolConfig(**common), ProtocolConfig(**common)


def compiled(fn, *args):
    """`jax.jit(fn)` compiled for `args` at XLA's backend optimisation
    level 0: the JAX package's own function, compiled in a third of the
    default's CPU time, which the round tests would otherwise spend."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def specs(variant, seq=SEQ):
    jcfg, tcfg = cfgs(variant)
    return (jspecs.make_backbone_spec(jcfg, seq, remat=False,
                                      gen_loss_variant="nonsaturating"),
            tspecs.make_backbone_spec(tcfg, seq, remat=False,
                                      gen_loss_variant="nonsaturating"))


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen3-1.7b",
                                  "minitron-4b", "gemma3-12b"])
def test_dense_configs_match_jax(name):
    for port, ref in ((get_arch_config(name), jget_arch_config(name)),
                      (get_arch_config(name).reduced(),
                       jget_arch_config(name).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.group_pattern == ref.group_pattern
        assert port.n_groups_stack == ref.n_groups_stack
        for kind in port.group_pattern:
            assert port.sublayer_window(kind) == ref.sublayer_window(kind)
    if name == "gemma3-12b":
        reduced = get_arch_config(name).reduced()
        assert reduced.group_pattern == ("attn_local",) * 5 + (
            "attn_global",)
        assert [reduced.sublayer_window(k) for k in reduced.group_pattern
                ] == [8] * 5 + [None]
    else:
        assert get_arch_config(name).group_pattern == ("attn",)


@pytest.mark.parametrize("name,layers,sizes", [
    ("granite-3-2b", 40, (2_638_657_536, 2_537_728_000)),
    ("granite-3-2b", 4, (449_083_392, 348_153_856)),
    ("qwen3-1.7b", 28, None),
    ("minitron-4b", 32, None),
    ("minitron-4b", 2, (431_373_312, 330_319_872)),
    ("gemma3-12b", 48, None),
    ("gemma3-12b", 6, (1_611_747_072, 1_485_430_272))])
def test_full_width_leaf_shapes_match_jax(name, layers, sizes):
    """The full-width backbone-GAN built on fake tensors (no storage)
    against `jax.eval_shape` of the JAX init: every leaf's shape, in leaf
    order, group-stacked as in JAX (and at the cut vocabulary of
    CUT_VOCAB)."""
    cut = {"n_layers": layers}
    if (name, layers) in CUT_VOCAB:
        cut["vocab"] = CUT_VOCAB[name, layers]
    cfg = dataclasses.replace(get_arch_config(name), **cut)
    jcfg = dataclasses.replace(jget_arch_config(name), **cut)
    jshapes = jax.eval_shape(lambda k: jgan.gan_init(k, jcfg), KEY)
    with FakeTensorMode():
        params = tgan.gan_init(torch.Generator().manual_seed(0), cfg)
    for part in ("gen", "disc"):
        ref = jax.tree_util.tree_leaves(jshapes[part])
        leaves = tree_leaves(params[part])
        assert [tuple(x.shape) for x in leaves] == [x.shape for x in ref]
        assert all(x.dtype == torch.float32 for x in leaves)
    counts = tuple(tprotocol.count_params(params[p]) for p in ("gen", "disc"))
    assert counts == tuple(sum(int(np.prod(x.shape)) for x in
                               jax.tree_util.tree_leaves(jshapes[p]))
                           for p in ("gen", "disc"))
    if sizes is not None:
        assert counts == sizes
    wq = params["disc"]["backbone"]["groups"]["sub0"]["attn"]["wq"]
    hd = cfg.resolved_head_dim
    assert tuple(wq.shape) == (cfg.n_groups_stack, cfg.d_model,
                               cfg.n_heads * hd)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generator_and_discriminator_match_jax(variant):
    """Both nets' forwards through the flash path, real and fake inputs;
    every attention sublayer calls the kernel wrapper once."""
    jcfg, tcfg = cfgs(variant)
    jparams = jax_params(variant)
    tparams = interop.to_torch(jparams, "cpu")
    z = np.random.default_rng(1).standard_normal(
        (1, SEQ, jcfg.d_z)).astype(np.float32)
    toks = tokens(jcfg.vocab)[0, :1]
    jfake, _ = jax.jit(lambda p, z: jgan.generator_apply(
        p, jcfg, z, remat=False))(jparams["gen"], jnp.asarray(z))
    calls = []
    wrapper = flash_ops.flash_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flash_ops, "flash_attention", lambda *a, **k: (
            calls.append(a[0].shape), wrapper(*a, **k))[1])
        with torch.no_grad():
            tfake, _ = tgan.generator_apply(tparams["gen"], tcfg,
                                            torch.tensor(z))
            tx = tgan.discriminator_embed(tparams["disc"],
                                          torch.tensor(toks).long())
            treal, _ = tgan.discriminator_apply(tparams["disc"], tcfg, tx)
            tfl, _ = tgan.discriminator_apply(tparams["disc"], tcfg, tfake)
    assert calls == [(1, SEQ, tcfg.n_heads, tcfg.resolved_head_dim)] * (
        3 * tcfg.n_layers)
    np.testing.assert_allclose(tfake.numpy(), np.asarray(jfake), rtol=1e-4,
                               atol=1e-5)
    jdisc = jax.jit(lambda p, x: jgan.discriminator_apply(
        p, jcfg, x, remat=False)[0])
    jx = jgan.discriminator_embed(jparams["disc"], jnp.asarray(toks))
    for got, jin in ((treal, jx), (tfl, jfake)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jdisc(jparams["disc"], jin)),
                                   rtol=1e-4, atol=1e-5)


def _round_matches_jax(variant, seq=SEQ):
    """One parallel Adam round (one local and one server step of one
    sample, 16-bit uplink, one device unscheduled) of `variant` at
    seq_len `seq` from the same state and draws."""
    round_matches_jax(*cfgs(variant), jax_params(variant), seq)


def round_matches_jax(jcfg, tcfg, params, seq, remat=False, enc_feats=None,
                      optimizer="adam", zero_grad=()):
    """`_round_matches_jax` for the backbone-GAN of the JAX and port
    configs `jcfg`, `tcfg` from the numpy parameters `params`; remat
    recomputes each group in both packages' backwards. enc_feats: the
    conditioned families' (1, t, d) frontend features, broadcast over
    the batch in both packages (as `make_stub_enc_feats` does). With
    optimizer "sgd" the uploaded discriminator agrees to one
    quantization step plus 1e-5 and the generator to 1e-5. zero_grad:
    key paths (within a net) of leaves whose gradient is zero in exact
    arithmetic, such as the key bias of an attention without RoPE (it
    adds one constant to all of a query's scores): Adam scales their
    round-off to steps of up to lr, so they are held to the Adam bound
    (2 * steps * lr) alone. Returns the port's state after the round."""
    fns = (None, None) if enc_feats is None else (
        lambda n: jnp.broadcast_to(jnp.asarray(enc_feats),
                                   (n,) + enc_feats.shape[1:]),
        lambda n: torch.tensor(enc_feats).expand(n, -1, -1))
    jspec, tspec = (
        mod.make_backbone_spec(cfg, seq, remat=remat, enc_feats_fn=fn,
                               gen_loss_variant="nonsaturating")
        for mod, cfg, fn in ((jspecs, jcfg, fns[0]), (tspecs, tcfg, fns[1])))
    jpcfg, tpcfg = protocol_configs(schedule="parallel", optimizer=optimizer)
    jstate = jprotocol.make_train_state(KEY, lambda k: params, jpcfg, K)
    tstate = interop.to_torch(jax.device_get(jstate), "cpu")
    n_params = tprotocol.count_params(tstate["disc"])
    data = tokens(jcfg.vocab, seq=seq)
    w = np.asarray([1.0, 0.0, 1.0], np.float32)
    round_key = jax.random.fold_in(KEY, 0)
    args = (jstate, jnp.asarray(data), jnp.asarray(w), round_key)
    jstate, jm = compiled(lambda s, d, w, k: jprotocol.gan_round(
        jspec, jpcfg, s, d, w, k), *args)(*args)
    draws = JaxDraws(KEY, tpcfg, jcfg.d_z, N_LOCAL, n_params,
                     sample_z=jspec.sample_z).for_key(round_key)
    tstate, tm = tprotocol.gan_round(tspec, tpcfg, tstate,
                                     torch.tensor(data).long(),
                                     torch.tensor(w), draws)
    for name in ("disc_objective", "gen_objective", "participation"):
        atol = 1e-4 if name == "gen_objective" else 1e-5
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=0,
                                   atol=atol)
    for part, steps in (("disc", tpcfg.n_d), ("gen", tpcfg.n_g)):
        for path in zero_grad:
            got, want = (functools.reduce(dict.get, path[:-1], st[part])
                         .pop(path[-1]) for st in (tstate, jstate))
            assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= \
                2 * steps * tpcfg.lr_d
        if optimizer == "sgd" and part == "disc":
            quant_step_close(tstate[part], jstate[part], atol=1e-5)
        elif optimizer == "sgd":     # the server's generator, not uploaded
            for g, w in zip(tree_leaves(tstate[part]),
                            jax.tree_util.tree_leaves(jstate[part])):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=1e-5)
        else:
            adam_close(tstate[part], jstate[part], atol=1e-5, lr=1e-3,
                       steps=steps)
    return tstate


def test_gan_round_matches_jax():
    """The round of `_round_matches_jax` on the grouped-query variant.
    The SGD round is `test_trainer_matches_jax_host_driver`'s."""
    _round_matches_jax("granite-kv2")


def test_gemma3_round_matches_jax():
    """The same round on reduced gemma3-12b: five windowed layers and a
    global one, qk-norm before RoPE at base 1e6, at seq_len 64, where
    the window of 8 masks most keys on the naive branch (the windowed
    flash branch, forward and backward, is held to JAX by
    `test_generator_and_discriminator_match_jax` and
    tests/test_torch_attention.py; a round through it took 68 s here)."""
    _round_matches_jax("gemma3", seq=64)


def test_trainer_matches_jax_host_driver():
    """One serial round of the Trainer's host driver (an SGD gan_round:
    one local and one server step of one sample, best-channel
    scheduling of 2 of 3 devices) on reduced granite: mask, weights and the wallclock bit for
    bit, metrics to 1e-5, the uploaded discriminator to one quantization
    step and the server's generator to 1e-5."""
    variant = "granite"
    jcfg, _ = cfgs(variant)
    jspec, tspec = specs(variant)
    jpcfg, tpcfg = protocol_configs(scheduler="best_channel",
                                    scheduling_ratio=0.5)
    data = tokens(jcfg.vocab, seed=4)
    jparams = jax_params(variant)
    n_params = sum(int(np.size(x)) for x in
                   jax.tree_util.tree_leaves(jparams["disc"]))
    jtr = JaxTrainer(jspec, jpcfg, lambda k: jparams, jnp.asarray(data),
                     KEY, driver="host")
    jtr._round = compiled(jtr._round, jtr.state, jtr.data,
                          jnp.zeros((K,), jnp.float32),
                          jax.random.fold_in(KEY, 0))
    ttr = Trainer(tspec, tpcfg, lambda g: interop.to_torch(jparams, "cpu"),
                  data, seed=0, driver="host", device="cpu",
                  sampler=JaxDraws(KEY, tpcfg, jcfg.d_z, N_LOCAL, n_params,
                                   sample_z=jspec.sample_z))
    (jr,), (tr,) = jtr.run(1), ttr.run(1)
    np.testing.assert_array_equal(tr.mask, jr.mask)
    assert tr.mask.sum() == 2
    assert tr.wallclock_s == jr.wallclock_s
    np.testing.assert_array_equal(
        tr.weights, np.where(jr.mask, np.float32(tpcfg.sample_size),
                             np.float32(0)))
    for name, value in jr.metrics.items():
        np.testing.assert_allclose(tr.metrics[name], value, rtol=0,
                                   atol=1e-5)
    quant_step_close(ttr.state["disc"], jtr.state["disc"], atol=1e-5)
    for x, y in zip(tree_leaves(ttr.state["gen"]),
                    jax.tree_util.tree_leaves(jtr.state["gen"])):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-5)
