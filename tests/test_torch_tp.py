"""Port parity: the parts of tensor parallelism that need no ranks.

Against the JAX package on the same inputs (numpy, from a seed):

* the sharding rules (`repro_torch.sharding.rules` against
  `repro.sharding.rules`): shard dims, the per-rank payload and the
  refusals, on the MLP-GAN and every registered reduced config, bare
  parameters and whole train states (optimizer moments, stacked
  per-device entries);
* the cut-and-rebuild pair (`shard_tree`, `unshard_tree`);
* `quantize.roundtrip_tp`: each rank's quantized shard, put back
  together, equals JAX's `roundtrip` of the global payload bit for bit
  (the two ranks emulated in one process: the model group's MAX is the
  global abs-max of each leaf);
* the fused projections (`fuse_qkv`, `fuse_gate`) and the k/v-repeating
  flash layout (`flash_repeat_kv`, the plain path) to 1e-6.

The collectives themselves run on gloo ranks in test_torch_tp_mesh.py.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_arch_config as jget_arch_config
from repro.configs.base import ProtocolConfig as JaxProtocolConfig
from repro.core import protocol as jprotocol
from repro.core import quantize as jquantize
from repro.models import backbone as jbackbone
from repro.models import gan as jgan
from repro.nn import attention as jattention
from repro.nn import mlp as jmlp
from repro.sharding import rules as jrules
from repro_torch import interop
from repro_torch.configs import CANONICAL, ProtocolConfig, get_arch_config
from repro_torch.core import protocol, quantize
from repro_torch.launch import mesh
from repro_torch.models import backbone as tbackbone
from repro_torch.models import gan as tgan
from repro_torch.nn import attention, mlp
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEY = jax.random.PRNGKey(0)
ARCHS = sorted(CANONICAL)
PCFG = dict(n_devices=2, n_d=1, n_g=1, sample_size=4, server_sample_size=4,
            lr_d=1e-3, lr_g=1e-3, optimizer="adam")


def _port_state(init_fn):
    """The port's stacked train state (K=2, Adam), shapes only."""
    with FakeTensorMode():
        return protocol.make_train_state(init_fn, ProtocolConfig(**PCFG), 2,
                                         seed=0, device="cpu")


def _jax_state(init_fn):
    return jax.eval_shape(lambda: jprotocol.make_train_state(
        KEY, init_fn, JaxProtocolConfig(**PCFG), 2))


def _trees(arch):
    """(port tree, JAX tree) of the whole train state, shapes only."""
    if arch == "mlp-gan":
        return (_port_state(lambda g: tgan.mlp_gan_init(g, d_hidden=16)),
                _jax_state(lambda k: jgan.mlp_gan_init(k, d_hidden=16)))
    tcfg = get_arch_config(arch).reduced()
    jcfg = jget_arch_config(arch).reduced()
    return (_port_state(lambda g: tgan.gan_init(g, tcfg)),
            _jax_state(lambda k: jgan.gan_init(k, jcfg)))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["mlp-gan"] + ARCHS)
def test_tp_tree_dims_match_jax(arch, tp):
    """Every entry of the train state (parameters, Adam moments, the
    stacked per-device disc_opt): the same shard dims in the same leaf
    order, the same per-rank payload, the same leaf shapes."""
    port, ref = _trees(arch)
    assert set(port) == set(ref)
    for key in ref:
        assert ([tuple(x.shape) for x in tree_leaves(port[key])]
                == [tuple(x.shape) for x in
                    jax.tree_util.tree_leaves(ref[key])])
        assert (rules.tp_tree_dims(port[key], tp)
                == jrules.tp_tree_dims(ref[key], tp)), key
        assert (rules.tp_local_size(port[key], tp)
                == jrules.tp_local_size(ref[key], tp))
    dims = rules.tp_tree_dims(port["disc"], tp)
    # the dense MLPs shard (zamba2-2.7b's shared block's too); mamba2-130m
    # has none, and MoE experts replicate: all of those replicate, as in
    # JAX
    sharded = any(d is not None for d in dims)
    assert sharded == any(d is not None for d in
                          jrules.tp_tree_dims(ref["disc"], tp))
    assert sharded == (arch not in ("mamba2-130m", "mixtral-8x22b",
                                    "granite-moe-3b-a800m"))
    if arch == "mlp-gan":
        assert dims == (-1, -2)               # w_in column, w_out row


def test_tp_rules_refuse_and_replicate_as_jax():
    """A TP-named leaf that tp does not divide raises the same message;
    a 6-wide leaf shards at tp=2 (divisibility is decided on the global
    shape); everything under "experts" replicates; unnamed leaves and tp=1
    replicate."""
    shapes = {"w_in": (4, 6), "w_out": (6, 4), "b_in": (6,), "wq": (4, 6),
              "experts": {"w_in": (2, 4, 6)}, "ln": {"scale": (4,)}}
    port = {k: (torch.zeros(v) if isinstance(v, tuple)
                else {n: torch.zeros(s) for n, s in v.items()})
            for k, v in shapes.items()}
    ref = jax.tree_util.tree_map(lambda x: np.zeros(x.shape),
                                 interop.to_numpy(port))
    assert (rules.tp_tree_dims(port, 2) == jrules.tp_tree_dims(ref, 2)
            == (-1, None, None, -1, -2, None))
    assert rules.tp_tree_dims(port, 1) == (None,) * 6
    with pytest.raises(ValueError) as got:
        rules.tp_tree_dims(port, 4)
    with pytest.raises(ValueError) as want:
        jrules.tp_tree_dims(ref, 4)
    assert str(got.value) == str(want.value)
    for name in ("w_in", "w_out", "b_in", "w_gate"):
        assert (rules.tp_leaf_dim(name, (6, 8), 2)
                == jrules.tp_leaf_dim(name, (6, 8), 2))


def test_shard_and_unshard_rebuild_the_global_tree():
    """`shard_tree` over every rank, `unshard_tree` of the shards: the
    global tree bit for bit; a shard holds its contiguous 1/tp slice."""
    g = torch.Generator().manual_seed(0)
    tree = tgan.gan_init(g, get_arch_config("granite-3-2b").reduced())
    dims = rules.tp_tree_dims(tree, 2)
    shards = [rules.shard_tree(tree, 2, r, dims) for r in range(2)]
    for a, b in zip(tree_leaves(rules.unshard_tree(shards, dims)),
                    tree_leaves(tree)):
        assert torch.equal(a, b)
    w_out = tree["gen"]["backbone"]["groups"]["sub0"]["ff"]["w_out"]
    half = w_out.shape[-2] // 2
    got = shards[1]["gen"]["backbone"]["groups"]["sub0"]["ff"]["w_out"]
    assert got.is_contiguous() and torch.equal(got, w_out[:, half:])


@pytest.mark.parametrize("bits", [16, 8])
def test_roundtrip_tp_shards_match_jax_roundtrip_bitwise(bits, monkeypatch):
    """The reduced granite-3-2b discriminator as the global payload: each
    model rank quantizes its shards with its cut of the worker's row of
    uniforms and the global abs-max (the group's MAX, emulated); the
    shards put back together equal JAX's `roundtrip` of the global
    payload from the same key bit for bit."""
    cfg = get_arch_config("granite-3-2b").reduced()
    disc = tgan.discriminator_init(torch.Generator().manual_seed(3), cfg)
    key = jax.random.PRNGKey(11)
    n = sum(x.numel() for x in tree_leaves(disc))
    uniforms = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    want = jquantize.roundtrip(key, interop.to_numpy(disc), bits)
    tp = 2
    dims = rules.tp_tree_dims(disc, tp)
    amax = [x.abs().max() for x, d in zip(tree_leaves(disc), dims)
            if d is not None]
    shards = []
    for rank in range(tp):
        maxes = iter(amax)
        monkeypatch.setattr(mesh, "axis_group", lambda axis: axis)
        monkeypatch.setattr(torch.distributed, "get_rank",
                            lambda group, r=rank: r)
        monkeypatch.setattr(mesh, "all_reduce_max",
                            lambda t, group: next(maxes))
        shards.append(quantize.roundtrip_tp(
            uniforms, rules.shard_tree(disc, tp, rank, dims), bits,
            tp_axis="model", tp=tp, shard_dims=dims))
        assert next(maxes, None) is None   # one MAX a sharded leaf
    monkeypatch.undo()
    got = rules.unshard_tree(shards, dims)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # tp=1 (and 32 bits) take `roundtrip` itself
    assert quantize.roundtrip_tp(uniforms, disc, 32, tp_axis="model",
                                 tp=2, shard_dims=dims) is disc
    for a, b in zip(tree_leaves(quantize.roundtrip_tp(uniforms, disc,
                                                      bits)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The fused projections and the k/v-repeating flash layout
# ---------------------------------------------------------------------------

def _normals(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-6):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [8, 520])
def test_fuse_qkv_matches_jax(s):
    """`fuse_qkv` (leaf wqkv, bias bqkv): the port's init has JAX's
    tree and shapes; the forward on JAX's weights (naive path at s=8,
    the flash path's plain version at s=520, qk-norm and biases on),
    and the k/v it returns, agree to 1e-6."""
    kw = dict(n_heads=4, n_kv_heads=2, qk_norm=True)
    jparams = jattention.attention_init(jax.random.PRNGKey(1), 64, 4, 2,
                                        16, qk_norm=True, use_bias=True,
                                        fuse_qkv=True)
    jparams = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jnp.asarray(_normals(*x.shape, seed=x.size)),
        jparams)                       # non-zero biases and norm scales
    tparams = attention.attention_init(torch.Generator(), 64, 4, 2, 16,
                                       qk_norm=True, use_bias=True,
                                       fuse_qkv=True)
    assert (jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                   interop.to_numpy(tparams))
            == jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams))
    x = _normals(1, s, 64, seed=2)
    inv = jnp.asarray(1.0 / 10000 ** (np.arange(0, 16, 2) / 16),
                      jnp.float32)
    want = jattention.attention_apply(jparams, jnp.asarray(x), inv_freq=inv,
                                      return_kv=True, **kw)
    got = attention.attention_apply(interop.to_torch(jparams, "cpu"),
                                    torch.tensor(x),
                                    inv_freq=torch.tensor(np.asarray(inv)),
                                    return_kv=True, **kw)
    _close(got, want)
    with pytest.raises(ValueError, match="self-attention only"):
        attention.attention_apply(interop.to_torch(jparams, "cpu"),
                                  torch.tensor(x), kv_x=torch.tensor(x),
                                  **kw)


def test_fuse_gate_matches_jax():
    """`fuse_gate` (leaf w_inga, [in | gate]): JAX's tree and shapes, the
    forward with biases agrees to 1e-6, and the fused leaf refuses tp
    with JAX's message."""
    jparams = jmlp.mlp_init(jax.random.PRNGKey(3), 32, 48, use_bias=True,
                            fuse_gate=True)
    jparams = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jnp.asarray(_normals(*x.shape, seed=x.size)),
        jparams)
    tparams = mlp.mlp_init(torch.Generator(), 32, 48, use_bias=True,
                           fuse_gate=True)
    assert sorted(tparams) == sorted(jparams) == ["b_inga", "b_out",
                                                  "w_inga", "w_out"]
    x = _normals(2, 5, 32, seed=4)
    _close(mlp.mlp_apply(interop.to_torch(jparams, "cpu"), torch.tensor(x)),
           jmlp.mlp_apply(jparams, jnp.asarray(x)))
    with pytest.raises(ValueError) as got:
        mlp.mlp_apply(interop.to_torch(jparams, "cpu"), torch.tensor(x),
                      tp_axis="model")
    with pytest.raises(ValueError) as want:
        jmlp.mlp_apply(jparams, jnp.asarray(x), tp_axis="model")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 200),
                                           (False, None)])
def test_flash_repeat_kv_matches_jax(causal, window, monkeypatch):
    """`flash_repeat_kv` at s=520 (past the flash threshold), 4 query
    heads over 2 kv heads: the flash wrapper is called with k/v repeated
    to all 4 heads (KV = H), and the output agrees with JAX's repeated
    layout (flash_attention_ref) to 1e-6."""
    from repro_torch.kernels.flash_attn import ops
    kw = dict(n_heads=4, n_kv_heads=2, causal=causal, window=window)
    jparams = jattention.attention_init(jax.random.PRNGKey(5), 64, 4, 2, 16)
    x = _normals(1, 520, 64, seed=6)
    inv = jnp.asarray(1.0 / 10000 ** (np.arange(0, 16, 2) / 16),
                      jnp.float32)
    want = jattention.attention_apply(jparams, jnp.asarray(x), inv_freq=inv,
                                      flash_repeat_kv=True, **kw)
    seen, flash = [], ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **a: (
        seen.append((q.shape, k.shape)), flash(q, k, v, **a))[1])
    got = attention.attention_apply(interop.to_torch(jparams, "cpu"),
                                    torch.tensor(x),
                                    inv_freq=torch.tensor(np.asarray(inv)),
                                    flash_repeat_kv=True, **kw)
    assert seen == [((1, 520, 4, 16), (1, 520, 4, 16))]
    _close(got, want)


def test_fuse_proj_backbone_matches_jax():
    """A reduced qwen3-1.7b with fuse_proj=True: both packages build
    wqkv and w_inga leaves of the same shapes, and the backbone's train
    forward on JAX's weights agrees to 1e-5."""
    tcfg = dataclasses.replace(get_arch_config("qwen3-1.7b").reduced(),
                               fuse_proj=True)
    jcfg = dataclasses.replace(jget_arch_config("qwen3-1.7b").reduced(),
                               fuse_proj=True)
    jparams = jbackbone.backbone_init(jax.random.PRNGKey(7), jcfg)
    tparams = tbackbone.backbone_init(torch.Generator(), tcfg)
    sub = tparams["groups"]["sub0"]
    assert "wqkv" in sub["attn"] and "w_inga" in sub["ff"]
    assert ([tuple(x.shape) for x in tree_leaves(tparams)]
            == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jparams)])
    h = _normals(2, 12, tcfg.d_model, seed=8)
    want = jbackbone.backbone_apply(jparams, jcfg, jnp.asarray(h),
                                    remat=False)["h"]
    got = tbackbone.backbone_apply(interop.to_torch(jparams, "cpu"), tcfg,
                                   torch.tensor(h), remat=False)["h"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
