"""Port parity: RoPE, the SwiGLU/GELU feed-forward, the blockwise flash
attention (forward and FlashAttention-2 backward), the flash_attn
kernel's plain version and the attention layer against the JAX package.

The same inputs, drawn with numpy, go through `repro.nn` /
`repro.kernels.flash_attn` and their ports; the JAX Pallas kernel runs
in interpret mode, as the JAX package's own tests run it on the CPU. The
port's kernel wrapper takes its plain version on a CPU tensor.

Tolerances: 1e-6 (relative and absolute) for RoPE and the feed-forward
(the same float32 products, summed in another order); 1e-5 for the
flash forward, lse and gradients (float32 online softmax over blocks);
2e-5 in float32 and 0.05 in bfloat16 against the Pallas kernel, as
`tests/test_kernels.py` holds that kernel to its oracle. The CUDA
kernel's schedule (csrc/flash_attn.cu: 16-row warp tiles, key tiles,
the online softmax on tiles, P V with its key pairing) is mirrored in
plain torch, with its 3xTF32 products emulated by bit operations, and
held to the same 2e-5.
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.kernels.flash_attn import kernel as jflash_kernel
from repro.kernels.flash_attn import ops as jflash_ops
from repro.nn import attention as jattention
from repro.nn import flash_ref as jflash_ref
from repro.nn import mlp as jmlp
from repro.nn import rope as jrope
from repro_torch import interop
from repro_torch.kernels.flash_attn import ops, ref
from repro_torch.nn import attention, flash_ref, mlp, rope
from repro_torch.tree import tree_leaves, tree_map
from torch_tf32 import matmul_tf32
from test_torch_checkpoint import level0
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import world_of_one

KEY = jax.random.PRNGKey(0)


def normals(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("head_dim,base", [(32, 1e4), (128, 1e6)])
def test_rope_matches_jax(head_dim, base):
    x = normals(2, 9, 3, head_dim)
    pos = np.random.default_rng(1).integers(0, 4096, (2, 9))
    jinv = jrope.rope_frequencies(head_dim, base=base)
    tinv = rope.rope_frequencies(head_dim, base=base)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6,
                               atol=0)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jinv)
    got = rope.apply_rope(torch.tensor(x), torch.tensor(pos), tinv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("gated,use_bias", [(True, False), (False, True)])
def test_mlp_matches_jax(gated, use_bias):
    """SwiGLU (the dense family's) and GELU with biases (whisper's)."""
    jparams = jmlp.mlp_init(KEY, 32, 64, gated=gated, use_bias=use_bias)
    if use_bias:   # non-zero biases, so that they are exercised
        jparams = {k: (v + 0.1 if k.startswith("b_") else v)
                   for k, v in jparams.items()}
    x = normals(2, 5, 32)
    want = jmlp.mlp_apply(jparams, jnp.asarray(x))
    got = mlp.mlp_apply(interop.to_torch(jparams, "cpu"), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    params = mlp.mlp_init(torch.Generator().manual_seed(0), 32, 64,
                          gated=gated, use_bias=use_bias)
    assert sorted(params) == sorted(jparams)
    assert all(tuple(params[k].shape) == jparams[k].shape for k in params)


# (b, kv heads, group, s, window, causal): GQA groups 1, 2 and 4; windows;
# s = 520 pads the keys to two blocks of 512; one bidirectional case
FLASH_CASES = {
    "g1-s40": (2, 2, 1, 40, None, True),
    "g2-s40-w9": (1, 2, 2, 40, 9, True),
    "g4-s520": (1, 1, 4, 520, None, True),
    "g2-s520-w9": (1, 2, 2, 520, 9, True),
    "g2-s520-bidirectional": (1, 1, 2, 520, None, False),
}


def folded_case(name, d=16, seed=0):
    """Folded-layout inputs of the JAX attention's flash branch: q (b,
    kv, g*s, d) with the positions of each folded row; k, v (b, kv, s,
    d)."""
    b, kv, g, s, window, causal = FLASH_CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, kv, g * s, d), (b, kv, s, d), (b, kv, s, d)))
    q_pos = np.tile(np.arange(s), g).astype(np.int32)
    k_pos = np.arange(s, dtype=np.int32)
    return (q, k, v, q_pos, k_pos), window, causal, d ** -0.5


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_forward_matches_jax(case):
    arrays, window, causal, scale = folded_case(case)
    jout, jlse = jflash_ref._flash_fwd_inner(
        *map(jnp.asarray, arrays[:3]), jnp.asarray(arrays[3])[None, None],
        jnp.asarray(arrays[4])[None, None], None, scale, causal, window,
        512, False)
    q, k, v, q_pos, k_pos = (torch.tensor(a) for a in arrays)
    out, lse = flash_ref.flash_forward(q, k, v, q_pos.long(), k_pos.long(),
                                       scale, causal, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)


def bshd(folded_q, k, v, s):
    """The kernel layout (b, s, H, D) / (b, s, KV, D) of folded inputs."""
    return (ref.unfold_queries(folded_q, s), k.transpose(1, 2),
            v.transpose(1, 2))


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_function_gradient_matches_jax_grad(case):
    """FlashAttention with the plain forward injected: its output, and
    its backward (the port of `_flash_bwd`, fed the forward's lse),
    against `flash_attention_ref` and `jax.grad` of it."""
    arrays, window, causal, scale = folded_case(case, seed=1)
    s = arrays[1].shape[2]
    cot = normals(*arrays[0].shape, seed=2)

    def jloss(q, k, v):
        out = jflash_ref.flash_attention_ref(
            q, k, v, jnp.asarray(arrays[3])[None, None],
            jnp.asarray(arrays[4])[None, None], None, scale, causal, window,
            512, False)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, arrays[:3]))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
    q, k, v = bshd(*leaves, s)
    calls = []

    def fwd(*args):
        calls.append(1)
        return ops._plain_forward(*args)

    out = ops.FlashAttention.apply(fwd, q, k, v, causal, window)
    folded = ref.fold_queries(out, k.shape[2])
    np.testing.assert_allclose(folded.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    torch.sum(folded * torch.tensor(cot)).backward()
    assert len(calls) == 1           # the backward runs no forward again
    for got, want in zip(leaves, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


# tests/test_kernels.py::TestFlashAttn's (s, window) pairs, and one
# bidirectional case at a multiple of the block (the JAX wrapper pads
# with unmasked zero keys otherwise)
KERNEL_CASES = [(32, None, True), (40, 9, True), (64, 16, True),
                (24, None, True), (32, None, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,causal", KERNEL_CASES)
def test_plain_version_matches_jax_kernel(s, window, causal, dtype):
    """The kernel's plain version (ops on a CPU tensor) against the JAX
    wrapper around `flash_attention_pallas` in interpret mode, at
    tests/test_kernels.py's shapes and tolerances."""
    b, nh, nkv, hd = 2, 4, 2, 16
    q, k, v = (normals(b, s, h, hd, seed=i)
               for i, h in enumerate((nh, nkv, nkv)))
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jflash_ops.flash_attention(
        *(jnp.asarray(a, jdtype) for a in (q, k, v)), n_kv_heads=nkv,
        causal=causal, window=window, bq=16, bk=16, interpret=True)
    tdtype = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.tensor(a).to(tdtype)
                                for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, s, nh, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=0,
                               atol=2e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window", [(40, 9), (24, None)])
def test_plain_version_matches_jax_kernel_at_head_dim_256(s, window, dtype):
    """gemma3-12b's head_dim: the plain version against the Pallas kernel
    in interpret mode (the Pallas kernel takes any head_dim)."""
    q, k, v = (normals(1, s, h, 256, seed=i)
               for i, h in enumerate((4, 2, 2)))
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jflash_ops.flash_attention(
        *(jnp.asarray(a, jdtype) for a in (q, k, v)), n_kv_heads=2,
        causal=True, window=window, bq=16, bk=16, interpret=True)
    got = ops.flash_attention(*(torch.tensor(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=0,
                               atol=2e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,causal", [(40, 9, True), (24, None, True),
                                             (32, None, False)])
def test_plain_version_matches_jax_kernel_at_head_dim_80(s, window, causal,
                                                         dtype):
    """zamba2-2.7b's head_dim (2,560 / 32 = 80, a multiple of 16 but not
    of 32): the plain version against the Pallas kernel in interpret
    mode, grouped-query."""
    q, k, v = (normals(2, s, h, 80, seed=i)
               for i, h in enumerate((4, 2, 2)))
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jflash_ops.flash_attention(
        *(jnp.asarray(a, jdtype) for a in (q, k, v)), n_kv_heads=2,
        causal=causal, window=window, bq=16, bk=16, interpret=True)
    got = ops.flash_attention(*(torch.tensor(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), causal=causal,
                              window=window)
    assert got.shape == (2, s, 4, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=0,
                               atol=2e-5 if dtype == "float32" else 0.05)


# (sq, sk, causal) at multiples of the Pallas kernel's 16-row blocks:
# cross-attention's key lengths of their own, longer and shorter, and the
# causal mask over them (query i at position i, key j at position j)
CROSS_KERNEL_CASES = [(32, 48, False), (48, 16, False), (32, 48, True),
                      (48, 32, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", CROSS_KERNEL_CASES)
def test_plain_version_matches_pallas_kernel_at_a_key_length_of_its_own(
        sq, sk, causal, dtype):
    """The plain version at SQ != SK against `flash_attention_pallas`
    itself in interpret mode (the JAX wrapper is self-attention only):
    (b, H) folded into its BH axis, each query head against its kv
    head's keys, GQA H=4 over KV=2."""
    b, nh, nkv, hd = 2, 4, 2, 16
    q = normals(b, sq, nh, hd, seed=0)
    k, v = (normals(b, sk, nkv, hd, seed=i) for i in (1, 2))
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def bh(a):     # (b, n, h, d) -> (b * H, n, d), kv heads repeated
        a = np.repeat(a, nh // a.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
            b * nh, a.shape[1], hd), jdtype)

    want = jflash_kernel.flash_attention_pallas(
        bh(q), bh(k), bh(v), scale=hd ** -0.5, causal=causal, bq=16,
        bk=16, interpret=True)
    want = np.asarray(want, np.float32).reshape(b, nh, sq, hd).transpose(
        0, 2, 1, 3)
    got = ops.flash_attention(*(torch.tensor(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, sq, nh, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("sq,sk,causal,window", [(37, 53, False, None),
                                                 (53, 37, True, 30)])
def test_plain_version_matches_the_oracle_at_ragged_key_lengths(
        sq, sk, causal, window):
    """At lengths off the Pallas blocks: the plain version (out and lse)
    against `flash_attention_ref`, the Pallas kernel's oracle, with query
    positions 0..sq-1 and key positions 0..sk-1."""
    q = normals(1, sq, 4, 32, seed=0)
    k, v = (normals(1, sk, 2, 32, seed=i) for i in (1, 2))
    folded = ref.fold_queries(torch.tensor(q), 2).numpy()
    jout, jlse = jflash_ref._flash_fwd_inner(
        jnp.asarray(folded), *(jnp.asarray(a.transpose(0, 2, 1, 3))
                               for a in (k, v)),
        jnp.asarray(np.tile(np.arange(sq, dtype=np.int32), 2))[None, None],
        jnp.asarray(np.arange(sk, dtype=np.int32))[None, None], None,
        32 ** -0.5, causal, window, 512, False)
    out, lse = ref.flash_attention_plain(*map(torch.tensor, (q, k, v)),
                                         causal=causal, window=window)
    np.testing.assert_allclose(ref.fold_queries(out, 2).numpy(),
                               np.asarray(jout), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.reshape(1, 2, -1).numpy(),
                               np.asarray(jlse), rtol=0, atol=2e-5)


def test_plain_lse_is_the_row_log_sum_exp():
    q, k, v = (torch.tensor(normals(1, 70, h, 32, seed=i))
               for i, h in enumerate((4, 2, 2)))
    _, lse = ref.flash_attention_plain(q, k, v, window=20)
    scores = torch.einsum("bqhd,bkhd->bhqk", q,
                          k.repeat_interleave(2, dim=2)) * 32 ** -0.5
    i, j = torch.arange(70)[:, None], torch.arange(70)[None, :]
    scores = scores.masked_fill((j > i) | (j <= i - 20), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1),
                               rtol=0, atol=1e-5)


def test_ctypes_signature_matches_the_cuda_entry_point():
    """The wrapper's argtypes against `extern "C" int flash_attn(...)` in
    csrc/flash_attn.cu: one ctypes type per C parameter, of its kind."""
    src = (pathlib.Path(ops.__file__).parents[2] / "csrc"
           / "flash_attn.cu").read_text()
    decl = re.search(r'extern "C" int flash_attn\(([^)]*)\)', src).group(1)
    params = [" ".join(p.split()) for p in decl.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
             for p in params]
    assert ops.ARGTYPES == kinds


def test_head_dims_are_the_entry_points_instances():
    """HEAD_DIMS, which the wrapper checks (it raises for any other
    head_dim on the card), holds gemma3-12b's 256 and zamba2-2.7b's 80
    and is the set of head_dims the C entry point dispatches."""
    src = (pathlib.Path(ops.__file__).parents[2] / "csrc"
           / "flash_attn.cu").read_text()
    body = src[src.index('extern "C" int flash_attn('):]
    cases = tuple(int(d) for d in re.findall(r"case (\d+):", body))
    assert ops.HEAD_DIMS == cases == (32, 64, 80, 128, 256)


def test_kernel_reads_aligned_views_in_place_and_copies_the_rest():
    """The kernel reads q, k and v through their strides when each starts
    on 16 bytes with strides of whole 16 bytes (the strided qkv case);
    anything else is copied to a contiguous tensor first."""
    qkv = torch.randn(2, 5, 8, 32)
    for t in (qkv[:, :, :4], qkv[:, :, 4:6], qkv.to(torch.bfloat16)[:, :, 6:]):
        assert ops._readable(t) is t
    unaligned = torch.randn(2 * 5 * 4 * 32 + 1)[1:].view(2, 5, 4, 32)
    transposed = torch.randn(2, 5, 32, 4).transpose(2, 3)
    for t in (unaligned, transposed):
        got = ops._readable(t)
        assert got is not t and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        torch.testing.assert_close(got, t, rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.zeros(1, 8, h, 32) for h in (4, 2, 2))
    # a key length of its own is taken (cross-attention); a head_dim or
    # batch of its own is not
    assert ops.flash_attention(q, k[:, :4], v[:, :4]).shape == (1, 8, 4, 32)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q, k[..., :16], v[..., :16])
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q, k.expand(2, -1, -1, -1),
                            v.expand(2, -1, -1, -1))
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 32),
                            torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops._kernel_forward(q, k, v, True, None)


# (s, t, window, causal) of calls in which the last queries see no key
# (t + window <= s), causal and not, and at the equality itself
NO_KEY_CASES = [(8, 2, 2, True), (8, 2, 2, False), (8, 4, 4, True),
                (600, 40, 520, True), (600, 40, 560, False)]


@pytest.mark.parametrize("s,t,window,causal", NO_KEY_CASES)
def test_wrapper_refuses_queries_that_see_no_key(s, t, window, causal):
    """A window with t + window <= s leaves queries t + window - 1 ..
    s - 1 no key. The JAX kernel gives them the mean of the values
    (which depends on the padding), so the port refuses the call: the
    public wrapper on the CPU (the plain version) and the kernel path
    alike, before anything runs."""
    q = torch.zeros(1, s, 4, 32)
    k = v = torch.zeros(1, t, 2, 32)
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match="no key"):
        ops._kernel_forward(q, k, v, causal, window)


@pytest.mark.parametrize("s,t,window,causal", [
    (s, t, s + 1 - t, causal) for s, t, _, causal in NO_KEY_CASES])
def test_window_at_the_boundary_still_runs(s, t, window, causal):
    """At t + window = s + 1 the last query sees exactly one key: the
    wrapper takes the call, and its output and lse match the Pallas
    kernel's oracle (`flash_attention_ref`'s blockwise forward)."""
    q = normals(1, s, 4, 32, seed=0)
    k, v = (normals(1, t, 2, 32, seed=i) for i in (1, 2))
    jout, jlse = jflash_ref._flash_fwd_inner(
        jnp.asarray(ref.fold_queries(torch.tensor(q), 2).numpy()),
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (k, v)),
        jnp.asarray(np.tile(np.arange(s, dtype=np.int32), 2))[None, None],
        jnp.asarray(np.arange(t, dtype=np.int32))[None, None], None,
        32 ** -0.5, causal, window, 512, False)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    _, lse = ops._plain_forward(tq, tk, tv, causal, window)
    np.testing.assert_allclose(ref.fold_queries(out, 2).numpy(),
                               np.asarray(jout), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.reshape(1, 2, -1).numpy(),
                               np.asarray(jlse), rtol=0, atol=2e-5)


def attention_case(s, qk_norm, seed=0):
    d_model, nh, nkv, hd = 64, 4, 2, 16
    jparams = jattention.attention_init(KEY, d_model, nh, nkv, hd,
                                        qk_norm=qk_norm)
    if qk_norm:   # scales away from 1, so that they are exercised
        jparams = dict(jparams, q_norm={"scale": jnp.full((hd,), 1.5)},
                       k_norm={"scale": jnp.full((hd,), 0.7)})
    x = normals(2, s, d_model, seed=seed)
    kw = dict(n_heads=nh, n_kv_heads=nkv, qk_norm=qk_norm)
    return jparams, x, kw, hd


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("s", [24, 520])
def test_attention_matches_jax(s, qk_norm):
    """Values and gradients (x and every parameter) on both branches:
    s = 24 takes the naive softmax, s = 520 the flash path (the kernel
    wrapper's plain forward and the port's FlashAttention-2 backward)."""
    jparams, x, kw, hd = attention_case(s, qk_norm)
    cot = normals(2, s, 64, seed=3)
    jinv = jrope.rope_frequencies(hd)

    def jloss(p, x):
        y = jattention.attention_apply(p, x, inv_freq=jinv, **kw)
        return jnp.sum(y * cot), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
    tparams = tree_map(lambda t: t.requires_grad_(),
                       interop.to_torch(jax.device_get(jparams), "cpu"))
    tx = torch.tensor(x, requires_grad=True)
    y = attention.attention_apply(tparams, tx,
                                  inv_freq=rope.rope_frequencies(hd), **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    torch.sum(y * torch.tensor(cot)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    for t, want in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jgp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


def test_cross_attention_takes_the_flash_branch_as_jax(monkeypatch):
    """Flash-sized calls whose mask does not depend on positions take
    the flash branch in both packages: cross-attention (s 520 queries
    against t 600 keys from kv_x, no RoPE), its values and gradients
    (x, kv_x and every parameter) against `jax.grad` of JAX's attention
    to 1e-5; the same keys pre-projected (`kv_override`, cross-attention
    decode) and the encoder's bidirectional self-attention at explicit
    positions, values to 1e-5 (the weights' gradients to 1e-5 relative
    as well). A causal call with kv_x still raises."""
    jparams, x, kw, hd = attention_case(520, False)
    x = x[:1]
    enc = normals(1, 600, 64, seed=5)
    cot = normals(1, 520, 64, seed=3)
    taken = []
    tref = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: (
        taken.append((a[0].shape[1], a[1].shape[1])), tref(*a, **k))[1])

    def jloss(p, x, e):
        y = jattention.attention_apply(p, x, causal=False, kv_x=e, **kw)
        return jnp.sum(y * cot), y

    (_, jy), jgrads = level0(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jparams, jnp.asarray(x), jnp.asarray(enc))
    tparams = tree_map(lambda t: t.requires_grad_(),
                       interop.to_torch(jax.device_get(jparams), "cpu"))
    tx, tenc = (torch.tensor(a, requires_grad=True) for a in (x, enc))
    y = attention.attention_apply(tparams, tx, causal=False, kv_x=tenc,
                                  **kw)
    assert taken == [(520, 600)]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    torch.sum(y * torch.tensor(cot)).backward()
    got = tree_leaves(tparams) + [tx, tenc]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for i, (t, w) in enumerate(zip(got, want)):
        # the weights' gradients sum 520 x 600 pairs and reach ~10: their
        # float32 round-off is relative
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5 if i < len(got) - 2 else 0,
                                   atol=1e-5)
    tparams = interop.to_torch(jax.device_get(jparams), "cpu")
    kv = jattention.attention_kv(jparams, jnp.asarray(enc), n_kv_heads=2)
    for jcall, tcall in (
            (dict(kv_override=kv),
             dict(kv_override=interop.to_torch(kv, "cpu"))),
            (dict(q_positions=jnp.arange(520)[None] + 3,
                  inv_freq=jrope.rope_frequencies(hd)),
             dict(q_positions=torch.arange(520)[None] + 3,
                  inv_freq=rope.rope_frequencies(hd)))):
        want = jattention.attention_apply(jparams, jnp.asarray(x),
                                          causal=False, **kw, **jcall)
        with torch.no_grad():
            got = attention.attention_apply(tparams, torch.tensor(x),
                                            causal=False, **kw, **tcall)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert taken == [(520, 600)] * 2 + [(520, 520)]
    with pytest.raises(NotImplementedError, match="flash path"):
        attention.attention_apply(tparams, torch.tensor(x),
                                  kv_x=torch.tensor(enc), **kw)


def test_flash_branch_starts_at_the_same_length_as_jax(monkeypatch):
    """s * s >= 512 * 512 + 1: s = 512 runs the naive softmax in both
    packages, s = 513 the flash path in both."""
    taken = {"jax": [], "port": []}
    jref = jattention.flash_attention_ref
    tref = ops.flash_attention
    monkeypatch.setattr(jattention, "flash_attention_ref", lambda *a: (
        taken["jax"].append(a[0].shape), jref(*a))[1])
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: (
        taken["port"].append(a[0].shape), tref(*a, **k))[1])
    for s in (512, 513):
        jparams, x, kw, _ = attention_case(s, False)
        x = x[:1]
        jattention.attention_apply(jparams, jnp.asarray(x), **kw)
        attention.attention_apply(interop.to_torch(jparams, "cpu"),
                                  torch.tensor(x), **kw)
    assert taken["jax"] == [(1, 2, 2 * 513, 16)]
    assert taken["port"] == [(1, 513, 4, 16)]


def test_attention_and_mlp_refuse_what_is_not_ported(tmp_path):
    """The serving arguments, once refused, now give JAX's values (their
    cache paths: tests/test_torch_serving.py); the flash path still
    takes only self-attention at positions 0..s-1. The fused projections
    and the k/v-repeating flash layout, once refused, give the unfused
    layers' values (against JAX: tests/test_torch_tp.py); the TP
    feed-forward needs a model group, equals the plain one on a group of
    one rank, and refuses the fused w_inga, as the JAX package does."""
    jparams, x, kw, _ = attention_case(8, False)
    tparams = interop.to_torch(jparams, "cpu")
    tx = torch.tensor(x)
    pos = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [0, 1, 2, 3, 4, 5, 6, 7]])
    enc = normals(2, 5, 64, seed=4)
    for jserving, tserving in (
            (dict(kv_x=jnp.asarray(enc)), dict(kv_x=torch.tensor(enc))),
            (dict(return_kv=True), dict(return_kv=True)),
            (dict(q_positions=jnp.asarray(pos)),
             dict(q_positions=torch.tensor(pos)))):
        want = jattention.attention_apply(jparams, jnp.asarray(x), **kw,
                                          **jserving)
        got = attention.attention_apply(tparams, tx, **kw, **tserving)
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    x520 = torch.tensor(attention_case(520, False)[1][:1])
    with pytest.raises(NotImplementedError, match="flash path"):
        attention.attention_apply(tparams, x520, **kw,
                                  q_positions=torch.arange(520)[None])
    fused = {"wqkv": torch.cat([tparams["wq"], tparams["wk"],
                                tparams["wv"]], dim=1), "wo": tparams["wo"]}
    torch.testing.assert_close(attention.attention_apply(fused, tx, **kw),
                               attention.attention_apply(tparams, tx, **kw),
                               rtol=1e-6, atol=1e-6)
    assert set(attention.attention_init(torch.Generator(), 64, 4, 2,
                                        fuse_qkv=True)) == {"wqkv", "wo"}
    ff = mlp.mlp_init(torch.Generator().manual_seed(1), 64, 32)
    ff_fused = {"w_inga": torch.cat([ff["w_in"], ff["w_gate"]], dim=1),
                "w_out": ff["w_out"]}
    torch.testing.assert_close(mlp.mlp_apply(ff_fused, tx),
                               mlp.mlp_apply(ff, tx), rtol=1e-6, atol=1e-6)
    assert set(mlp.mlp_init(torch.Generator(), 8, 16, fuse_gate=True)) == {
        "w_inga", "w_out"}
    torch.testing.assert_close(
        attention.attention_apply(tparams, x520, flash_repeat_kv=True, **kw),
        attention.attention_apply(tparams, x520, **kw), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(RuntimeError, match="no 'model' process group"):
        mlp.mlp_apply(ff, tx, tp_axis="model")
    with world_of_one(tmp_path) as group:
        assert torch.equal(mlp.mlp_apply(ff, tx, tp_axis=group),
                           mlp.mlp_apply(ff, tx))
        with pytest.raises(ValueError, match="fuse_gate=True"):
            mlp.mlp_apply(ff_fused, tx, tp_axis=group)


# ---------------------------------------------------------------------------
# The kernel's schedule (csrc/flash_attn.cu), mirrored in plain torch
# ---------------------------------------------------------------------------

# head_dim -> (warpgroups of 64 query rows a block, keys a tile), as
# flash_attn.cu's Cfg
KERNEL_TILES = {32: (1, 64), 64: (2, 64), 80: (2, 32), 128: (2, 16),
                256: (1, 8)}
# P's A fragment column c of an 8-key step holds key PAIRED[c]: column t
# is key 2t and column t + 4 key 2t + 1 (the order V^T holds them in)
PAIRED = [0, 2, 4, 6, 1, 3, 5, 7]
LOG2E = 1.4426950408889634


def kernel_schedule(q, k, v, causal=True, window=None, mm=torch.matmul):
    """The CUDA kernel's algorithm on q (b, s, H, D), k, v (b, t, KV, D)
    (query i at position i, key j at position j):
    blocks of 64-row warpgroups (each 4 warps of 16 rows), each over the
    key tiles of its block's reachable range, skipping tiles none of its
    rows can see; per tile S = (log2(e) / sqrt(D) Q) K^T, an online
    softmax in base 2 (row max, p = 2^(s - m), p = 0 before the first
    key), then P V over 8-key steps with the keys paired as P's A
    fragment reads them; lse = m ln 2 + ln l. Returns (out (b, s, H, D),
    lse (b, H, s)); `mm` takes every matrix product."""
    b, s, h, d = q.shape
    t = k.shape[1]
    g = h // k.shape[2]
    groups, bk = KERNEL_TILES[d]
    bq = 64 * groups
    out = torch.zeros(b, s, h, d, dtype=q.dtype)
    lse = torch.zeros(b, h, s, dtype=q.dtype)

    def rows(x, start, n):   # rows [start, start + n) of x (len, D), 0 past
        return torch.nn.functional.pad(
            x[start:start + n], (0, 0, 0, max(0, start + n - x.shape[0])))

    for bi in range(b):
        for hi in range(h):
            kq, vq = k[bi, :, hi // g], v[bi, :, hi // g]
            n_qt = -(-s // bq)
            for z in range(n_qt):
                q0 = (n_qt - 1 - z) * bq
                q_last = min(q0 + bq - 1, s - 1)
                kt_end = (min(q_last, t - 1) if causal else t - 1) // bk
                kt_begin = ((q0 - window + 1) // bk
                            if window and q0 - window + 1 > 0 else 0)
                for r0 in range(q0, q0 + bq, 64):
                    if r0 >= s:
                        continue
                    qi = r0 + torch.arange(64)
                    qw = rows(q[bi, :, hi], r0, 64) * (LOG2E * d ** -0.5)
                    m = torch.full((64,), -torch.inf, dtype=q.dtype)
                    l = torch.zeros(64, dtype=q.dtype)
                    o = torch.zeros(64, d, dtype=q.dtype)
                    for kt in range(kt_begin, kt_end + 1):
                        k0 = kt * bk
                        if (causal and k0 > r0 + 63) or (
                                window and k0 + bk - 1 <= r0 - window):
                            continue
                        kj = k0 + torch.arange(bk)
                        sc = mm(qw, rows(kq, k0, bk).T)
                        ok = (kj < t)[None, :].expand(64, bk)
                        if causal:
                            ok = ok & (kj[None, :] <= qi[:, None])
                        if window:
                            ok = ok & (kj[None, :] > qi[:, None] - window)
                        sc = torch.where(ok, sc, -torch.inf)
                        m_new = torch.maximum(m, sc.amax(1))
                        base = torch.where(m_new == -torch.inf, 0.0, m_new)
                        alpha = torch.exp2(m - base)
                        p = torch.exp2(sc - base[:, None])
                        l = alpha * l + p.sum(1)
                        o = alpha[:, None] * o
                        vt = rows(vq, k0, bk)
                        for j in range(0, bk, 8):
                            keys = [j + i for i in PAIRED]
                            o = o + mm(p[:, keys], vt[keys])
                        m = m_new
                    n = min(64, s - r0)
                    ls = torch.clamp(l, min=1e-30)
                    out[bi, r0:r0 + n, hi] = (o / ls[:, None])[:n]
                    lse[bi, hi, r0:r0 + n] = (m * np.log(2.0)
                                              + torch.log(ls))[:n]
    return out, lse


# (D, s, window, causal, t): ragged last key and query tiles, GQA H=4
# over KV=2; s = 150 at D = 32 gives three 64-row warpgroups, the last
# one ragged, and a window that skips whole key tiles; D = 80
# (zamba2-2.7b) tiles D in steps of 8, not of 32. t != s: cross-attention
# (bidirectional, t > s and t < s, t below one key tile), and causal and
# windowed masks over a key length of their own (every query sees a key)
SCHEDULE_CASES = {
    "d32-s150": (32, 150, None, True, 150),
    "d32-s150-w9": (32, 150, 9, True, 150),
    "d256-s45-w20": (256, 45, 20, True, 45),
    "d256-s45-bidirectional": (256, 45, None, False, 45),
    "d80-s150-w40": (80, 150, 40, True, 150),
    "d64-s100-t150-bidirectional": (64, 100, None, False, 150),
    "d128-s90-t37-bidirectional": (128, 90, None, False, 37),
    "d32-s70-t5-bidirectional": (32, 70, None, False, 5),
    "d32-s150-t70-causal": (32, 150, None, True, 70),
    "d64-s60-t130-w30": (64, 60, 30, True, 130),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_kernel_schedule_matches_jax(case):
    """The mirror, with the kernel's 3xTF32 products, against the JAX
    package's blockwise oracle of flash_attention_pallas (out and lse),
    to the kernel's tolerance."""
    d, s, window, causal, t = SCHEDULE_CASES[case]
    q, k, v = (normals(1, n, h, d, seed=i)
               for i, (n, h) in enumerate(((s, 4), (t, 2), (t, 2))))
    out, lse = kernel_schedule(*map(torch.tensor, (q, k, v)), causal,
                               window, mm=matmul_tf32(3))
    folded = ref.fold_queries(torch.tensor(q), 2).numpy()
    pos = np.arange(s, dtype=np.int32)
    jout, jlse = jflash_ref._flash_fwd_inner(
        jnp.asarray(folded), *(jnp.asarray(a.transpose(0, 2, 1, 3))
                               for a in (k, v)),
        jnp.asarray(np.tile(pos, 2))[None, None],
        jnp.asarray(np.arange(t, dtype=np.int32))[None, None],
        None, d ** -0.5, causal, window, 512, False)
    np.testing.assert_allclose(
        ref.fold_queries(out, 2).numpy(), np.asarray(jout), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.reshape(1, 2, -1).numpy(),
                               np.asarray(jlse), rtol=0, atol=2e-5)


def test_three_tf32_passes_hold_float32_accuracy():
    """Scores of |s| ~ 10 (q scaled by 10, D = 64): the mirror's products
    from TF32 operands stay within 2e-5 of the float64 result, out and
    lse, with three passes of the split, as float32 products do (their
    own rounding is ~1.5e-5 here, so the yardstick is float64), and not
    with one pass."""
    q, k, v = (torch.tensor(normals(1, 80, h, 64, seed=i))
               for i, h in enumerate((2, 1, 1)))
    q = q * 10
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(-1, -1, 2, -1))
    assert float((scores / 8).abs().median()) > 5
    out, lse = kernel_schedule(q.double(), k.double(), v.double())
    for mm, within in ((torch.matmul, True), (matmul_tf32(3), True),
                       (matmul_tf32(1), False)):
        out_mm, lse_mm = kernel_schedule(q, k, v, mm=mm)
        err = max(float((out_mm - out).abs().max()),
                  float((lse_mm - lse).abs().max()))
        assert (err <= 2e-5) == within, (mm, err)
