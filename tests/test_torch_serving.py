"""Port parity: the serving paths of the model — attention's caches
(dense scatter, sliding-window ring, paged pool, scalar index), its
key-validity mask, return_kv, kv_x and kv_override; the Mamba-2 scan
from a carried state, the single-token step and the mixer's state,
token_mask and return_state paths; the decode caches; and
`generator_lm_apply` in train, prefill and decode — against the JAX
package.

The same inputs, drawn with numpy (parameters from the port's seeded
init), go through `repro` (jitted at XLA's optimisation level 0, which
compiles in a fraction of the default's time) and `repro_torch`. Tolerances: 1e-5 absolute
for outputs, logits and cache values; positions, validity bits and
greedy tokens exactly; prefill plus decode against the full forward at
2e-4, as the JAX package's own serving test. Writes that JAX drops
(masked tokens, the null block) must leave the port's caches bit for
bit unchanged.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs import get_arch_config as jget_arch_config
from repro.models import backbone as jbackbone
from repro.models import gan as jgan
from repro.nn import attention as jattention
from repro.nn import rope as jrope
from repro.nn import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_arch_config
from repro_torch.models import backbone, gan
from repro_torch.nn import attention, rope, ssm
from repro_torch.tree import tree_leaves, tree_map
from test_torch_checkpoint import level0
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
D, NH, NKV, HD = 64, 4, 2, 16


def normals(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_tree_close(got, want, atol=ATOL):
    """Port tree against a JAX tree: same keys; floats within atol,
    integers and bools exactly."""
    got_l, want_l = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        g, w = g.detach().float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@functools.cache
def attn_params():
    """qk-norm GQA attention (4 heads over 2 kv heads of 16) as numpy."""
    p = attention.attention_init(torch.Generator().manual_seed(0), D, NH,
                                 NKV, HD, qk_norm=True)
    p["q_norm"]["scale"].fill_(1.5)
    p["k_norm"]["scale"].fill_(0.7)
    return interop.to_numpy(p)


def dense_cache(b, L, filled, seed):
    """A random (b, L) cache whose slots [0, filled[i]) of row i are
    valid at positions 0..L-1."""
    return {"k": normals(b, L, NKV, HD, seed=seed),
            "v": normals(b, L, NKV, HD, seed=seed + 1),
            "pos": np.tile(np.arange(L, dtype=np.int32), (b, 1)),
            "valid": np.arange(L)[None, :] < np.asarray(filled)[:, None]}


# name -> (cache, apply kwargs); positions, masks and tables as numpy
CACHE_CASES = {
    # two rows at distinct positions, the last token of row 0 masked
    "dense": (dense_cache(2, 16, [5, 2], 1),
              dict(q_positions=np.array([[5, 6, 7], [2, 3, 4]]),
                   cache_write_mask=np.array([[1, 1, 0], [1, 1, 1]], bool))),
    # a 9-token chunk through a ring of 6: slots repeat, the ring evicts
    # keys the chunk's first queries need; the tail of row 1 masked
    "ring": (dense_cache(2, 6, [6, 4], 3),
             dict(window=6, q_positions=np.array([np.arange(10, 19),
                                                  np.arange(4, 13)]),
                  cache_write_mask=np.arange(9)[None, :]
                  < np.array([[9], [6]]))),
    "ring-decode": (dense_cache(2, 6, [6, 3], 5),
                    dict(window=6, q_positions=np.array([[13], [3]]))),
    # row 0 owns blocks 3 and 5 (positions 0..7): its position 8 maps to
    # the null block and is dropped; row 1 masks its last token
    "paged": ({"k": normals(7, 4, NKV, HD, seed=7),
               "v": normals(7, 4, NKV, HD, seed=8),
               "pos": np.tile(np.arange(4, dtype=np.int32), (7, 1)),
               "valid": np.zeros((7, 4), bool)},
              dict(q_positions=np.array([[6, 7, 8], [0, 1, 2]]),
                   paged_table=np.array([[3, 5, 0], [1, 2, 4]], np.int32),
                   cache_write_mask=np.array([[1, 1, 1], [1, 1, 0]], bool))),
    "scalar-index": (dense_cache(2, 16, [5, 5], 9),
                     dict(cache_index=5, q_positions=np.full((2, 1), 5))),
    "scalar-index-ring": (dense_cache(2, 6, [6, 6], 11),
                          dict(window=6, cache_index=9,
                               q_positions=np.full((2, 1), 9))),
}


def run_attention(jparams, x, cache, kw, causal=True):
    """attention_apply of both packages on the same inputs: ((jy,
    jcache), (ty, tcache)); the port's cache is a copy, updated in
    place."""
    jinv = jrope.rope_frequencies(HD)
    tinv = rope.rope_frequencies(HD)

    def tconv(v):
        return torch.tensor(v) if isinstance(v, np.ndarray) else v

    def jconv(v):
        return jnp.asarray(v)

    common = dict(n_heads=NH, n_kv_heads=NKV, qk_norm=True, causal=causal)
    arrays = {k: jconv(v) for k, v in kw.items() if k != "cache_index"
              and isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    jout = level0(lambda p, x, c, a: jattention.attention_apply(
        p, x, inv_freq=jinv, cache=c, **a, **static, **common))(
        jparams, jnp.asarray(x),
        None if cache is None else jax.tree_util.tree_map(jnp.asarray,
                                                          cache), arrays)
    tcache = None if cache is None else interop.to_torch(cache, "cpu")
    tout = attention.attention_apply(
        interop.to_torch(jparams, "cpu"), torch.tensor(x), inv_freq=tinv,
        cache=tcache, **{k: tconv(v) for k, v in kw.items()}, **common)
    return jout, tout, tcache


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_attention_cache_paths_match_jax(case):
    cache, kw = CACHE_CASES[case]
    s = kw["q_positions"].shape[1]
    x = normals(2, s, D, seed=20)
    (jy, jcache), (ty, tret), tcache = run_attention(attn_params(), x,
                                                     cache, kw)
    assert tret is tcache          # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    assert_tree_close(tcache, jcache)


@pytest.mark.parametrize("case", ["dense", "ring", "paged"])
def test_dropped_writes_leave_the_cache_bitwise_unchanged(case):
    """Every write masked (or, paged, every table entry the null block):
    each leaf keeps its bits, as JAX's dropped scatter."""
    cache, kw = CACHE_CASES[case]
    kw = dict(kw)
    if case == "paged":
        kw["paged_table"] = np.zeros_like(kw["paged_table"])
        kw.pop("cache_write_mask")
    else:
        kw["cache_write_mask"] = np.zeros(kw["q_positions"].shape, bool)
    x = normals(2, kw["q_positions"].shape[1], D, seed=21)
    (jy, jcache), (ty, _), tcache = run_attention(attn_params(), x, cache,
                                                  kw)
    for name, leaf in tcache.items():
        assert torch.equal(leaf, torch.tensor(cache[name])), name
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    assert_tree_close(tcache, jcache)


def test_return_kv_kv_x_and_kv_override_match_jax():
    jparams = attn_params()
    x = normals(2, 5, D, seed=30)
    enc = normals(2, 7, D, seed=31)
    (jy, jkv), (ty, tkv), _ = run_attention(jparams, x, None,
                                            dict(return_kv=True))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert_tree_close(tkv, jkv)
    # cross attention: keys and values from kv_x, bidirectional
    (jy, jkv), (ty, tkv), _ = run_attention(
        jparams, x, None, dict(kv_x=enc, return_kv=True), causal=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert_tree_close(tkv, jkv)
    # the same keys and values pre-projected (attention_kv, no RoPE)
    jover = jattention.attention_kv(jparams, jnp.asarray(enc),
                                    n_kv_heads=NKV, qk_norm=True)
    tover = attention.attention_kv(interop.to_torch(jparams, "cpu"),
                                   torch.tensor(enc), n_kv_heads=NKV,
                                   qk_norm=True)
    assert_tree_close(tover, jover)
    jy = jattention.attention_apply(jparams, jnp.asarray(x), n_heads=NH,
                                    n_kv_heads=NKV, qk_norm=True,
                                    causal=False, kv_override=jover)
    ty = attention.attention_apply(interop.to_torch(jparams, "cpu"),
                                   torch.tensor(x), n_heads=NH,
                                   n_kv_heads=NKV, qk_norm=True,
                                   causal=False, kv_override=tover)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_build_mask_k_valid_and_ring_dedup_match_jax():
    rng = np.random.default_rng(40)
    qp = rng.integers(0, 12, (2, 5))
    kp = rng.integers(0, 12, (2, 9))
    valid = rng.random((2, 9)) < 0.7
    for causal, window in ((True, None), (True, 3), (False, None)):
        want = jattention.build_mask(jnp.asarray(qp), jnp.asarray(kp),
                                     causal=causal, window=window,
                                     k_valid=jnp.asarray(valid))
        got = attention.build_mask(torch.tensor(qp), torch.tensor(kp),
                                   causal=causal, window=window,
                                   k_valid=torch.tensor(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = np.array([np.arange(3, 17), np.arange(0, 14)])
    slots = pos % 4
    mask = rng.random((2, 14)) < 0.8
    want = jattention._dedup_ring_slots(jnp.asarray(slots),
                                        jnp.asarray(pos), jnp.asarray(mask))
    got = attention._dedup_ring_slots(torch.tensor(slots), torch.tensor(pos),
                                      torch.tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def scan_arrays(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
                np.float32),
            (-np.exp(rng.standard_normal(h) * 0.4)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32))


def test_scan_from_a_state_and_decode_step_match_jax():
    b, h, p, g, n = 2, 4, 16, 2, 8
    x, dt, A, B, C = scan_arrays(b, 11, h, p, g, n, seed=50)
    s0 = normals(b, h, n, p, seed=51)
    jy, js = jssm.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, B, C)), chunk=4,
                               initial_state=jnp.asarray(s0),
                               return_final_state=True)
    ty, ts = ssm.ssd_scan_ref(*map(torch.tensor, (x, dt, A, B, C)), chunk=4,
                              initial_state=torch.tensor(s0),
                              return_final_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    args = (s0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    jy, js = jssm.ssd_decode_step(*map(jnp.asarray, args))
    ty, ts = ssm.ssd_decode_step(*map(torch.tensor, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)


MIXER = dict(d_state=8, head_dim=16, expand=2, n_groups=2, chunk=4)


@functools.cache
def mixer_params():
    return interop.to_numpy(ssm.ssd_mixer_init(
        torch.Generator().manual_seed(5), 32, d_state=8, head_dim=16,
        expand=2, n_groups=2))


@pytest.mark.parametrize("s,mask_rows", [(1, (1, 0)), (6, (6, 3)),
                                         (6, None)])
def test_mixer_state_paths_match_jax(s, mask_rows):
    """A decode step (row 1 inactive) and a state-carrying chunk (row 1's
    tail masked, or no mask) from a random carried state."""
    params = mixer_params()
    x = normals(2, s, 32, seed=60 + s)
    state = {"ssm": normals(2, 4, 8, 16, seed=62),
             "conv": normals(2, 3, 96, seed=63)}
    mask = (None if mask_rows is None else
            np.arange(s)[None, :] < np.array(mask_rows)[:, None])
    jy, jst = jssm.ssd_mixer_apply(
        params, jnp.asarray(x), state=jax.tree_util.tree_map(jnp.asarray,
                                                             state),
        token_mask=None if mask is None else jnp.asarray(mask), **MIXER)
    ty, tst = ssm.ssd_mixer_apply(
        interop.to_torch(params, "cpu"), torch.tensor(x),
        state=interop.to_torch(state, "cpu"),
        token_mask=None if mask is None else torch.tensor(mask), **MIXER)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert_tree_close(tst, jst)
    if mask_rows == (1, 0):     # n_valid = 0: the old conv carry, bitwise
        assert torch.equal(tst["conv"][1], torch.tensor(state["conv"][1]))


def test_mixer_prefill_returns_the_decode_state_as_jax():
    params = mixer_params()
    x = normals(2, 9, 32, seed=70)
    jy, jst = jssm.ssd_mixer_apply(params, jnp.asarray(x), return_state=True,
                                   **MIXER)
    ty, tst = ssm.ssd_mixer_apply(interop.to_torch(params, "cpu"),
                                  torch.tensor(x), return_state=True,
                                  **MIXER)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert_tree_close(tst, jst)


# ---------------------------------------------------------------------------
# Caches and the LM modes
# ---------------------------------------------------------------------------

ARCHS = ("qwen3-1.7b", "mamba2-130m", "gemma3-12b")


@functools.cache
def lm(name):
    """(JAX config, port config, the port's generator as numpy)."""
    tcfg = get_arch_config(name).reduced()
    return (jget_arch_config(name).reduced(), tcfg,
            interop.to_numpy(gan.generator_lm_init(
                torch.Generator().manual_seed(0), tcfg)))


@pytest.mark.parametrize("name", ARCHS)
def test_init_decode_caches_match_jax(name):
    jcfg, tcfg, _ = lm(name)
    for jdt, tdt in ((jnp.bfloat16, None), (jnp.float32, torch.float32)):
        want = jbackbone.init_decode_caches(jcfg, 3, 20, dtype=jdt)
        got = (backbone.init_decode_caches(tcfg, 3, 20) if tdt is None else
               backbone.init_decode_caches(tcfg, 3, 20, dtype=tdt))
        assert sorted(got) == sorted(want)
        for sub in want:
            assert sorted(got[sub]) == sorted(want[sub])
            for leaf, w in want[sub].items():
                g = got[sub][leaf]
                assert tuple(g.shape) == w.shape, (sub, leaf)
                assert str(g.dtype).split(".")[-1] == str(w.dtype), (
                    sub, leaf)
                assert not g.any()


def jax_decode(jcfg):
    """JAX's decode step at a traced cache_index, compiled at level 0."""
    return level0(lambda p, t, c, i: jgan.generator_lm_apply(
        p, jcfg, t, mode="decode", caches=c, cache_index=i, remat=False))


@functools.cache
def lm_modes(name):
    """JAX's and the port's train, prefill and decode outputs on the
    same 2 x 13 tokens: prefill of 12 (gemma3's window of 8 wraps its
    rings), then decode of the 13th at cache_index 12."""
    jcfg, tcfg, params = lm(name)
    toks = np.random.default_rng(80).integers(0, tcfg.vocab, (2, 13))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jt = jnp.asarray(toks)
    jfull = level0(lambda p, t: jgan.generator_lm_apply(
        p, jcfg, t, mode="train", remat=False))(jp, jt)
    jpre = level0(lambda p, t: jgan.generator_lm_apply(
        p, jcfg, t, mode="prefill", remat=False, prefill_cache_len=13))(
        jp, jt[:, :12])
    jdec = jax_decode(jcfg)(jp, jt[:, 12:], jpre["caches"], jnp.int32(12))
    tp = interop.to_torch(params, "cpu")
    tt = torch.tensor(toks)
    with torch.no_grad():
        tfull = gan.generator_lm_apply(tp, tcfg, tt, mode="train",
                                       remat=False)
        tpre = gan.generator_lm_apply(tp, tcfg, tt[:, :12], mode="prefill",
                                      remat=False, prefill_cache_len=13)
        pre_caches = tree_map(lambda t: t.clone(), tpre["caches"])
        tdec = gan.generator_lm_apply(tp, tcfg, tt[:, 12:], mode="decode",
                                      caches=tpre["caches"], cache_index=12,
                                      remat=False)
    return ((jfull, jpre, jdec), (tfull, pre_caches, tpre, tdec))


@pytest.mark.parametrize("name", ARCHS)
def test_lm_train_prefill_decode_match_jax(name):
    (jfull, jpre, jdec), (tfull, pre_caches, tpre, tdec) = lm_modes(name)
    np.testing.assert_allclose(tfull["logits"].numpy(),
                               np.asarray(jfull["logits"]), atol=ATOL)
    np.testing.assert_allclose(tpre["logits"].numpy(),
                               np.asarray(jpre["logits"]), atol=ATOL)
    assert_tree_close(pre_caches, jpre["caches"])
    np.testing.assert_allclose(tdec["logits"].numpy(),
                               np.asarray(jdec["logits"]), atol=ATOL)
    assert_tree_close(tdec["caches"], jdec["caches"])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_matches_the_full_forward(name):
    _, (tfull, _, _, tdec) = lm_modes(name)
    np.testing.assert_allclose(tdec["logits"][:, 0].numpy(),
                               tfull["logits"][:, -1].numpy(), atol=2e-4)


@pytest.mark.parametrize("name", ["granite-3-2b", "mamba2-130m",
                                  "gemma3-12b"])
def test_multi_step_greedy_decode_matches_jax(name):
    """Prefill 8 tokens, then 3 greedy decode steps at cache_index: the
    4 tokens equal JAX's, and greedy decoding over growing prefixes."""
    jcfg, tcfg, params = lm(name)
    toks = np.random.default_rng(81).integers(0, tcfg.vocab, (1, 8))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = interop.to_torch(params, "cpu")

    def jax_run():
        out = level0(lambda p, t: jgan.generator_lm_apply(
            p, jcfg, t, mode="prefill", remat=False, prefill_cache_len=12))(
            jp, jnp.asarray(toks))
        decode = jax_decode(jcfg)
        cur, caches, got = jnp.argmax(out["logits"][:, -1:], -1), \
            out["caches"], []
        for t in range(4):
            got.append(int(cur[0, 0]))
            if t < 3:
                out = decode(jp, cur, caches, jnp.int32(8 + t))
                cur = jnp.argmax(out["logits"][:, -1:], -1)
                caches = out["caches"]
        return got

    with torch.no_grad():
        out = gan.generator_lm_apply(tp, tcfg, torch.tensor(toks),
                                     mode="prefill", remat=False,
                                     prefill_cache_len=12)
        cur, caches, got = out["logits"][:, -1:].argmax(-1), \
            out["caches"], []
        for t in range(4):
            got.append(int(cur[0, 0]))
            if t < 3:
                out = gan.generator_lm_apply(tp, tcfg, cur, mode="decode",
                                             caches=caches,
                                             cache_index=8 + t, remat=False)
                cur = out["logits"][:, -1:].argmax(-1)
        ref = torch.tensor(toks)
        for _ in range(4):
            nxt = gan.generator_lm_apply(tp, tcfg, ref, mode="train",
                                         remat=False)["logits"][:, -1:]
            ref = torch.cat([ref, nxt.argmax(-1)], dim=1)
    assert got == jax_run()
    assert got == ref[0, 8:].tolist()
