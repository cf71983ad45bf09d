"""Port parity: the continuous-batching serving engine, its paged caches,
its front end and the serve CLI against the JAX package, and the
engine's host-side contracts (staggered admissions in one step, FIFO
admission, rejection, the compile bound, paged against dense).

Both packages serve the port's seeded generator (reduced configs) on the
same requests. Greedy tokens must equal JAX's engine's; temperature
tokens are the port's own draws (`_gumbel`), keyed by (seed, rid,
token_index) alone, and `_sample_one` fed JAX's Gumbel noise must give
`jax.random.categorical`'s token bit for bit. On the CPU the step runs
uncaptured; the CUDA graph capture is exercised by `chip_smoke.py`.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_arch_config as jget_arch_config
from repro.launch import serve as jserve
from repro.models import gan as jgan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import cache as jpaging
from repro.serving import engine as jengine
from repro_torch import interop
from repro_torch.configs import MoEConfig, get_arch_config
from repro_torch.launch import serve
from repro_torch.models import gan
from repro_torch.serving import Request, ServingEngine, ServingFrontend
from repro_torch.serving import cache as paging
from repro_torch.serving import engine
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import world_of_one


class _Level0Jax:
    """The `jax` module as `repro.serving.engine` sees it, with `jit`
    compiling at XLA's optimisation level 0 (the same programs, compiled
    in a fraction of the default's CPU time)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        compiled = {}

        def call(*args):
            sig = jax.tree_util.tree_structure(args), tuple(
                (np.shape(a), np.result_type(a))
                for a in jax.tree_util.tree_leaves(args))
            if sig not in compiled:
                compiled[sig] = jax.jit(fn, **kw).lower(*args).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            return compiled[sig](*args)
        return call


@pytest.fixture
def level0_jax_engine(monkeypatch):
    monkeypatch.setattr(jengine, "jax", _Level0Jax())


@functools.cache
def model(name):
    """(port config, the port's seeded generator as numpy)."""
    cfg = get_arch_config(name).reduced()
    return cfg, interop.to_numpy(gan.generator_lm_init(
        torch.Generator().manual_seed(0), cfg))


def make_engine(name, **kw):
    cfg, params = model(name)
    return ServingEngine(cfg, interop.to_torch(params, "cpu"), device="cpu",
                         **kw)


def serve_all(eng, work):
    """Submit (prompt, max_new, temperature) requests as rids 0..; run;
    {rid: tokens}."""
    for i, (p, n, t) in enumerate(work):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n,
                           temperature=t))
    return {r.rid: list(r.out_tokens) for r in eng.run()}


def greedy_reference(name, prompt, n_new):
    """Greedy decoding by the port's full forward over growing prefixes."""
    cfg, params = model(name)
    tp = interop.to_torch(params, "cpu")
    toks = torch.tensor(prompt, dtype=torch.int64)[None]
    with torch.no_grad():
        for _ in range(n_new):
            logits = gan.generator_lm_apply(tp, cfg, toks, mode="train",
                                            remat=False)["logits"]
            toks = torch.cat([toks, logits[:, -1:].argmax(-1)], dim=1)
    return toks[0, len(prompt):].tolist()


def prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# Paging
# ---------------------------------------------------------------------------

def test_paging_functions_match_jax():
    for name in ("qwen3-1.7b", "gemma3-12b", "mamba2-130m"):
        cfg = get_arch_config(name).reduced()
        jcfg = jget_arch_config(name).reduced()
        assert paging.paged_sub_names(cfg) == jpaging.paged_sub_names(jcfg)
        got, meta = paging.init_paged_caches(cfg, 3, 40, block_size=8)
        want, jmeta = jpaging.init_paged_caches(jcfg, 3, 40, block_size=8)
        assert meta == jmeta
        for sub in want:
            for leaf, w in want[sub].items():
                g = got[sub][leaf]
                assert tuple(g.shape) == w.shape
                assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert paging.cache_bytes(got) == jpaging.cache_bytes(want)
    assert paging.slot_max_blocks(33, 16) == jpaging.slot_max_blocks(33, 16)
    # the free list hands out the same ids in the same order
    port, ref = paging.BlockAllocator(9), jpaging.BlockAllocator(9)
    for op, n in (("alloc", 3), ("alloc", 2), ("free", [5, 2]),
                  ("alloc", 4), ("alloc", 1), ("alloc", 0), ("free", [7]),
                  ("alloc", 2)):
        if op == "alloc":
            assert port.alloc(n) == ref.alloc(n)
        else:
            port.free(n)
            ref.free(n)
        assert port.free_count == ref.free_count
    with pytest.raises(ValueError):
        port.free([0])
    # invalidating blocks clears their valid bits in every paged sublayer
    cfg = get_arch_config("qwen3-1.7b").reduced()
    caches, meta = paging.init_paged_caches(cfg, 2, 16, block_size=4)
    for sub in meta["paged_subs"]:
        caches[sub]["valid"].fill_(True)
    paging.invalidate_blocks(caches, meta["paged_subs"],
                             torch.tensor([2, 4, 0]))
    for sub in meta["paged_subs"]:
        cleared = ~caches[sub]["valid"].all(dim=(0, 2))
        assert cleared.nonzero().flatten().tolist() == [0, 2, 4]


# ---------------------------------------------------------------------------
# The engine against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m"])
def test_engine_greedy_tokens_match_jax_engine(name, level0_jax_engine):
    cfg, params = model(name)
    work = [(p, 5, 0.0) for p in prompts(cfg.vocab, (5, 7, 3), 0)]
    kw = dict(batch_size=2, max_len=32, block_size=8, prefill_chunk=4)
    jeng = JServingEngine(jget_arch_config(name).reduced(),
                          jax.tree_util.tree_map(jnp.asarray, params), **kw)
    for i, (p, n, _) in enumerate(work):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
    want = {r.rid: list(r.out_tokens) for r in jeng.run()}
    got = serve_all(make_engine(name, **kw), work)
    assert got == want and len(got) == 3
    for i, (p, n, _) in enumerate(work):
        assert got[i] == greedy_reference(name, p, n)


def test_sample_one_with_jax_gumbel_noise_is_jax_categorical():
    """The same Gumbel draws give jax.random.categorical's token, bit for
    bit, at every temperature; temp <= 0 is the argmax."""
    rng = np.random.default_rng(9)
    for vocab, scale in ((512, 1.0), (50, 30.0)):
        logits = (rng.standard_normal((6, vocab)) * scale).astype(np.float32)
        temps = np.array([0.8, 1.0, 0.05, 2.5, 0.0, -1.0], np.float32)
        base = jax.random.PRNGKey(7)
        keys = [jax.random.fold_in(jax.random.fold_in(base, rid), n)
                for rid, n in zip(range(6), (0, 3, 1, 9, 2, 4))]
        want = [int(jengine._sample_one(k, jnp.asarray(lg), jnp.float32(t)))
                for k, lg, t in zip(keys, logits, temps)]
        noise = np.stack([np.asarray(jax.random.gumbel(k, (vocab,),
                                                        jnp.float32))
                          for k in keys])
        got = engine._sample_one(torch.tensor(logits), torch.tensor(temps),
                                 torch.tensor(noise))
        assert got.tolist() == want


def test_port_draws_depend_on_the_request_alone():
    """The port's Gumbel noise is a function of (seed, rid, token index):
    a temperature request's tokens are the same served alone and in a
    mix, and the noise is standard Gumbel."""
    g = engine._gumbel(3, torch.tensor([5, 5, 6]), torch.tensor([0, 1, 0]),
                       4096)
    again = engine._gumbel(3, torch.tensor([6, 5]), torch.tensor([0, 0]),
                           4096)
    assert torch.equal(g[2], again[0]) and torch.equal(g[0], again[1])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert abs(float(g.mean()) - 0.5772) < 0.05      # Euler's constant
    cfg, _ = model("qwen3-1.7b")
    p = prompts(cfg.vocab, (6, 9, 4), 11)
    sampled = (p[1], 6, 0.8)
    kw = dict(batch_size=2, max_len=32, block_size=8, prefill_chunk=4,
              seed=4)
    alone = serve_all(make_engine("qwen3-1.7b", **kw), [sampled])[0]
    mixed = serve_all(make_engine("qwen3-1.7b", **kw),
                      [(p[0], 4, 0.0), (p[2], 5, 1.3), sampled])
    # rid 2 in the mix: re-serve alone under that rid
    solo = make_engine("qwen3-1.7b", **kw)
    solo.submit(Request(rid=2, prompt=sampled[0], max_new_tokens=6,
                        temperature=0.8))
    assert [r.out_tokens for r in solo.run()] == [mixed[2]]
    assert len(alone) == 6 and alone != mixed[2]      # another rid


@pytest.mark.parametrize("name", ["qwen3-1.7b", "gemma3-12b"])
def test_mixed_workload_paged_matches_dense(name):
    """Mixed lengths and temperatures through both cache backends: equal
    token streams, bit for bit; greedy requests equal the full-forward
    reference."""
    cfg, _ = model(name)
    rng = np.random.default_rng(3)
    work = [(rng.integers(0, cfg.vocab, int(rng.integers(2, 14))).astype(
        np.int32), int(rng.integers(2, 7)), temp)
        for temp in (0.0, 0.8, 0.0, 0.8, 0.0)]
    outs = {block: serve_all(make_engine(name, batch_size=2, max_len=32,
                                         block_size=block, prefill_chunk=4,
                                         seed=7), work)
            for block in (None, 8)}
    assert outs[None] == outs[8] and len(outs[8]) == len(work)
    for i, (p, n, t) in enumerate(work):
        if t == 0.0:
            assert outs[8][i] == greedy_reference(name, p, n)


def test_staggered_admissions_decode_in_a_single_step():
    """Slots admitted at different times sit at distinct positions, and
    one step advances all of them; the steps that prefill a new slot's
    chunk keep every decoding slot moving."""
    cfg, _ = model("qwen3-1.7b")
    p = prompts(cfg.vocab, (4, 9, 6), 2)
    eng = make_engine("qwen3-1.7b", batch_size=3, max_len=48, block_size=8,
                      prefill_chunk=4)
    eng.submit(Request(rid=0, prompt=p[0], max_new_tokens=12))
    for _ in range(5):
        assert eng.step()
    eng.submit(Request(rid=1, prompt=p[1], max_new_tokens=12))
    eng.submit(Request(rid=2, prompt=p[2], max_new_tokens=12))
    r0 = eng.slots[0].req
    before, d0 = len(r0.out_tokens), eng.dispatch_count
    while not all(s is not None and s.prefilled for s in eng.slots):
        assert eng.step()
    assert len(r0.out_tokens) - before == eng.dispatch_count - d0
    positions = [s.pos for s in eng.slots]
    assert len(set(positions)) == 3
    counts = [len(s.req.out_tokens) for s in eng.slots]
    d0 = eng.dispatch_count
    assert eng.step()
    assert eng.dispatch_count == d0 + 1
    assert [len(s.req.out_tokens) for s in eng.slots] == [c + 1
                                                           for c in counts]
    assert [s.pos for s in eng.slots] == [q + 1 for q in positions]
    finished = eng.run()
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    for req in finished:
        assert req.out_tokens == greedy_reference("qwen3-1.7b", req.prompt,
                                                  12)


def test_more_requests_than_slots_fifo_and_rejection():
    """More requests than slots all complete; with one slot they finish
    in submission order; requests that can never fit are rejected with
    a reason while the engine serves the rest."""
    cfg, _ = model("granite-3-2b")
    eng = make_engine("granite-3-2b", batch_size=2, max_len=24)
    got = serve_all(eng, [(p, 3, 0.0) for p in prompts(cfg.vocab, [4] * 5,
                                                       1)])
    assert sorted(got) == list(range(5))
    assert all(len(t) == 3 for t in got.values())
    eng = make_engine("granite-3-2b", batch_size=1, max_len=32, block_size=8)
    serve_all(eng, [(p, 2, 0.0) for p in prompts(cfg.vocab, (9, 2, 13, 5),
                                                 5)])
    assert [r.rid for r in eng.finished] == [0, 1, 2, 3]
    ok = prompts(cfg.vocab, (4, 4), 4)
    eng = make_engine("granite-3-2b", batch_size=2, max_len=16)
    eng.submit(Request(rid=0, prompt=ok[0], max_new_tokens=3))
    eng.submit(Request(rid=1, prompt=prompts(cfg.vocab, [20], 6)[0],
                       max_new_tokens=8))                   # 28 > 16
    eng.submit(Request(rid=2, prompt=np.zeros(0, np.int32)))
    eng.submit(Request(rid=3, prompt=ok[1], max_new_tokens=3))
    finished = eng.run()
    assert sorted(r.rid for r in finished) == [0, 3]
    assert [r.rid for r in eng.rejected] == [1, 2]
    assert "max_len" in eng.rejected[0].failed
    assert "empty" in eng.rejected[1].failed
    assert all(not r.done for r in eng.rejected)


def test_prefill_compile_count_is_log_bounded():
    cfg, _ = model("granite-3-2b")
    chunk = 8
    eng = make_engine("granite-3-2b", batch_size=2, max_len=64, block_size=8,
                      prefill_chunk=chunk)
    got = serve_all(eng, [(p, 2, 0.0) for p in prompts(
        cfg.vocab, (1, 2, 3, 5, 7, 9, 12, 17, 23), 6)])
    assert len(got) == 9
    assert eng.compile_count <= 1 + int(np.log2(chunk)) + 1
    assert eng.compile_count == 5     # {None, 1, 2, 4, 8}


def test_refusals_name_their_roadmap_items(tmp_path):
    qwen = get_arch_config("qwen3-1.7b").reduced()
    moe = dataclasses.replace(qwen, family="moe", moe=MoEConfig(
        n_experts=4, top_k=2, d_ff_expert=128))
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(moe, None, tp=2, device="cpu")
    with pytest.raises(ValueError, match="fuse_proj"):
        ServingEngine(dataclasses.replace(qwen, fuse_proj=True), None, tp=2,
                      device="cpu")
    # tp > 1, once refused, needs its model group (spawn(..., tp=2);
    # tests/test_torch_serving_tp.py serves on one)
    with pytest.raises(RuntimeError, match="no 'model' process group"):
        ServingEngine(qwen, None, tp=2, device="cpu")
    # the encoder-decoder and vision families, once refused, need the
    # frontend's features for their cross caches, as JAX's engine
    # asserts (tests/test_torch_encdec.py and test_torch_vlm.py serve
    # them); a family without cross sublayers ignores enc_feats, as in
    # JAX
    for cfg in (dataclasses.replace(qwen, family="encdec"),
                dataclasses.replace(qwen, family="vlm")):
        with pytest.raises(ValueError, match="enc_feats_fn"):
            ServingEngine(cfg, None, device="cpu")
    # the serve CLI passes no features, as JAX's passes none
    for name in ("whisper-base", "llama-3.2-vision-90b"):
        with pytest.raises(ValueError, match="enc_feats_fn"):
            serve.main(["--arch", name, "--reduced", "--device", "cpu"])
    _, params = model("qwen3-1.7b")
    toks = np.array([[3, 1, 4]], dtype=np.int32)
    with torch.no_grad():
        got = gan.generator_lm_apply(
            interop.to_torch(params, "cpu"), qwen, torch.tensor(toks).long(),
            enc_feats=torch.zeros(1, 4, qwen.d_model))["logits"]
    want = jgan.generator_lm_apply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jget_arch_config("qwen3-1.7b").reduced(), jnp.asarray(toks),
        enc_feats=jnp.zeros((1, 4, qwen.d_model)))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # the TP feed-forward: the plain logits on a model group of one rank
    tokens = torch.arange(1, 5, dtype=torch.int64)[None]
    with world_of_one(tmp_path) as group, torch.no_grad():
        assert torch.equal(
            gan.generator_lm_apply(interop.to_torch(params, "cpu"), qwen,
                                   tokens, tp_axis=group)["logits"],
            gan.generator_lm_apply(interop.to_torch(params, "cpu"), qwen,
                                   tokens)["logits"])


# ---------------------------------------------------------------------------
# The front end and the CLI
# ---------------------------------------------------------------------------

def test_frontend_futures_resolve_to_the_engine_tokens():
    cfg, _ = model("mamba2-130m")
    p = prompts(cfg.vocab, (5, 8, 3), 12)
    want = serve_all(make_engine("mamba2-130m", batch_size=2, max_len=24),
                     [(q, 4, 0.0) for q in p])
    with ServingFrontend(make_engine("mamba2-130m", batch_size=2,
                                     max_len=24)) as front:
        futs = [front.submit(q, max_new_tokens=4) for q in p]
        too_long = front.submit(np.ones(30, np.int32), max_new_tokens=4)
        got = [f.result(timeout=60).out_tokens for f in futs]
        with pytest.raises(RuntimeError, match="rejected"):
            too_long.result(timeout=60)
    assert got == [want[i] for i in range(3)]
    assert not front._thread.is_alive()


def rid_lines(text):
    return re.findall(r"rid=\d+: \[.*\]", text)


@pytest.mark.parametrize("block", ["16", "0"])
def test_serve_cli_on_a_jax_checkpoint_prints_jax_tokens(tmp_path, capsys,
                                                         block,
                                                         level0_jax_engine):
    """The port's `launch.serve.main` on a checkpoint written by the JAX
    package's save_checkpoint prints the JAX CLI's token streams, paged
    and dense."""
    _, params = model("qwen3-1.7b")
    jsave_checkpoint(str(tmp_path), 3, {"state": {"gen": params}})
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--ckpt-dir", str(tmp_path),
            "--demo", "3", "--max-new", "4", "--batch", "2", "--max-len",
            "32", "--block-size", block, "--prefill-chunk", "8"]
    assert jserve.main(argv) == 0
    want = rid_lines(capsys.readouterr().out)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(want) == 3 and rid_lines(out) == want
    assert "@ step 3" in out
    loaded, step = serve.load_generator_params(str(tmp_path))
    assert step == 3 and all(torch.equal(a, torch.tensor(b)) for a, b in zip(
        tree_leaves(loaded), tree_leaves(params)))
