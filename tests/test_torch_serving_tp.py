"""Port parity: tensor-parallel serving (train to serve). A tp=2 engine,
one per rank of a model group of two gloo ranks on the CPU, loads an
UNMODIFIED global-shaped checkpoint (written by the JAX package's
`save_checkpoint`) and gives the tokens of the tp=1 engine (itself held
to the JAX engine in test_torch_serving_engine.py), with paged and with
dense caches, as tests/test_serving_tp.py holds the JAX engine; rank 0
alone hands out the finished requests. Then `launch.serve --tp 2` on the
same checkpoint prints tp=1's tokens.

Greedy sampling is replicated on every rank and tp changes only the
order of the w_out reduction, so greedy tokens over the reduced
qwen3-1.7b's well-separated logits are equal, token for token.
"""
import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro_torch import interop
from repro_torch.configs import get_arch_config
from repro_torch.launch import mesh, serve
from repro_torch.models import gan
from repro_torch.serving import Request, ServingEngine
import torch_mesh_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "qwen3-1.7b"
BLOCKS = (8, None)


def _workload(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, int(rng.integers(3, 14))).astype(
        np.int32), int(rng.integers(3, 7))) for _ in range(4)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(checkpoint dir, tp=1 tokens {rid: tokens}, per-rank tp=2 results
    from one spawn of 2 ranks)."""
    cfg = get_arch_config(ARCH).reduced()
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    ckpt = tmp_path_factory.mktemp("serve_tp")
    jsave_checkpoint(str(ckpt), 3, {"state": {"gen": interop.to_numpy(
        params)}})
    work = _workload(cfg.vocab)
    eng = ServingEngine(cfg, params, batch_size=2, max_len=32, block_size=8,
                        prefill_chunk=4, device="cpu")
    for i, (p, n) in enumerate(work):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    tp1 = {r.rid: list(r.out_tokens) for r in eng.run()}
    init = tmp_path_factory.mktemp("serve_tp_init") / "init"
    per_rank = mesh.spawn(
        functools.partial(torch_mesh_ranks.tp_serve, str(ckpt), ARCH, work,
                          BLOCKS),
        2, device="cpu", init_method=f"file://{init}", timeout_s=300, tp=2)
    return str(ckpt), tp1, per_rank


@pytest.mark.parametrize("block", BLOCKS, ids=["paged", "dense"])
def test_tp2_engine_serves_tp1_tokens(served, block):
    """Both ranks serve every request and give tp=1's tokens; rank 0's
    `run` hands them out, rank 1's returns none; each rank holds half of
    every w_out."""
    _, tp1, per_rank = served
    i = BLOCKS.index(block)
    cfg = get_arch_config(ARCH).reduced()
    assert len(tp1) == 4
    (handed0, own0, shape0), (handed1, own1, shape1) = (
        per_rank[0][i], per_rank[1][i])
    assert handed0 == tp1 and handed1 == {}
    assert own0 == own1 == tp1
    assert shape0 == shape1 == (cfg.n_groups_stack, cfg.d_ff // 2,
                                cfg.d_model)


def _printed_tokens(text):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"rid=(\d+): (\[[^\]]*\])", text)}


def test_serve_cli_tp2_prints_tp1_tokens(served, capsys):
    """`launch.serve --tp 2` (2 spawned gloo ranks, rank 0 prints) on the
    global checkpoint prints the tokens `--tp 1` prints."""
    ckpt, _, _ = served
    args = ["--arch", ARCH, "--reduced", "--ckpt-dir", ckpt, "--demo", "3",
            "--max-new", "4", "--batch", "2", "--max-len", "32",
            "--block-size", "8", "--device", "cpu"]
    assert serve.main(args) == 0
    one = capsys.readouterr().out
    assert serve.main(args + ["--tp", "2"]) == 0
    two = capsys.readouterr().out
    assert "tp=2" in two and "@ step 3" in two
    assert len(_printed_tokens(one)) == 3
    assert _printed_tokens(two) == _printed_tokens(one)
