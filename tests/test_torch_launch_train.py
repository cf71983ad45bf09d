"""Port parity: the launcher `repro_torch.launch.train` against
`repro.launch.train` — its refusals (exit code 2 for the argv JAX's
`main` refuses, before anything is built), `chunk_lengths`, an exact
resume, checkpoints across packages, the mesh layout on 2 gloo ranks
against the stacked layout, and `AsyncCheckpointer`.

The runs are reduced mamba2-130m on the CPU (`--device cpu`), K=2, two
sequences of 16 tokens, the launch step's protocol (five local and five
server SGD steps a round, bfloat16 state), through `main(argv)` in this
process (the mesh runs spawn their 2 ranks). The mesh runs average with
the wavg kernel's plain version on the all-gathered payload
(--avg-impl pallas) and through the ring (--avg-impl ring), the stacked
run on the stacked payload. The runs compute the same rounds in another
order of bfloat16 operations (a worker a rank, or the K workers batched),
whose round-off the GAN carries on. After 2 rounds each net's update
(new - start), beyond the one bfloat16 step of rounding of the stored
results, lies from the stacked run's by a share of its norm
(`update_norms`, all leaves together): measured 0 for pallas (every
element within a step) and 7.3e-3 (generator) and 3.8e-2
(discriminator) for the ring, where the dequantized uploads accumulate
in float32 instead of being rounded to bfloat16 first; held to
MESH_UPDATE_TOL.
"""
import functools
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.launch import train as jtrain
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ShapeConfig, get_arch_config
from repro_torch.core import protocol
from repro_torch.launch import mesh, steps, train
from repro_torch.models import gan
from repro_torch.tree import tree_leaves
from test_torch_launch_steps import update_norms
import torch_mesh_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import world_of_one

RUN = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
       "--data-dim", "2", "--batch", "4", "--seq-len", "16"]
MESH_UPDATE_TOL = 0.1

# argv the JAX launcher refuses (ap.error, exit code 2), in its order
JAX_REFUSALS = {
    "fedgan-stacked": ["--algorithm", "fedgan"],
    "resume-no-dir": ["--resume"],
    "tp-0": ["--tp", "0"],
    "tp-stacked": ["--tp", "2"],
    "model-dim-mesh": ["--layout", "mesh", "--model-dim", "2"],
    "faults-stacked": ["--dropout", "0.5"],
    "reducer-stacked": ["--reducer", "krum"],
    "faults-tp": ["--layout", "mesh", "--tp", "2", "--byzantine", "1"],
    "avg-impl-stacked": ["--avg-impl", "ring"],
    "ring-tp": ["--layout", "mesh", "--tp", "2", "--avg-impl", "ring"],
    "ring-reducer": ["--layout", "mesh", "--avg-impl", "ring", "--reducer",
                     "trimmed_mean"],
    "ring-free-riders": ["--layout", "mesh", "--avg-impl", "ring",
                         "--free-riders", "1"],
}


def _error(capsys):
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("case", list(JAX_REFUSALS))
def test_refusals_are_the_jax_launchers(case, monkeypatch, capsys):
    """Each argv JAX's `main` refuses exits 2 in the port too, with the
    same message, before anything is built."""
    argv = JAX_REFUSALS[case]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as jexit:
        jtrain.main()
    want = _error(capsys)
    with pytest.raises(SystemExit) as texit:
        train.main(argv)
    assert jexit.value.code == texit.value.code == 2
    assert _error(capsys) == want


@pytest.mark.parametrize("argv,item", [(["--model-dim", "2"], "10c"),
                                       (["--distributed"], "item 1")])
def test_refuses_what_is_not_ported(argv, item, capsys):
    """--model-dim (the GSPMD model axis) and --distributed (several
    machines) exit 2 naming the ROADMAP item that would bring them."""
    with pytest.raises(SystemExit) as exit_:
        train.main(argv)
    assert exit_.value.code == 2 and item in _error(capsys)


@pytest.mark.parametrize("rounds,fuse", [(4, 2), (3, 2), (5, 3), (1, 4),
                                         (0, 2), (7, 1)])
def test_chunk_lengths_are_the_jax_launchers(rounds, fuse):
    assert train.chunk_lengths(rounds, fuse) == jtrain.chunk_lengths(
        rounds, fuse)


def _run(argv):
    assert train.main(RUN + argv) == 0


def _same_checkpoint(got_dir, want_dir, step=None):
    """Two checkpoints bit for bit: every leaf's dtype, shape and bytes."""
    (got, gstep, _), (want, wstep, _) = (load_checkpoint(d, step)
                                         for d in (got_dir, want_dir))
    assert gstep == wstep
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = (v.view(torch.int16).numpy() if torch.is_tensor(v)
                else np.asarray(v) for v in (x, y))
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted 4-round run (checkpoints at rounds 2 and 4), a
    3-round run with a checkpoint at round 2, and its resume to round 4
    (fuse 2 each)."""
    root = tmp_path_factory.mktemp("runs")
    torch.set_num_threads(1)
    dirs = {name: str(root / name) for name in ("whole", "cut")}
    _run(["--rounds", "4", "--fuse-rounds", "2", "--ckpt-every", "2",
          "--ckpt-dir", dirs["whole"]])
    _run(["--rounds", "3", "--fuse-rounds", "2", "--ckpt-every", "2",
          "--ckpt-dir", dirs["cut"]])
    tree, step, meta = load_checkpoint(dirs["cut"])
    assert step == 3
    _run(["--rounds", "4", "--fuse-rounds", "2", "--ckpt-dir", dirs["cut"],
          "--resume"])
    return dirs


def test_resume_is_bit_for_bit_an_uninterrupted_run(runs, capsys):
    """--rounds 3 --fuse-rounds 2 --ckpt-every 2 wrote rounds 2 and 3;
    --resume to 4 then equals the uninterrupted 4-round run bit for bit
    (state, round index, sim wallclock, scheduler carry), and a resume
    past the last round has nothing to do."""
    _same_checkpoint(runs["cut"], runs["whole"])
    tree, step, meta = load_checkpoint(runs["cut"], 2)
    assert int(tree["trainer"]["round_index"]) == 2 == step
    assert meta == {"layout": "stacked", "algorithm": "proposed", "tp": 1}
    _run(["--rounds", "4", "--ckpt-dir", runs["cut"], "--resume"])
    assert "nothing to do" in capsys.readouterr().out


def test_checkpoints_cross_packages(runs, tmp_path):
    """JAX's `load_checkpoint` reads the port's round-3 checkpoint (its
    bfloat16 leaves bit for bit), and that tree written back by JAX's
    `save_checkpoint` resumes in the port to the uninterrupted run."""
    jtree, step, meta = jload_checkpoint(runs["cut"], 3)
    tree, _, _ = load_checkpoint(runs["cut"], 3)
    for x, y in zip(tree_leaves(tree), jax.tree_util.tree_leaves(jtree)):
        y = np.asarray(y)
        x = x.view(torch.int16).numpy() if torch.is_tensor(x) else x
        assert x.tobytes() == (y.view(np.int16) if y.dtype.name ==
                               "bfloat16" else y).tobytes()
    jsave_checkpoint(str(tmp_path), step, jtree, metadata=meta)
    _run(["--rounds", "4", "--fuse-rounds", "2", "--ckpt-dir",
          str(tmp_path), "--resume"])
    _same_checkpoint(str(tmp_path), runs["whole"])


def update_residual_of_net(port_tree, ref_tree, start_tree):
    """`update_norms` over a whole net: the residuals' norm over the
    reference update's norm, all leaves together."""
    pairs = update_norms(port_tree, ref_tree, start_tree)
    return (sum(r * r for r, _ in pairs) / sum(u * u for _, u in pairs)
            ) ** 0.5


def test_mesh_layout_on_two_ranks_is_the_stacked_run(runs, tmp_path,
                                                     capfd):
    """--layout mesh --data-dim 2 on 2 gloo ranks, averaging through the
    flat gather (--avg-impl pallas) and through the ring: the same
    per-chunk participation, the round index and a positive simulated
    wallclock in their checkpoints, and after 2 rounds each net within
    MESH_UPDATE_TOL of the stacked run's (module docstring)."""
    dirs = {impl: str(tmp_path / impl) for impl in ("pallas", "ring")}
    argvs = [RUN + ["--rounds", "2", "--fuse-rounds", "2", "--layout",
                    "mesh", "--avg-impl", impl, "--ckpt-dir", d]
             for impl, d in dirs.items()]
    mesh.spawn(functools.partial(torch_mesh_ranks.launch_cli_runs, argvs),
               2, device="cpu", init_method=f"file://{tmp_path / 'init'}")
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("rounds")]
    assert len(lines) == 2 and all("participation=+1.0000" in ln
                                   for ln in lines)
    stacked = load_checkpoint(runs["whole"], 2)[0]["state"]
    start = steps._bf16_floats(protocol.make_train_state(
        lambda g: gan.gan_init(g, get_arch_config("mamba2-130m").reduced()),
        protocol.ProtocolConfig(n_devices=2), 2, device="cpu"))
    for impl, d in dirs.items():
        tree, _, meta = load_checkpoint(d)
        assert meta["layout"] == "mesh"
        assert int(tree["trainer"]["round_index"]) == 2
        assert float(tree["trainer"]["sim_wall"]) > 0
        for part in ("gen", "disc"):
            residual = update_residual_of_net(tree["state"][part],
                                              stacked[part], start[part])
            assert residual <= MESH_UPDATE_TOL, (impl, part, residual)


def test_mesh_step_masks_and_weights_are_the_stacked_steps(tmp_path):
    """On a one-rank group in this process: the mesh step's masks and
    weights are the stacked step's weights (> 0) bit for bit, and its
    parameters and metrics the stacked step's, from the same state and
    draws (K=1, 2 rounds)."""
    cfg = get_arch_config("mamba2-130m").reduced()
    shape = ShapeConfig("t", 16, 2, "train")
    over = {"n_d": 1, "n_g": 1}
    mesh_step, args = steps.build_train_step(cfg, shape, 1, fuse_rounds=2,
                                             layout="mesh",
                                             pcfg_overrides=over)
    stacked, _ = steps.build_train_step(cfg, shape, 1, fuse_rounds=2,
                                        pcfg_overrides=over)
    init = lambda: steps._bf16_floats(protocol.make_train_state(
        lambda g: gan.gan_init(g, cfg), stacked.pcfg, 1, device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (1, 2, 16),
                           generator=torch.Generator().manual_seed(0))
    weights = torch.full((1,), 2.0)
    want, wm = stacked(init(), {"tokens": tokens.int()}, weights, 0)
    with world_of_one(tmp_path) as _:
        carry = mesh_step.scheduler.init_carry("cpu")
        state = mesh_step.rank_state(init())
        state, carry, out = mesh_step(state, carry, tokens.int(), 0, 0)
        got = mesh_step.global_state(state)
    np.testing.assert_array_equal(out["mask"],
                                  np.ones((2, 1), dtype=bool))
    np.testing.assert_array_equal(out["weights"],
                                  weights.numpy()[None].repeat(2, 0))
    for k, v in wm.items():
        np.testing.assert_array_equal(out["metrics"][k], v.numpy())
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_async_checkpointer_writes_the_snapshot(tmp_path, monkeypatch):
    """`submit` writes the state as it was at the call, even when the
    live tensors change in place right after it (a captured replay's
    update); a failed write raises at `finish`."""
    live = {"w": torch.arange(6, dtype=torch.bfloat16),
            "n": np.int64(3)}
    ckpt = train.AsyncCheckpointer(str(tmp_path / "ok"))
    gate = threading.Event()
    real_save = train.save_checkpoint

    def slow_save(*a, **kw):
        assert gate.wait(30)
        return real_save(*a, **kw)

    monkeypatch.setattr(train, "save_checkpoint", slow_save)
    ckpt.submit(7, live, metadata={"layout": "stacked"})
    live["w"].add_(100)
    gate.set()
    ckpt.finish()
    monkeypatch.undo()
    tree, step, meta = load_checkpoint(str(tmp_path / "ok"))
    assert step == 7 and meta == {"layout": "stacked"}
    assert torch.equal(tree["w"], torch.arange(6, dtype=torch.bfloat16))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = train.AsyncCheckpointer(str(blocker))
    bad.submit(1, live)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        bad.finish()
    bad.finish()        # the error is raised once
