"""The dry run of whole steps on the meta device (`repro_torch.launch.
dryrun`): the JAX package's mini dry run, the meta run against the same
step run for real on the CPU, and the ring's wire bytes against
`ring_wire_bytes_per_rank`, as the JAX package's HLO test pins them.

- Mini dry run: reduced qwen3-1.7b at vocab 512 (the JAX package's
  tests/test_multidevice.py mini dry run): train (one local and one
  server step), prefill and decode run on meta with FLOPs > 0; the
  stacked train step moves no
  collective bytes; a mesh train step at K=2, tp=2 (a fake process
  group, no process started) moves some.
- Meta against CPU: the reduced stacked train step at a length below
  the flash threshold, once on meta tensors and once for real on the
  CPU: the same FLOPs and bytes outside the kernels' wrappers (a
  wrapper counts its kernel's formula where the kernel runs or is
  dry-run, its plain version's own ops on the CPU), the same calls of
  each kernel, and a peak at least the arguments.
- Ring wire bytes: the mesh round of the DCGAN with ndf 64, K=8, at 16
  bits (the JAX package's tests/test_hlo_costs.py): the ring's
  `collective-permute` bytes a rank equal `ring_wire_bytes_per_rank`
  exactly, at most 0.55 of the flat path's all-gather bytes.
- Clean-up: every fake process group is destroyed after its run, since
  other test files share the worker process.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ProtocolConfig, ShapeConfig, get_arch_config
from repro_torch.configs.dcgan import DCGANConfig
from repro_torch.core import protocol, shard_round
from repro_torch.kernels.ring_wavg.ops import ring_wire_bytes_per_rank
from repro_torch.launch import dryrun, hlo_costs, steps
from repro_torch.models import dcgan, gan
from repro_torch.models.specs import make_dcgan_spec
from repro_torch.tree import tree_map
from torch_threads import one_torch_thread  # noqa: F401

QWEN = dataclasses.replace(get_arch_config("qwen3-1.7b").reduced(),
                           vocab=512)


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_mini_dryrun_train_prefill_decode():
    train = ShapeConfig("mini_train", 32, 8, "train")
    counter, n_chips, _ = dryrun.step_costs(
        QWEN, train, False, n_devices=2, pcfg_overrides=dict(n_d=1, n_g=1))
    costs = counter.totals()
    assert n_chips == 1 and costs["flops"] > 0
    assert costs["collective_bytes"] == 0 and costs["counts"] == {}
    assert costs["kernels"]["wavg"]["calls"] == 1
    for shape in (ShapeConfig("mini_decode", 64, 8, "decode"),
                  ShapeConfig("mini_prefill", 64, 8, "prefill")):
        counter, n_chips, _ = dryrun.step_costs(QWEN, shape, False)
        assert n_chips == 1 and counter.totals()["flops"] > 0
        assert counter.memory()["peak_bytes"] > 0


def test_mini_dryrun_mesh_tp2_counts_collectives():
    train = ShapeConfig("mini_train", 32, 8, "train")
    counter, n_chips, _ = dryrun.step_costs(
        QWEN, train, True, n_devices=2, tp=2,
        pcfg_overrides=dict(n_d=1, n_g=1))
    costs = counter.totals()
    assert n_chips == 4 and costs["flops"] > 0
    # the Algorithm-2 gather of this rank's shard, the TP feed-forward's
    # and the quantizer's all-reduces
    assert costs["bytes_by_kind"]["all-gather"] > 0
    assert costs["bytes_by_kind"]["all-reduce"] > 0


def _round_args(pcfg, k, n_local, seq, device):
    cfg = QWEN
    step, args = steps.build_train_step(
        cfg, ShapeConfig("t", seq, k * n_local, "train"), k, pcfg=pcfg)
    if device == "meta":
        return step, (*args[:3], 0)
    state = steps._bf16_floats(protocol.make_train_state(
        lambda g: gan.gan_init(g, cfg), pcfg, k, device="cpu"))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (k, n_local, seq),
                                     generator=gen, dtype=torch.int32)}
    return step, (state, batch, torch.full((k,), float(n_local)), 0)


def test_meta_run_equals_cpu_run():
    k, n_local, seq = 2, 2, 32        # 32 * 32 keys: below the flash path
    pcfg = ProtocolConfig(n_devices=k, n_d=1, n_g=1, sample_size=n_local,
                          server_sample_size=k)
    runs = {}
    for device in ("meta", "cpu"):
        step, args = _round_args(pcfg, k, n_local, seq, device)
        runs[device] = hlo_costs.count_costs(step, *args)[1]
    meta, cpu = (runs[d].totals() for d in ("meta", "cpu"))

    def outside(costs, key):
        return costs[key] - sum(e[key] for e in costs["kernels"].values())

    assert meta["flops"] > 0
    for key in ("flops", "hbm_bytes"):
        assert outside(meta, key) == outside(cpu, key)
    assert ({n: e["calls"] for n, e in meta["kernels"].items()}
            == {n: e["calls"] for n, e in cpu["kernels"].items()}
            == {"wavg": 1})
    for counter in runs.values():
        mem = counter.memory()
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0


def _dcgan_round_costs(avg_impl, k):
    """One mesh round of rank 0 of k for the DCGAN at 16 bits, on meta
    tensors in a fake process group."""
    cfg = DCGANConfig(nz=16, ngf=16, ndf=64, nc=1, image_size=32)
    spec = make_dcgan_spec(cfg)
    pcfg = ProtocolConfig(n_devices=k, n_d=1, n_g=1, sample_size=2,
                          server_sample_size=2, lr_d=1e-3, lr_g=1e-3,
                          quantize_bits=16)
    state = steps.abstract(lambda: protocol.make_train_state(
        lambda g: dcgan.gan_init(g, cfg), pcfg, 1, device="cpu"))
    state["disc_opt"] = tree_map(lambda x: x[0], state["disc_opt"])
    data = torch.empty((4, 32, 32, 1), device="meta")
    sampler = protocol.DrawSampler(
        spec, pcfg, seed=0, n_local=4,
        n_params=protocol.count_params(state["disc"]), device="meta")
    with dryrun.fake_group(k):
        _, counter = hlo_costs.count_costs(
            shard_round.mesh_round, spec, pcfg, state, data,
            torch.ones((), device="meta"), sampler(0), avg_impl=avg_impl)
    return counter.totals(), state


def test_ring_wire_bytes_equal_formula_and_beat_flat():
    k = 8
    flat, state = _dcgan_round_costs("pallas", k)
    ring, _ = _dcgan_round_costs("ring", k)
    ring_cp = ring["bytes_by_kind"]["collective-permute"]
    assert ring_cp == ring_wire_bytes_per_rank(state["disc"], 16, k)
    assert ring_cp / flat["bytes_by_kind"]["all-gather"] <= 0.55
    # the ring's only gather is the (K,) weights'; its hops accumulate in
    # the kernel: one launch for the rank's own payload, then a chunk
    # each of 4 per hop
    assert ring["bytes_by_kind"]["all-gather"] == 4 * k
    assert ring["kernels"]["ring_accum"]["calls"] == 1 + (k - 1) * 4
    assert flat["kernels"]["wavg"]["calls"] == 1
