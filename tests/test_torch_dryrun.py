"""Port parity: the dry-run tooling (`repro_torch.launch.hlo_costs`,
`analysis`, `variants`, `dryrun` and the report twins in
`repro_torch.experiments`) against the JAX package's, and the five
kernel wrappers' meta-device branches.

- The op-by-op counter against `repro.launch.hlo_costs` on the programs
  of tests/test_hlo_costs.py (a straight product, a 7-trip loop, nested
  5 x 3 loops, a 4-trip tuple carry): the same FLOPs exactly; a * 2 + 1
  within the same traffic bounds; a DCGAN convolution's FLOPs equal.
- Each wrapper's meta branch: the kernel's output shapes and dtypes and
  its formula's FLOPs and bytes, checked at the shapes of PERF.md
  section 6, where the table's bounds were computed from the same
  formulas; a device other than cpu, cuda or meta raises.
- `variants.apply` against JAX's for every ported variant and a `+`
  combination; the three GSPMD variants raise.
- The reports' `active_params` and model FLOPs against JAX's
  `benchmarks/roofline_report.py` for every architecture and input
  shape, and their table rows against JAX's on the same dry-run JSON.
- The CLI on one cheap full-size combination writes its JSON.
"""
import dataclasses
import json
import os
import shutil
import sys

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import experiments_report as jexperiments_report  # noqa: E402
from benchmarks import roofline_report as jroofline_report  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs import get_arch_config as jget_arch_config  # noqa: E402
from repro.launch import hlo_costs as jhlo_costs  # noqa: E402
from repro.launch import variants as jvariants  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_arch_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.experiments import experiments_report  # noqa: E402
from repro_torch.experiments import roofline_report  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ring_wavg import ops as ring_ops  # noqa: E402
from repro_torch.kernels.robust_avg import ops as robust_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.wavg import ops as wavg_ops  # noqa: E402
from repro_torch.launch import analysis, dryrun, hlo_costs  # noqa: E402
from repro_torch.launch import variants  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def jax_costs(fn, *args):
    return jhlo_costs.hlo_costs(jax.jit(fn).lower(*args).compile().as_text())


def torch_costs(fn, *args):
    return hlo_costs.count_costs(fn, *args)[1].totals()


# ---------------------------------------------------------------------------
# The counter against the JAX package's HLO parser
# ---------------------------------------------------------------------------

def _loop7(x, w):
    for _ in range(7):
        x = x @ w
    return x.sum()


def _jloop7(x, w):
    def body(c, _):
        return c @ w, None
    y, _ = jax.lax.scan(body, x, None, length=7)
    return y.sum()


def _nested(x, w):
    for _ in range(5):
        for _ in range(3):
            x = x @ w
    return x.sum()


def _jnested(x, w):
    def outer(c, _):
        def inner(ci, _):
            return ci @ w, None
        ci, _ = jax.lax.scan(inner, c, None, length=3)
        return ci, None
    y, _ = jax.lax.scan(outer, x, None, length=5)
    return y.sum()


def _carry(x):
    a, b = x, x
    for _ in range(4):
        a, b = b, a @ a
    return (a + b).sum()


def _jcarry(x):
    def body(carry, _):
        a, b = carry
        return (b, a @ a), None
    (a, b), _ = jax.lax.scan(body, (x, x), None, length=4)
    return (a + b).sum()


@pytest.mark.parametrize("fn, jfn, shapes, expected", [
    (lambda a, b: a @ b, lambda a, b: a @ b, [(8, 32), (32, 4)],
     2 * 8 * 32 * 4),
    (_loop7, _jloop7, [(32, 64), (64, 64)], 7 * 2 * 32 * 64 * 64),
    (_nested, _jnested, [(16, 16), (16, 16)], 5 * 3 * 2 * 16 * 16 * 16),
    (_carry, _jcarry, [(8, 8)], 4 * 2 * 8 * 8 * 8),
], ids=["straight", "loop7", "nested5x3", "tuple_carry4"])
def test_counter_flops_equal_jax_hlo_costs(fn, jfn, shapes, expected):
    got = torch_costs(fn, *(torch.zeros(s) for s in shapes))
    want = jax_costs(jfn, *(jnp.zeros(s) for s in shapes))
    assert got["flops"] == want["flops"] == expected
    assert got["collective_bytes"] == want["collective_bytes"] == 0


def test_counter_hbm_counts_inputs_and_outputs():
    costs = torch_costs(lambda a: a * 2.0 + 1.0, torch.zeros(1024))
    # the JAX test's bounds: at least read + write of the 4 KB buffer
    assert 8e3 <= costs["hbm_bytes"] <= 1e5
    assert 8e3 <= jax_costs(lambda a: a * 2.0 + 1.0,
                            jnp.zeros((1024,)))["hbm_bytes"] <= 1e5


def test_counter_views_gathers_and_updates():
    """Views count nothing, a gather twice its result, a write into a
    larger buffer twice the region written."""
    x = torch.zeros(64, 32)
    assert torch_costs(lambda t: t[2:6].reshape(-1).t(), x)["hbm_bytes"] == 0
    idx = torch.tensor([1, 5, 7])
    assert torch_costs(lambda t, i: t[i], x, idx)["hbm_bytes"] == \
        2 * 3 * 32 * 4
    row = torch.ones(32)
    assert torch_costs(lambda t, r: t[3].copy_(r), x, row)["hbm_bytes"] == \
        2 * 32 * 4
    src = torch.ones(3, 32)
    assert torch_costs(lambda t, i, s: t.index_copy_(0, i, s), x, idx,
                       src)["hbm_bytes"] == 2 * (3 * 8 + 3 * 32 * 4)


def test_counter_conv_flops_equal_jax():
    """The DCGAN discriminator's first convolution (nc 1 -> 64, 4 x 4,
    stride 2) on a batch of 2 32 x 32 images: JAX's `_conv_flops`."""
    gen = torch.Generator().manual_seed(0)
    params = tnn.conv2d_init(gen, 1, 64, 4)
    x = torch.zeros(2, 32, 32, 1)
    got = torch_costs(lambda p, t: tnn.conv2d_apply(p, t), params, x)
    jparams = jnn.conv2d_init(jax.random.PRNGKey(0), 1, 64, 4)
    want = jax_costs(lambda p, t: jnn.conv2d_apply(p, t), jparams,
                     jnp.zeros((2, 32, 32, 1)))
    assert got["flops"] == want["flops"] == 2 * 2 * 16 * 16 * 64 * 16


def test_counter_memory_tracks_storages():
    """Views share their storage; a freed temporary leaves; each storage
    is rounded to 512 bytes; the arguments count."""
    a = torch.zeros(1000, device="meta")           # 4,000 -> 4,096 B

    def fn(t):
        tmp = t * 2.0                              # 4,096 B, freed
        v = tmp[:10]
        out = v + 1.0                              # 40 -> 512 B
        return out

    out, counter = hlo_costs.count_costs(fn, a)
    mem = counter.memory()
    assert mem["argument_bytes"] == 4096
    assert mem["output_bytes"] == 512
    assert mem["peak_bytes"] == 4096 + 4096 + 512
    assert mem["temp_bytes"] == mem["peak_bytes"] - 4096


def test_counter_records_collectives_and_refuses_nesting():
    with hlo_costs.CostCounter() as c:
        hlo_costs.record_collective("all-gather", 64)
        hlo_costs.record_collective("all-reduce", 16)
        with pytest.raises(ValueError):
            hlo_costs.record_collective("broadcast", 1)
        with pytest.raises(RuntimeError):
            with hlo_costs.CostCounter():
                pass
    assert c.totals()["bytes_by_kind"] == {"all-gather": 64.0,
                                           "all-reduce": 16.0}
    assert c.totals()["counts"] == {"all-gather": 1, "all-reduce": 1}
    assert hlo_costs._ACTIVE is None


def test_roofline_uses_the_h100_constants():
    roof = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12,
                             collective_bytes=450e9 * 4, n_chips=2)
    assert roof.compute_s == pytest.approx(0.5)
    assert roof.memory_s == pytest.approx(0.5)
    assert roof.collective_s == pytest.approx(2.0)
    assert roof.dominant == "collective"
    costs = {"flops": 10.0, "hbm_bytes": 20.0, "collective_bytes": 4.0,
             "bytes_by_kind": {"all-gather": 4.0},
             "counts": {"all-gather": 1}}
    out = analysis.analyze(costs, {"peak_bytes": 7}, 32)
    assert out["roofline"]["flops"] == 320.0
    assert out["collectives"]["total_bytes"] == 128.0
    assert out["memory"] == {"peak_bytes": 7}
    assert analysis.model_flops_per_round(10, 3) == 180.0


# ---------------------------------------------------------------------------
# The kernels' meta branches, at PERF.md section 6's shapes
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_entry(fn, name):
    out, counter = hlo_costs.count_costs(fn)
    return out, counter.totals()["kernels"][name]


def test_wavg_and_trimmed_meta_branches():
    k, n = 10, 2_765_568
    for name, fn in (("wavg", lambda: wavg_ops.weighted_average(
            _meta(k, n), _meta(k))), ("trimmed_wavg",
            lambda: robust_ops.trimmed_average(_meta(k, n), _meta(k),
                                               trim=2))):
        out, entry = _kernel_entry(fn, name)
        assert (out.shape, out.dtype, out.device.type) == (
            (n,), torch.float32, "meta")
        assert entry == {"calls": 1, "flops": 2.0 * k * n,
                         "hbm_bytes": float((k * n + k + n) * 4)}
    # the bound of PERF.md section 6, rows 1 and 3: 0.0363 ms at HBM's rate
    assert wavg_ops.cost(k, n)[1] / analysis.HBM_BW * 1e3 == pytest.approx(
        0.0363, abs=5e-5)
    assert robust_ops.cost(k, n) == wavg_ops.cost(k, n)


def test_ring_accum_meta_branch():
    rows = 1356
    acc, q, coef = (_meta(rows, ring_ops.BLOCK_N),
                    _meta(rows, ring_ops.BLOCK_N, dtype=torch.int16),
                    _meta(rows))
    before = ring_ops.launches
    out, entry = _kernel_entry(lambda: ring_ops.ring_accum_(acc, q, coef),
                               "ring_accum")
    assert out is acc and ring_ops.launches == before
    # PERF.md section 6, row 2: rows * 2048 * 10 + rows * 4 bytes
    assert entry == {"calls": 1, "flops": 2.0 * rows * 2048,
                     "hbm_bytes": float(rows * 2048 * 10 + rows * 4)}
    assert entry["hbm_bytes"] / analysis.HBM_BW * 1e3 == pytest.approx(
        0.0083, abs=5e-5)


@pytest.mark.parametrize("shape, kw, flops", [
    # minitron-4b; gemma3-12b's local layers; whisper-base's encoder;
    # llama-3.2-vision-90b's cross-attention (PERF.md section 6, row 4)
    ((4, 1024, 1024, 24, 8, 128), {}, 25_794_969_600),
    ((2, 2048, 2048, 16, 8, 256), dict(window=1024), 51_556_384_768),
    ((4, 1500, 1500, 8, 8, 64), dict(causal=False), 18_432_000_000),
    ((1, 2048, 1600, 64, 8, 128), dict(causal=False), 107_374_182_400),
], ids=["minitron", "gemma3_local", "whisper_encoder", "vision_cross"])
def test_flash_meta_branch(shape, kw, flops):
    b, s, t, h, kv, d = shape
    q, k, v = _meta(b, s, h, d), _meta(b, t, kv, d), _meta(b, t, kv, d)
    out, entry = _kernel_entry(
        lambda: flash_ops.flash_attention(q, k, v, **kw), "flash_attn")
    assert (tuple(out.shape), out.dtype, out.device.type) == (
        (b, s, h, d), torch.float32, "meta")
    assert entry["calls"] == 1 and entry["flops"] == flops
    assert entry["hbm_bytes"] == flash_ops.cost(b, s, t, h, kv, d, **kw)[1]


def test_flash_cost_formula():
    """The pairs against the closed forms of PERF.md section 6, and the
    bytes of the bf16 main shape's bound (59,244,544 B)."""
    assert flash_ops.key_pairs(1024, 1024) == 1024 * 1025 // 2
    assert flash_ops.key_pairs(2048, 2048, window=1024) == (
        1024 * 1025 // 2 + 1024 * 1024)
    assert flash_ops.key_pairs(448, 1500, causal=False) == 448 * 1500
    # against a count of every (query, key) pair, at every call the
    # wrapper takes: t + window > s, so that every query sees a key
    for s in range(1, 12):
        for t in range(1, 12):
            for causal in (True, False):
                for window in [None] + [w for w in range(1, 14)
                                        if t + w > s]:
                    assert flash_ops.key_pairs(s, t, causal, window) == sum(
                        1 for i in range(s) for j in range(t)
                        if (j <= i or not causal)
                        and (window is None or j > i - window)), (
                        s, t, causal, window)
    assert flash_ops.cost(4, 1024, 1024, 32, 8, 64, itemsize=2)[1] == \
        59_244_544


def test_flash_meta_output_backward_runs():
    """The meta output takes the plain backward, as on the card."""
    q = torch.empty(1, 600, 4, 32, device="meta", requires_grad=True)
    k = torch.empty(1, 600, 2, 32, device="meta", requires_grad=True)
    v = torch.empty(1, 600, 2, 32, device="meta", requires_grad=True)
    out = flash_ops.flash_attention(q, k, v)
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.parametrize("final", [False, True])
def test_ssd_meta_branch(final):
    b, s, h, p, g, n = 8, 512, 24, 64, 1, 128
    args = (_meta(b, s, h, p), _meta(b, s, h), _meta(h), _meta(b, s, g, n),
            _meta(b, s, g, n))
    out, entry = _kernel_entry(lambda: ssd_ops.ssd_scan(
        *args, chunk=128, return_final_state=final), "ssd_scan")
    y, state = out if final else (out, None)
    assert (tuple(y.shape), y.dtype, y.device.type) == (
        (b, s, h, p), torch.float32, "meta")
    if final:
        assert (tuple(state.shape), state.dtype) == ((b, h, n, p),
                                                     torch.float32)
    want = ssd_ops.cost(b, s, h, p, g, n, 128, final_state=final)
    assert entry == {"calls": 1, "flops": float(want[0]),
                     "hbm_bytes": float(want[1])}
    if not final:
        # PERF.md section 6, row 5: the timed call's least work
        assert want[0] == 3_295_150_080


def test_ssd_cost_formula_bytes():
    """The bytes of PERF.md section 6's row 5 bounds: zamba2-2.7b's scan
    in float32 and the main shape with bf16 x, B and C."""
    assert ssd_ops.cost(4, 1024, 80, 64, 1, 64, 128)[1] == 171_180_352
    assert ssd_ops.cost(8, 512, 24, 64, 1, 128, 128, x_itemsize=2,
                        bc_itemsize=2)[1] == 27_656_288


class _Elsewhere(torch.Tensor):
    """A tensor on a device this machine lacks (no storage)."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a stand-in tensor")


def test_wrappers_refuse_other_devices():
    x, w = _Elsewhere((4, 8)), _Elsewhere((4,))
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        wavg_ops.weighted_average(x, w)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        robust_ops.trimmed_average(x, w, trim=1)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        ring_ops.RowAccumulator(_Elsewhere((2, ring_ops.BLOCK_N)),
                                _Elsewhere((2, ring_ops.BLOCK_N)),
                                _Elsewhere((2,)))
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        flash_ops.flash_attention(_Elsewhere((1, 8, 2, 32)),
                                  _Elsewhere((1, 8, 2, 32)),
                                  _Elsewhere((1, 8, 2, 32)))
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        ssd_ops.ssd_scan(_Elsewhere((1, 8, 2, 32)), _Elsewhere((1, 8, 2)),
                         _Elsewhere((2,)), _Elsewhere((1, 8, 1, 16)),
                         _Elsewhere((1, 8, 1, 16)))


# ---------------------------------------------------------------------------
# Variants
# ---------------------------------------------------------------------------

def _changes(cfg, base):
    """The fields `cfg` changed from `base`, nested configs as dicts."""
    a, b = dataclasses.asdict(cfg), dataclasses.asdict(base)
    return {k: v for k, v in a.items() if b[k] != v}


@pytest.mark.parametrize("arch, variant", [
    ("granite-3-2b", "flashrep"), ("granite-3-2b", "fused"),
    ("granite-3-2b", "hoist"), ("granite-3-2b", "parallel"),
    ("granite-3-2b", "micro2"), ("granite-3-2b", "nd3"),
    ("granite-3-2b", "disc4"), ("granite-moe-3b-a800m", "moe_sort"),
    ("granite-moe-3b-a800m", "group512"), ("granite-moe-3b-a800m", "cap150"),
    ("granite-moe-3b-a800m", "flashrep+fused+hoist+parallel+micro2+nd3"
                             "+moe_sort+group512+cap150+disc4"),
])
def test_variants_equal_jax(arch, variant):
    cfg, jcfg = get_arch_config(arch), jget_arch_config(arch)
    got_cfg, got_kw = variants.apply(cfg, variant)
    want_cfg, want_kw = jvariants.apply(jcfg, variant)
    assert _changes(got_cfg, cfg) == _changes(want_cfg, jcfg)
    assert got_kw == want_kw


def test_variants_gspmd_and_unknown_raise():
    cfg = get_arch_config("granite-3-2b")
    for name in ("discrep", "moepin", "headpin", "flashrep+headpin"):
        with pytest.raises(ValueError, match="10c"):
            variants.apply(cfg, name)
    with pytest.raises(ValueError, match="unknown variant"):
        variants.apply(cfg, "warp9")
    assert variants.apply(cfg, "") == (cfg, {})


# ---------------------------------------------------------------------------
# The reports and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_active_params_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_arch_config(arch), jget_arch_config(arch)
    n = roofline_report.active_params(cfg)
    assert n == jroofline_report.active_params(jcfg)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_INPUT_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == (
            jshape.seq_len, jshape.global_batch, jshape.kind)
        scale = 6.0 if shape.kind == "train" else 2.0
        assert roofline_report.model_flops(cfg, shape) == (
            scale * n * jroofline_report.tokens_processed(jcfg, jshape))


@pytest.fixture(scope="module")
def cli_out(tmp_path_factory):
    """The CLI's JSON of one cheap full-size combination."""
    out = tmp_path_factory.mktemp("dryrun")
    torch.set_num_threads(1)
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--out", str(out)])
    return out


def test_cli_writes_its_json(cli_out):
    path = cli_out / "mamba2-130m__decode_32k__single.json"
    with open(path) as f:
        d = json.load(f)
    assert {"roofline", "collectives", "memory", "kernels", "arch", "shape",
            "mesh", "n_chips", "schedule", "lower_s",
            "run_s"} <= set(d)
    assert (d["arch"], d["shape"], d["mesh"], d["n_chips"]) == (
        "mamba2-130m", "decode_32k", "single", 1)
    assert d["roofline"]["flops"] > 0 and d["roofline"]["hbm_bytes"] > 0
    assert d["memory"]["peak_bytes"] >= d["memory"]["argument_bytes"] > 0
    assert d["collectives"]["total_bytes"] == 0


def test_reports_rows_equal_jax(cli_out, tmp_path, monkeypatch):
    """The same dry-run JSON under each package's results directory: the
    roofline rows and both report tables row for row."""
    monkeypatch.chdir(tmp_path)
    for d in ("results/dryrun", "results/torch/dryrun"):
        os.makedirs(d)
        for p in cli_out.iterdir():
            shutil.copy(p, d)
    rows = roofline_report.load_rows()
    assert rows and rows == jroofline_report.load_rows()
    assert roofline_report.table_lines(rows)[1:] == [
        line for line in _printed(jroofline_report.main)[1:]]

    def table(text):
        return [line for line in text.splitlines() if line.startswith("| ")]

    for port_fn, jax_fn in (
            (experiments_report.fmt_dryrun_section,
             jexperiments_report.fmt_dryrun_section),
            (experiments_report.fmt_roofline_section,
             jexperiments_report.fmt_roofline_section)):
        got, want = table(port_fn()), table(jax_fn())
        assert len(got) == 2 and got == want     # the header and a row


def _printed(fn):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()
