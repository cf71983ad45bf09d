"""The port stands alone: `repro_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, and nothing runs on the CPU unless
asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_without_nvcc_raises():
    """Every kernel's build: wavg, trimmed_wavg, ssd_scan, flash_attn,
    ring_accum."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.kernels.robust_avg import ops as robust_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wavg import ops
    try:
        _build.nvcc_path()
    except RuntimeError:
        for kernel_ops in (ops, robust_ops, ssd_ops, flash_ops, ring_ops):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                kernel_ops.build()
    else:
        pytest.skip("nvcc is installed")


def test_an_edited_header_changes_the_library_hash(tmp_path):
    """The build cache key covers the headers a source includes, directly
    or through another header, so an edited header rebuilds every library
    that includes it; the kernels' own sources include the shared
    3xTF32 header."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// 1\n")
    sources = [tmp_path / "k.cu"]
    assert [p.name for p in _build.build_inputs(sources)] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = _build.build_digest(sources)
    assert _build.build_digest(sources) == before
    (tmp_path / "b.cuh").write_text("// 2\n")
    assert _build.build_digest(sources) != before
    for name in ("ssd_scan.cu", "flash_attn.cu"):
        assert [p.name for p in _build.build_inputs([_build.CSRC / name])
                ] == [name, "tf32x3.cuh"]
