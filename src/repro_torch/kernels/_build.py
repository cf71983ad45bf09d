"""Builds the port's CUDA sources into shared libraries, loaded with ctypes.

Each library is compiled by `nvcc` for Hopper (`sm_90a`) from the
sources under `repro_torch/csrc/` at first use, into `build/kernels/` at
the root of the checkout, and is cached there by a hash of its sources,
the headers they include and the flags. Nothing is compiled when a
module is imported. A missing `nvcc` or a failed build raises; there is
no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
# #include "name": a header found beside the including file
LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                       "PATH or set CUDA_HOME")


def build_inputs(paths) -> list[Path]:
    """The sources and every header they include with `#include "..."`,
    directly or through another header, in a fixed order."""
    seen, todo = [], list(paths)
    while todo:
        path = Path(todo.pop(0)).resolve()
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / h
                 for h in LOCAL_INCLUDE.findall(path.read_text())]
    return seen


def build_digest(paths) -> str:
    """The cache key of a library: a hash of `build_inputs(paths)` and
    the flags, so that an edited header rebuilds every library that
    includes it."""
    digest = hashlib.sha256()
    for p in build_inputs(paths):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


@functools.cache
def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (once per hash of the sources and their headers) and load
    lib<name> from csrc/<sources> (or from absolute paths)."""
    paths = [CSRC / s for s in sources]
    lib_path = BUILD_DIR / f"lib{name}-{build_digest(paths)}.so"
    if not lib_path.exists():
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: concurrent builds agree
    return ctypes.CDLL(str(lib_path))
