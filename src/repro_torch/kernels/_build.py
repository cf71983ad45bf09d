"""Builds the port's CUDA sources into shared libraries, loaded with ctypes.

Each library is compiled by `nvcc` for Hopper (`sm_90a`) from the
sources under `repro_torch/csrc/` at first use, into `build/kernels/` at
the root of the checkout, and is cached there by a hash of its sources
and flags. Nothing is compiled when a module is imported. A missing
`nvcc` or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


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


@functools.cache
def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (once per source hash) and load lib<name> from csrc/<sources>."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
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
