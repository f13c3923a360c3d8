"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C interface.  At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/`` at the repository root, and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries
are keyed by a hash of their source and flags: an edited source builds
anew, an unchanged one is reused.  A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "load_library"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"

_lock = threading.Lock()
_loaded: dict[pathlib.Path, ctypes.CDLL] = {}   # guarded-by: _lock
_building: dict[pathlib.Path, threading.Lock] = {}   # guarded-by: _lock


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built from source")
    return path


def load_library(source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and load it.

    The library and its ``nvcc`` log (``-Xptxas -v``: registers, shared
    memory and spills per kernel) land in :data:`BUILD_DIR` as
    ``lib<stem>-<hash>.so`` / ``.log``.  The build writes a per-process
    temporary name and renames it into place, so concurrent processes
    never load a half-written library.  Different sources build
    concurrently from different threads; one source builds once."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    with _lock:
        if lib in _loaded:
            return _loaded[lib]
        building = _building.setdefault(lib, threading.Lock())
    with building:
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        with _lock:
            if lib not in _loaded:
                _loaded[lib] = ctypes.CDLL(str(lib))
            return _loaded[lib]
