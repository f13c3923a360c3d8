"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C interface.  At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/`` at the repository root, and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  A source
may include the kernels' shared headers (:data:`INCLUDE_DIR`) by name.
Libraries are keyed by a hash of their source, the shared headers it
includes and the flags: an edited source or header builds anew, an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "INCLUDE_DIR", "load_library",
           "log_path", "stream_handle", "stream_buffer"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
# headers that more than one kernel includes (``#include "name.cuh"``)
INCLUDE_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)

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


def _library_path(source: pathlib.Path) -> pathlib.Path:
    text = source.read_bytes()
    h = hashlib.sha256(text)
    for name in _INCLUDE.findall(text):
        h.update((INCLUDE_DIR / name.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def log_path(source: pathlib.Path) -> pathlib.Path:
    """The ``nvcc`` log of ``source``'s library (written by its build)."""
    return _library_path(source).with_suffix(".log")


def load_library(source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and load it.

    The library and its ``nvcc`` log (``-Xptxas -v``: registers, shared
    memory and spills per kernel) land in :data:`BUILD_DIR` as
    ``lib<stem>-<hash>.so`` / ``.log``.  The build writes a per-process
    temporary name and renames it into place, so concurrent processes
    never load a half-written library.  Different sources build
    concurrently from different threads; one source builds once."""
    lib = _library_path(source)
    with _lock:
        if lib in _loaded:
            return _loaded[lib]
        building = _building.setdefault(lib, threading.Lock())
    with building:
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o",
                 str(tmp), str(source)],
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


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, which a launch takes:
    what ``torch.cuda.current_stream(device).cuda_stream`` gives, without a
    ``Stream`` object built for every launch (host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def stream_buffer(buffers: dict, device: torch.device, stream: int, n: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The buffer ``buffers`` keeps for (``device``, ``stream``), at least
    ``n`` elements: made zero, and made anew (zero again) when a call
    needs more than it holds.  Calls on one stream run in order, so they
    share it; none syncs with the host, and its address stays put until
    it grows."""
    key = (device.index, stream)
    buf = buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=dtype, device=device)
        buffers[key] = buf
    return buf
