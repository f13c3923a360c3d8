"""Wrapper and launch counter for the CoDR compressed matmul kernel.

Source note.  The kernel, ``csrc/codr_matmul.cu``, replaces the Pallas
TPU kernel ``src/repro/kernels/codr_matmul/kernel.py:70``
(``codr_matmul_pallas`` / ``_codr_matmul_kernel`` / ``_decode_block``):
``y = (x @ table[idx]) · scale`` with the weight decoder fused into an
output-stationary matmul, f32 accumulation, output in ``x``'s dtype.  On
the H100 it is bound by bytes at decode: the packed weights,
``K·N·bits/8`` bytes, over 3.35 TB/s (M = 4 rows of activations are
nothing beside them); at prefill (M = 128) the bound is still the bytes
of the weights, far below the tensor cores' rate.  What the design does:
every packed word is read from device memory once per block row of
outputs and decoded in shared memory, never expanded to a dense weight
in device memory; the next chunk's words are loaded while the current
one is multiplied.  Its limits — a block per 64 output columns, so
narrow projections launch few blocks, and float32 products on the CUDA
cores — are in the source and in PERF.md.

Dispatch: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.codr_matmul.ref.codr_matmul_ref`); a CUDA
tensor launches the kernel or raises.  :data:`launches` counts kernel
launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.codr_linear import PackedWeight
from repro_torch.kernels import _build
from repro_torch.kernels.codr_matmul.ref import codr_matmul_ref

__all__ = ["KERNEL_CAPS", "launches", "load_kernel", "codr_matmul_cuda",
           "codr_matmul"]

# Capability facts consumed by the backend registry
# (repro_torch.core.backends.CodrMatmulBackend) — this kernel only has a
# matmul (linear-layer) datapath; conv layers never route here.
KERNEL_CAPS = {
    "kinds": ("linear",),
    "integer_activations": False,  # float activations, f32 accumulation
    "packed_matmul": True,         # executes PackedLinear params leaves
    "description": "hand-written CUDA fused decode+matmul for sm_90a "
                   "(unique-index pack, output-stationary tiles, f32 "
                   "accumulation; plain PyTorch version on CPU tensors)",
}

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "codr_matmul.cu"
BITS = (1, 2, 4, 8, 16)
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # kernel launches since the count was last set to 0


@functools.cache
def load_kernel():
    """Build (at first use) and load the kernel; returns the library."""
    lib = _build.load_library(SOURCE)
    lib.codr_matmul_launch.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    lib.codr_matmul_launch.restype = ctypes.c_int
    lib.codr_matmul_error_string.argtypes = [ctypes.c_int]
    lib.codr_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtypes, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def codr_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                     table: torch.Tensor, scale: torch.Tensor, *, bits: int,
                     n: int) -> torch.Tensor:
    """Launch the CUDA kernel: ``x`` (M, K) float32 or bfloat16 on a CUDA
    device, ``packed`` (K, n·bits/32) int32, ``table`` (2^bits,) float32
    or bfloat16, ``scale`` one float32 → (M, n) in ``x``'s dtype.  Raises
    on anything the kernel does not take, and when the launch is
    refused."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"codr_matmul_cuda needs CUDA tensors, got x on "
                         f"{x.device}")
    if bits not in BITS:
        raise ValueError(f"bits must be one of {BITS}, got {bits}")
    _check("x", x, _DTYPES, 2, x.device)
    _check("packed", packed, (torch.int32,), 2, x.device)
    _check("table", table, _DTYPES, 1, x.device)
    _check("scale", scale.reshape(-1), (torch.float32,), 1, x.device)
    m, k = x.shape
    per_word = 32 // bits
    if n < 1 or n % per_word or packed.shape != (k, n // per_word):
        raise ValueError(f"packed {tuple(packed.shape)} does not hold "
                         f"(K={k}, n={n}) at {bits} bits")
    if table.shape[0] != 1 << bits or scale.numel() != 1:
        raise ValueError(f"table must have 2^{bits} entries and scale one, "
                         f"got {tuple(table.shape)} and {scale.numel()}")
    if m > 65535 * 32:
        raise ValueError(f"M={m} exceeds the grid ({65535 * 32} rows)")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = load_kernel()
    err = lib.codr_matmul_launch(
        x.data_ptr(), packed.data_ptr(), table.data_ptr(), scale.data_ptr(),
        out.data_ptr(), m, k, n, bits, int(x.dtype == torch.bfloat16),
        int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"codr_matmul launch failed: CUDA error {err} "
                           f"({lib.codr_matmul_error_string(err).decode()})")
    launches += 1
    return out


def codr_matmul(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """``y = x @ decode(w)`` with the decode fused into the matmul tiles;
    ``w`` is one (unstacked) :class:`PackedWeight`.  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    args = (x, w.packed, w.table, w.scale.reshape(-1))
    if x.device.type == "cpu":
        return codr_matmul_ref(*args, bits=w.bits, n=w.shape[1])
    return codr_matmul_cuda(*args, bits=w.bits, n=w.shape[1])
