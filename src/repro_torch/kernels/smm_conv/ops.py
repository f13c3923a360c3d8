"""Wrapper, operand packer and launch counter for the SMM convolution
kernel.

Source note.  The kernel, ``csrc/smm_conv.cu``, replaces the Pallas TPU
kernel ``src/repro/kernels/smm_conv/kernel.py`` (``_smm_conv_kernel`` /
``smm_conv_pallas``): the paper's MPE/APE datapath — differential
scalar×matrix products over each weight vector's sorted unique values,
routed by a crossbar into output-stationary accumulators.  Against the
H100's peaks the function is bound by bytes: at the VGG16 main-path
shapes its float32 input and output planes (0.05–0.4 GB per launch at
batch 4) take longer at 3.35 TB/s than its 2·nnz int8 operations per
output pixel at 1,979 TOP/s.  This first kernel runs those operations
on the CUDA cores, one int32 multiply-add and one shared-memory load
each, and that instruction stream is what bounds it in practice (see
PERF.md); the tensor cores are later work.  What the design does for
the bytes: every input element is read from device memory once per
output-channel tile and staged in shared memory, every output written
once.  Its design answers the TPU kernel's assumptions that do not hold
here:
a block owns (batch, output-channel tile, 32-column output tile) and
loops over input channels itself with its accumulators in shared memory
(the TPU carried them across a sequential grid axis); it stages only the
input window its tile reads, halo included (the TPU's per-step product
scratch is megabytes); and it accumulates in int32, exact where the TPU
kernel's float32 sums stop being exact past 2^24.

Dispatch: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.smm_conv.ref.smm_conv_plain`); a CUDA
tensor launches the kernel or raises.  :data:`launches` counts kernel
launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
import torch

from repro_torch.core.smm import decode_index
from repro_torch.core.ucr import LayerCode
from repro_torch.kernels import _build
from repro_torch.kernels.smm_conv.ref import smm_conv_plain

__all__ = ["KERNEL_CAPS", "launches", "pack_smm_operands", "smm_operands_on",
           "load_kernel", "smm_conv_cuda", "smm_conv_packed",
           "smm_conv_batched", "smm_conv"]

# Capability facts consumed by the backend registry
# (repro_torch.core.backends.SmmKernelBackend) — kept next to the kernel
# so the registry never hardcodes what a kernel can execute.
KERNEL_CAPS = {
    "kinds": ("conv",),            # this kernel only executes convolutions
    "max_stride": None,            # strided crossbar routing, any stride
    "integer_activations": True,   # 8-bit feature datapath (exact int math)
    "description": "hand-written CUDA MPE/APE SMM convolution for sm_90a "
                   "(int32 accumulators; plain PyTorch version on CPU "
                   "tensors)",
}

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "smm_conv.cu"

launches = 0          # kernel launches since the count was last set to 0


def pack_smm_operands(code: LayerCode, n_in: int
                      ) -> tuple[np.ndarray, np.ndarray, dict]:
    """UCR vectors → padded static-shape kernel operands (equal to
    ``repro.kernels.smm_conv.ops.pack_smm_operands``, vectorized).

    Returns ``(deltas, entries, meta)``:
      deltas  (m_tiles, N, U_max+1) float32 — Δs of sorted unique weights
      entries (m_tiles, N, L_max, 4) int32 — (u, m_local, r, c) per
              repetition; padding → (U_max, 0, 0, 0) = zero product row.
    """
    m = code.shape[0]
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    m_tiles = -(-m // code.t_m)
    n_u = np.array([len(u.unique_vals) for u in code.ucr], dtype=np.int64)
    n_l = np.array([len(u.indexes) for u in code.ucr], dtype=np.int64)
    u_max = int(n_u.max(initial=0)) or 1
    l_max = int(n_l.max(initial=0)) or 1

    deltas = np.zeros((m_tiles, n_in, u_max + 1), dtype=np.float32)
    entries = np.zeros((m_tiles, n_in, l_max, 4), dtype=np.int32)
    entries[:, :, :, 0] = u_max                     # point at the zero row
    if not len(code.ucr) or not n_u.sum():
        return deltas, entries, {"m_tiles": m_tiles, "t_m": code.t_m,
                                 "u_max": u_max, "l_max": l_max}

    vi = np.arange(len(code.ucr))
    vals = np.concatenate([u.unique_vals for u in code.ucr]).astype(np.int64)
    reps = np.concatenate([u.reps for u in code.ucr]).astype(np.int64)
    idx = np.concatenate([u.indexes for u in code.ucr]).astype(np.int64)
    u_first = np.cumsum(n_u) - n_u
    u_pos = np.arange(len(vals)) - np.repeat(u_first, n_u)   # u within vector
    prev = np.where(u_pos > 0, np.roll(vals, 1), 0)
    u_vec = np.repeat(vi, n_u)
    deltas[u_vec // n_in, u_vec % n_in, u_pos] = vals - prev

    l_vec = np.repeat(vi, n_l)
    l_pos = np.arange(len(idx)) - np.repeat(np.cumsum(n_l) - n_l, n_l)
    m_loc, r, c = decode_index(idx, (rk, ck))
    entries[l_vec // n_in, l_vec % n_in, l_pos] = np.stack(
        [np.repeat(u_pos, reps), m_loc, r, c], axis=1)
    return deltas, entries, {"m_tiles": m_tiles, "t_m": code.t_m,
                             "u_max": u_max, "l_max": l_max}


def smm_operands_on(code: LayerCode, n_in: int, device) -> tuple:
    """:func:`pack_smm_operands` with the arrays moved to ``device``."""
    deltas, entries, meta = pack_smm_operands(code, n_in)
    return (torch.from_numpy(deltas).to(device),
            torch.from_numpy(entries).to(device), meta)


@functools.cache
def load_kernel():
    """Build (at first use) and load the kernel; returns the library."""
    lib = _build.load_library(SOURCE)
    lib.smm_conv_launch.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 11
                                    + [ctypes.c_void_p])
    lib.smm_conv_launch.restype = ctypes.c_int
    lib.smm_conv_error_string.argtypes = [ctypes.c_int]
    lib.smm_conv_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def smm_conv_cuda(x: torch.Tensor, deltas: torch.Tensor,
                  entries: torch.Tensor, *, t_m: int, ro: int, co: int,
                  stride: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel: ``x`` (B, N, RI, CI) float32 on a CUDA
    device → (B, m_tiles·t_m, RO, CO) float32.  Raises on anything the
    kernel does not take, and when the launch is refused."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"smm_conv_cuda needs CUDA tensors, got x on "
                         f"{x.device}")
    _check("x", x, torch.float32, 4, x.device)
    _check("deltas", deltas, torch.float32, 3, x.device)
    _check("entries", entries, torch.int32, 4, x.device)
    b, n_in, ri, ci = x.shape
    m_tiles, n2, u_plus = deltas.shape
    if n2 != n_in or entries.shape[:2] != (m_tiles, n_in) \
            or entries.shape[3] != 4:
        raise ValueError(f"operand shapes disagree: x {tuple(x.shape)}, "
                         f"deltas {tuple(deltas.shape)}, entries "
                         f"{tuple(entries.shape)}")
    if stride < 1 or t_m < 1 or ro < 1 or co < 1 \
            or (ro - 1) * stride >= ri or (co - 1) * stride >= ci:
        raise ValueError(f"bad geometry: t_m={t_m} ro={ro} co={co} "
                         f"stride={stride} for a {ri}x{ci} input")
    if b > 65535 or m_tiles > 65535:
        raise ValueError(f"batch {b} and m_tiles {m_tiles} must be <= 65535")
    out = torch.empty(b, m_tiles * t_m, ro, co, dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = load_kernel()
    err = lib.smm_conv_launch(
        x.data_ptr(), deltas.data_ptr(), entries.data_ptr(), out.data_ptr(),
        b, n_in, ri, ci, m_tiles, u_plus, entries.shape[2], t_m, ro, co,
        stride, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smm_conv launch failed: CUDA error {err} "
                           f"({lib.smm_conv_error_string(err).decode()})")
    launches += 1
    return out


def smm_conv_packed(x: torch.Tensor, deltas: torch.Tensor,
                    entries: torch.Tensor, *, t_m: int, ro: int, co: int,
                    stride: int = 1) -> torch.Tensor:
    """The kernel's function on packed operands, by device: the plain
    version for CPU tensors, the CUDA kernel otherwise."""
    if x.device.type == "cpu":
        return smm_conv_plain(x, deltas, entries, t_m=t_m, ro=ro, co=co,
                              stride=stride)
    return smm_conv_cuda(x, deltas, entries, t_m=t_m, ro=ro, co=co,
                         stride=stride)


def smm_conv_batched(x: torch.Tensor, code: LayerCode, *, stride: int = 1,
                     operands: tuple | None = None) -> torch.Tensor:
    """Batched CoDR SMM convolution: ``x`` (B, N, RI, CI) float32 →
    (B, M, RO, CO), int-exact, one launch for the whole batch.

    Pass ``operands`` (the ``(deltas, entries, meta)`` triple of
    :func:`smm_operands_on`, on ``x``'s device) to reuse a layer's packed
    operands across calls — the engine caches them per layer."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    _, n_in, ri, ci = x.shape
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    ro, co = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    if operands is None:
        operands = smm_operands_on(code, n_in, x.device)
    deltas, entries, meta = operands
    y = smm_conv_packed(x, deltas, entries, t_m=meta["t_m"], ro=ro, co=co,
                        stride=stride)
    return y[:, : code.shape[0]]


def smm_conv(x: torch.Tensor, code: LayerCode, *,
             stride: int = 1) -> torch.Tensor:
    """CoDR SMM convolution of one sample ``x`` (N, RI, CI) → (M, RO, CO)
    pre-activation int-exact accumulations (float32)."""
    return smm_conv_batched(x[None], code, stride=stride)[0]
