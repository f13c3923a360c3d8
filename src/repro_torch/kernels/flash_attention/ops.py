"""Wrapper and launch counter for the flash attention kernel.

Source note.  The kernel, ``csrc/flash_attention.cu``, replaces the
Pallas TPU kernel ``src/repro/kernels/flash_attention/kernel.py:67``
(``flash_attention_pallas`` / ``_flash_kernel``) and the GQA head repeat
of its wrapper ``src/repro/kernels/flash_attention/ops.py:10``: online-
softmax attention with float32 running max, denominator and accumulator,
scale ``D^-½``, a top-left causal mask, output in ``q``'s dtype.  On the
H100 it is bound by operations at long prompts: ~2·S²·Hq·(D + Dv)
flops (halved by the causal mask) on ~S·(Hq + 2·Hkv)·D values.  What the
design does: one block per (64-row q tile, q head, batch) loops over
64-row kv tiles with the statistics and the output tile in registers, so
the scores never reach device memory; it reads its kv head in place (no
repeat) and masks ragged tails instead of snapping tiles to divisors of
S.  Its limit — float32 FMAs on the CUDA cores, not the tensor cores — is
in the source and in PERF.md.

The TPU wrapper's ``bq`` / ``bk`` pick its grid and change no result, and
``interpret`` has nothing to map to, so this wrapper takes neither.  It
takes, on both devices, what the kernel takes: q, k and v all float32 or
all bfloat16, 1 ≤ D, Dv ≤ 256, Hq a multiple of Hkv, Sk ≥ 1; anything
else raises ``ValueError``.

Dispatch: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`); a
CUDA tensor launches the kernel or raises.  :data:`launches` counts
kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["launches", "load_kernel", "flash_attention_cuda",
           "flash_attention_kernel"]

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_YZ = 65535      # the grid's y (q heads) and z (batch) extents

launches = 0          # kernel launches since the count was last set to 0


@functools.cache
def load_kernel():
    """Build (at first use) and load the kernel; returns the library."""
    lib = _build.load_library(SOURCE)
    lib.flash_attention_launch.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 9
                                           + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, H, D), got shape "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"q, k and v must be all float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    if k.shape != (b, sk, hkv, d) or v.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}: k (B, Sk, Hkv, D), v (B, "
                         f"Sk, Hkv, Dv)")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if sk < 1:
        raise ValueError("Sk must be at least 1")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={d}, Dv={dv} must lie in 1.."
                         f"{MAX_HEAD_DIM}")
    if b > _GRID_YZ or hq > _GRID_YZ:
        raise ValueError(f"B={b} and Hq={hq} must be at most {_GRID_YZ} "
                         f"(the grid's extent)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool) -> torch.Tensor:
    """Launch the CUDA kernel on tensors on a CUDA device.  Raises on
    anything the kernel does not take, and when the launch is refused."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got q "
                         f"on {q.device}")
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    out = torch.empty(b, sq, hq, dv, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = load_kernel()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        hq, hkv, d, dv, int(causal), int(q.dtype == torch.bfloat16),
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    launches += 1
    return out


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,Hq,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv) → (B,Sq,Hq,Dv) in
    ``q``'s dtype; GQA reads kv head ``h // (Hq / Hkv)`` for q head ``h``.
    CPU tensors run the plain version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
