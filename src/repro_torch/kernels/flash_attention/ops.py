"""Wrapper, routing rule and launch counters for the flash attention
kernels.

Source note.  Two hand-written CUDA kernels replace the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:67``
(``flash_attention_pallas`` / ``_flash_kernel``) and the GQA head repeat
of its wrapper ``src/repro/kernels/flash_attention/ops.py:10``: online-
softmax attention with float32 running max, denominator and accumulator,
scale ``D^-½``, a top-left causal mask, output in ``q``'s dtype.  On the
H100 it is bound by operations at long prompts: ~2·S²·Hq·(D + Dv)
flops (halved by the causal mask) on ~S·(Hq + 2·Hkv)·D values.  Both
instances keep the scores out of device memory, read the kv head in
place (no repeat), mask ragged tails instead of snapping tiles to
divisors of S, skip kv tiles above the causal diagonal and sum in a
fixed order.

* ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bfloat16 with
  D = Dv ∈ {64, 128}.  TMA loads into a shared-memory ring fed by a
  producer warp, ``wgmma`` on the tensor cores for Q·Kᵀ and for P·V, P
  fed as three bf16 parts (hi + mid + lo) so the output stays within one
  bf16 ulp of the float32 plain version (two parts do not, where a row's
  output cancels to a small fraction of its terms).
* ``"simt"`` (``csrc/flash_attention.cu``): every other shape, and
  float32 (rtol 1e-4), with float32 FMAs on the CUDA cores.

The rule is :func:`pick_impl`.  ``impl=`` of :func:`flash_attention_cuda`
forces one instance (the tests and ``chip_smoke.py`` use it to time and
check both); forcing ``"sm90"`` on a shape it does not take raises
``ValueError``.  Nothing gives way to the other instance or to the plain
version: a failed build or launch raises.

The TPU wrapper's ``bq`` / ``bk`` pick its grid and change no result, and
``interpret`` has nothing to map to, so this wrapper takes neither.  It
takes, on both devices, what the kernels take: q, k and v all float32 or
all bfloat16, 1 ≤ D, Dv ≤ 256, Hq a multiple of Hkv, Sk ≥ 1; anything
else raises ``ValueError``.

Dispatch: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`); a
CUDA tensor launches a kernel or raises.  :data:`launches` counts kernel
launches, and only those; :data:`launches_by_impl` splits the same count
by instance.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["launches", "launches_by_impl", "IMPLS", "SOURCES",
           "SM90_HEAD_DIMS", "pick_impl", "load_kernel", "sm90_info",
           "flash_attention_cuda", "flash_attention_kernel"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = {"simt": _CSRC / "flash_attention.cu",
           "sm90": _CSRC / "flash_attention_sm90.cu"}
IMPLS = tuple(SOURCES)
SM90_HEAD_DIMS = (64, 128)
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_YZ = 65535      # the simt grid's y (q heads) and z (batch) extents
_SM90_BQ = 128        # q rows per sm90 block: ceil(Sq / 128) ≤ 65535

launches = 0          # kernel launches since the count was last set to 0
launches_by_impl = dict.fromkeys(IMPLS, 0)   # the same count, by instance


def pick_impl(dtype: torch.dtype, d: int, dv: int) -> str:
    """The instance that runs a call: ``"sm90"`` for bfloat16 with
    D = Dv ∈ {64, 128}, ``"simt"`` for everything else."""
    if dtype == torch.bfloat16 and d == dv and d in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


@functools.cache
def load_kernel(impl: str):
    """Build (at first use) and load one instance; returns its library."""
    lib = _build.load_library(SOURCES[impl])
    if impl == "sm90":
        lib.flash_attention_sm90_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_sm90_launch.restype = ctypes.c_int
        lib.flash_attention_sm90_info.argtypes = ([ctypes.c_int]
                                                  + [ctypes.c_void_p] * 3)
        lib.flash_attention_sm90_info.restype = ctypes.c_int
        lib.flash_attention_sm90_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
        return lib
    lib.flash_attention_launch.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 9
                                           + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def sm90_info(d: int) -> dict:
    """Registers a thread at launch, dynamic shared memory bytes and
    resident blocks per SM of the sm90 instance for head dim ``d``."""
    lib = load_kernel("sm90")
    vals = [ctypes.c_int() for _ in range(3)]
    err = lib.flash_attention_sm90_info(d, *map(ctypes.byref, vals))
    if err != 0:
        what = lib.flash_attention_sm90_error_string(err).decode()
        raise RuntimeError(f"flash_attention_sm90_info failed: CUDA error "
                           f"{err} ({what})")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


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


def _resolve_impl(q: torch.Tensor, v: torch.Tensor, impl) -> str:
    """The instance for this call: ``impl`` if given and it takes the
    shape, else :func:`pick_impl`'s."""
    routed = pick_impl(q.dtype, q.shape[-1], v.shape[-1])
    if impl is None:
        return routed
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "sm90" and routed != "sm90":
        raise ValueError(f"the sm90 instance takes bfloat16 with D = Dv in "
                         f"{SM90_HEAD_DIMS}, got {q.dtype}, D={q.shape[-1]}, "
                         f"Dv={v.shape[-1]}")
    return impl


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the TMA's need)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, impl: str | None = None
                         ) -> torch.Tensor:
    """Launch a CUDA kernel on tensors on a CUDA device: the instance
    :func:`pick_impl` names, or ``impl``.  Raises on anything the
    instance does not take, and when the launch is refused."""
    global launches
    _check(q, k, v)
    impl = _resolve_impl(q, v, impl)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got q "
                         f"on {q.device}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    if impl == "sm90" and (b * hq >= 2 ** 31
                           or -(-sq // _SM90_BQ) > _GRID_YZ):
        raise ValueError(f"B*Hq={b * hq} must be below 2^31 and Sq={sq} at "
                         f"most {_GRID_YZ * _SM90_BQ} (the sm90 grid)")
    out = torch.empty(b, sq, hq, dv, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = load_kernel(impl)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if impl == "sm90":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        err = lib.flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hkv, d, int(causal), d ** -0.5, stream)
        what = lib.flash_attention_sm90_error_string
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hkv, d, dv, int(causal), int(q.dtype == torch.bfloat16),
            d ** -0.5, stream)
        what = lib.flash_attention_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention ({impl}) launch failed: CUDA "
                           f"error {err} ({what(err).decode()})")
    launches += 1
    launches_by_impl[impl] += 1
    return out


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,Hq,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv) → (B,Sq,Hq,Dv) in
    ``q``'s dtype; GQA reads kv head ``h // (Hq / Hkv)`` for q head ``h``.
    CPU tensors run the plain version, CUDA tensors the kernel instance
    that :func:`pick_impl` names."""
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
