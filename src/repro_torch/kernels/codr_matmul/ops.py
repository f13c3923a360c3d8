"""Wrapper, routing rule and launch counters for the CoDR compressed
matmul kernels.

Source note.  Three hand-written CUDA kernels replace the Pallas TPU
kernel ``src/repro/kernels/codr_matmul/kernel.py:70``
(``codr_matmul_pallas`` / ``_codr_matmul_kernel`` / ``_decode_block``):
``y = (x @ table[idx]) · scale`` with the weight decoder fused into the
matmul, f32 accumulation, output in ``x``'s dtype.  On the H100 the
function is bound by bytes at decode: the packed weights,
``K·N·bits/8`` bytes, over 3.35 TB/s (M = 4 rows of activations are
nothing beside them); at prefill (M = 128) by the bytes or by the bf16
tensor-core rate, within a factor of two of each other.  No instance
expands the weights to a dense matrix in device memory.

* ``"splitk"`` (``csrc/codr_matmul_splitk.cu``): decode, M ≤
  :data:`SPLITK_MAX_M`, and bits = 16 up to :data:`BITS16_SPLITK_MAX_M`.
  The grid splits K into slices so that every
  projection launches at least one block per SM; the packed words stream
  through a four-stage ring of 16-byte ``cp.async`` copies, a lookup in
  one of 8 copies of a pair table decodes two indices at once, f32 FMAs
  on the CUDA cores.  The last
  block of a column tile sums the slices' f32 partials in slice order,
  so a call repeats bit for bit, in one launch.
* ``"sm90"`` (``csrc/codr_matmul_sm90.cu``): prefill, M above it, bits
  1–8.  Packed tiles are decoded into bf16 shared-memory tiles and
  multiplied by ``wgmma`` with f32 accumulation, a fresh accumulator a
  64-row k-tile; float32 x goes in three bf16 parts (its top 16 bits,
  and so on: exact), and the weights in three when a table
  entry is not exact in bf16 (decided on the device).  K is split as in
  ``splitk``.
* ``"simt"`` (``csrc/codr_matmul.cu``): the first kernel, one block per
  64 output columns looping over K with f32 FMAs.  It takes bits = 16
  above :data:`BITS16_SPLITK_MAX_M` rows (sm90 does not take bits = 16,
  and splitk, which re-reads the packed words for every 16 rows, is the
  slower there), and stays as the yardstick ``chip_smoke.py`` times the
  others against.

The rule is :func:`pick_impl`, a function of (M, bits) alone.
``impl=`` of :func:`codr_matmul_cuda` forces one instance (the tests
and ``chip_smoke.py`` use it to time and check each); forcing ``"sm90"``
on bits = 16 raises ``ValueError``.  Nothing gives way to another
instance or to the plain version: a failed build or launch raises.

Dispatch: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.codr_matmul.ref.codr_matmul_ref`); a CUDA
tensor launches a kernel or raises.  :data:`launches` counts kernel
launches, and only those (one per call); :data:`launches_by_impl` splits
the same count by instance, :data:`launches_by_bits` by index width.  A call made while its stream is capturing a
CUDA graph launches nothing: it records a kernel into the graph and
counts in :data:`captured` instead.  A replay of the graph launches that
kernel with no call of the wrapper, so no counter here sees it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import pathlib
import threading

import torch

from repro_torch.core.codr_linear import PackedWeight
from repro_torch.kernels import _build
from repro_torch.kernels.codr_matmul.ref import codr_matmul_ref

__all__ = ["KERNEL_CAPS", "IMPLS", "SOURCES", "SPLITK_MAX_M",
           "BITS16_SPLITK_MAX_M", "SM90_BITS", "launches", "launches_by_impl",
           "launches_by_bits", "pick_impl", "splitk_plan",
           "sm90_plan", "load_kernel", "captured", "scratch_pool",
           "codr_matmul_cuda", "codr_matmul"]

# Capability facts consumed by the backend registry
# (repro_torch.core.backends.CodrMatmulBackend) — this kernel only has a
# matmul (linear-layer) datapath; conv layers never route here.
KERNEL_CAPS = {
    "kinds": ("linear",),
    "integer_activations": False,  # float activations, f32 accumulation
    "packed_matmul": True,         # executes PackedLinear params leaves
    "description": "hand-written CUDA fused decode+matmul for sm_90a "
                   "(unique-index pack; split-K decode, wgmma prefill, f32 "
                   "accumulation; plain PyTorch version on CPU tensors)",
}

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = {"simt": _CSRC / "codr_matmul.cu",
           "splitk": _CSRC / "codr_matmul_splitk.cu",
           "sm90": _CSRC / "codr_matmul_sm90.cu"}
IMPLS = tuple(SOURCES)
BITS = (1, 2, 4, 8, 16)
SM90_BITS = (1, 2, 4, 8)
# the largest M routed to splitk: on the H100 splitk is the faster over
# one layer's seven projections up to M = 16, sm90 from M = 32
# (chip_smoke.py's threshold lines; PERF.md)
SPLITK_MAX_M = 16
# the largest M routed to splitk at bits = 16: splitk is the faster over
# one layer's seven projections at M = 17 … 96, simt at M = 128
# (chip_smoke.py's bits=16 lines; PERF.md)
BITS16_SPLITK_MAX_M = 96
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_YZ = 65535
_SMS = 132            # SMs of an H100 SXM, the plans' default
# splitk: blocks of 256 threads resident on an SM at RM = 4 / 8 / 16 rows
# of x (ptxas: ~120 / ~190 / ~240 registers a thread), rows of x a block
# stages (RM rows at 4 bytes), the fewest K rows worth a slice of their own
_SPLITK_PER_SM = {4: 2, 8: 1, 16: 1}
_SPLITK_X_BYTES = 32768
_SPLITK_MIN_ROWS = 64
_SM90_BM, _SM90_BN, _SM90_BK = 128, 128, 64

launches = 0          # kernel launches since the count was last set to 0
launches_by_impl = dict.fromkeys(IMPLS, 0)   # the same count, by instance
launches_by_bits = dict.fromkeys(BITS, 0)    # the same count, by index width
captured = 0          # calls recorded into a CUDA graph, which launch nothing


def pick_impl(m: int, bits: int) -> str:
    """The instance that runs a call of M rows at ``bits``: for bits 1–8
    ``"splitk"`` up to :data:`SPLITK_MAX_M` rows and ``"sm90"`` above;
    for bits = 16, which sm90 does not take, ``"splitk"`` up to
    :data:`BITS16_SPLITK_MAX_M` rows and ``"simt"`` above."""
    if bits in SM90_BITS:
        return "splitk" if m <= SPLITK_MAX_M else "sm90"
    return "splitk" if m <= BITS16_SPLITK_MAX_M else "simt"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def splitk_plan(m: int, k: int, n: int, sms: int = _SMS) -> dict:
    """Grid of the splitk instance: ``rm`` rows of x per block (4, 8 or
    16), ``tn`` output columns per tile (256, 128 or 64), and K cut into
    ``slices`` of ``ks`` rows, every slice non-empty.  The grid has at
    least a block per SM and, where the tile counts allow, no more than
    are resident at once (two an SM at M <= 4), so that no SM runs a
    second round; within that, the tile whose last block reads the
    partials in the fewest rounds (16 slices a thread, the threads that
    share a quad of columns splitting them), the widest of those.
    ``sms`` is the card's SM count."""
    rm = 4 if m <= 4 else 8 if m <= 8 else 16
    m_tiles = _cdiv(m, rm)
    target = sms * _SPLITK_PER_SM[rm]
    fewest = _cdiv(k * rm * 4, _SPLITK_X_BYTES)    # the x slice fits
    most = max(1, _cdiv(k, _SPLITK_MIN_ROWS))
    plans = []
    for tn in (256, 128, 64):
        tiles = m_tiles * _cdiv(n, tn)
        # at least a block per SM; more, up to the resident count, while a
        # slice keeps _SPLITK_MIN_ROWS rows
        slices = max(_cdiv(sms, tiles), min(target // tiles, most))
        slices = max(1, min(slices, _cdiv(k, 16)), fewest)
        ks = _cdiv(k, slices)
        slices = _cdiv(k, ks)
        runs = max(1, 256 // (rm * tn // 4))
        plans.append(((tiles * slices < sms, _cdiv(slices, runs * 16)),
                      dict(rm=rm, tn=tn, ks=ks, slices=slices,
                           m_tiles=m_tiles, n_tiles=tiles // m_tiles)))
    return min(plans, key=lambda p: p[0])[1]   # stable: widest first


@functools.lru_cache(maxsize=None)
def sm90_plan(m: int, k: int, n: int, sms: int = _SMS) -> dict:
    """Grid of the sm90 instance: 128 × 128 output tiles, K cut into
    ``slices`` of ``kt`` 64-row k-tiles each, every slice non-empty.  One
    block fits on an SM, so the slices fill at most one round of a card
    of ``sms`` SMs."""
    m_tiles, n_tiles = _cdiv(m, _SM90_BM), _cdiv(n, _SM90_BN)
    k_tiles = _cdiv(k, _SM90_BK)
    slices = min(max(1, sms // (m_tiles * n_tiles)), k_tiles)
    kt = _cdiv(k_tiles, slices)
    return dict(kt=kt, slices=_cdiv(k_tiles, kt), m_tiles=m_tiles,
                n_tiles=n_tiles)


def _bind(lib, name: str, n_ptr: int, n_int: int) -> None:
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


@functools.cache
def _sm_count(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count


@functools.cache
def load_kernel(impl: str):
    """Build (at first use) and load one instance; returns its library."""
    lib = _build.load_library(SOURCES[impl])
    if impl == "simt":
        _bind(lib, "codr_matmul_launch", 5, 6)
    else:
        _bind(lib, f"codr_matmul_{impl}_launch", 7, 9)
    err_fn = getattr(lib, "codr_matmul_error_string" if impl == "simt"
                     else f"codr_matmul_{impl}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    return lib


# Scratch of the split-K instances, one int32 buffer per (device, stream):
# a counter per output tile, made zero once and set back to zero by the
# last block of each tile, then the slices' f32 partials.  Calls on one
# stream run in order, so they share it; no call clears it, none syncs
# with the host, and its address stays put from call to call.  Inside
# scratch_pool(pool) a thread's calls keep their buffers in ``pool``.
_scratch: dict[tuple, tuple[torch.Tensor, int]] = {}
_local = threading.local()


@contextlib.contextmanager
def scratch_pool(pool: dict):
    """Keep the split-K scratch of the calls this thread makes inside the
    block in ``pool``, a dict the caller owns, not in the module's
    per-stream buffers.  A CUDA graph reads and writes the scratch its
    capture used at every replay, so a graph's owner warms up and
    captures inside a pool of its own and holds it: no other graph and
    no eager call shares those counters and partials, whatever stream
    each runs on."""
    saved = getattr(_local, "pool", None)
    _local.pool = pool
    try:
        yield pool
    finally:
        _local.pool = saved


def _split_scratch(device: torch.device, stream: int, tiles: int,
                   partials: int) -> tuple:
    """(counters, partials) views of the stream's scratch, grown (and
    zeroed) when a call needs more than it holds."""
    pool = getattr(_local, "pool", None)
    pool = _scratch if pool is None else pool
    key = (device.index, stream)
    buf, n_counters = pool.get(key, (None, 0))
    if buf is None or n_counters < tiles or buf.numel() - n_counters < partials:
        n_counters = max(n_counters, _cdiv(tiles, 64) * 64, 1024)
        room = max(partials, 0 if buf is None else buf.numel() - n_counters)
        buf = torch.zeros(n_counters + room, dtype=torch.int32, device=device)
        pool[key] = (buf, n_counters)
    return (buf[:n_counters],
            buf[n_counters:n_counters + partials].view(torch.float32))


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


def _resolve_impl(m: int, bits: int, impl) -> str:
    if impl is None:
        return pick_impl(m, bits)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "sm90" and bits not in SM90_BITS:
        raise ValueError(f"the sm90 instance takes bits in {SM90_BITS}, got "
                         f"{bits}")
    return impl


def codr_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                     table: torch.Tensor, scale: torch.Tensor, *, bits: int,
                     n: int, impl: str | None = None) -> torch.Tensor:
    """Launch a CUDA kernel: ``x`` (M, K) float32 or bfloat16 on a CUDA
    device, ``packed`` (K, n·bits/32) int32, ``table`` (2^bits,) float32
    or bfloat16, ``scale`` one float32 → (M, n) in ``x``'s dtype, on the
    instance :func:`pick_impl` names, or ``impl``.  Raises on anything
    the instance does not take, and when the launch is refused."""
    global launches, captured
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
    impl = _resolve_impl(m, bits, impl)
    if x.device.type != "cuda":
        raise ValueError(f"codr_matmul_cuda needs CUDA tensors, got x on "
                         f"{x.device}")
    if impl == "simt" and m > _GRID_YZ * 32:
        raise ValueError(f"M={m} exceeds the grid ({_GRID_YZ * 32} rows)")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = load_kernel(impl)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    flags = (int(x.dtype == torch.bfloat16), int(table.dtype == torch.bfloat16))
    if impl == "simt":
        err = lib.codr_matmul_launch(
            x.data_ptr(), packed.data_ptr(), table.data_ptr(),
            scale.data_ptr(), out.data_ptr(), m, k, n, bits, *flags, stream)
        what = lib.codr_matmul_error_string
    else:
        plan = (splitk_plan if impl == "splitk" else sm90_plan)(
            m, k, n, _sm_count(x.device.index))
        if plan["m_tiles"] > _GRID_YZ or plan["slices"] > _GRID_YZ:
            raise ValueError(f"M={m}, K={k} exceed the {impl} grid")
        counters, partial = _split_scratch(
            x.device, stream, plan["m_tiles"] * plan["n_tiles"],
            plan["slices"] * m * n if plan["slices"] > 1 else 0)
        shape = ((plan["tn"], plan["ks"]) if impl == "splitk"
                 else (_SM90_BN, plan["kt"]))
        err = getattr(lib, f"codr_matmul_{impl}_launch")(
            x.data_ptr(), packed.data_ptr(), table.data_ptr(),
            scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial.numel() else None,
            counters.data_ptr(), m, k, n, bits, *flags, *shape,
            plan["slices"], stream)
        what = getattr(lib, f"codr_matmul_{impl}_error_string")
    if err != 0:
        raise RuntimeError(f"codr_matmul ({impl}) launch failed: CUDA error "
                           f"{err} ({what(err).decode()})")
    with torch.cuda.device(x.device):
        capturing = torch.cuda.is_current_stream_capturing()
    if capturing:
        captured += 1
    else:
        launches += 1
        launches_by_impl[impl] += 1
        launches_by_bits[bits] += 1
    return out


def codr_matmul(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """``y = x @ decode(w)`` with the decode fused into the matmul tiles;
    ``w`` is one (unstacked) :class:`PackedWeight`.  CPU tensors run the
    plain version, CUDA tensors the kernel instance that
    :func:`pick_impl` names."""
    args = (x, w.packed, w.table, w.scale.reshape(-1))
    if x.device.type == "cpu":
        return codr_matmul_ref(*args, bits=w.bits, n=w.shape[1])
    return codr_matmul_cuda(*args, bits=w.bits, n=w.shape[1])
