"""Wrapper, operand packer, routing rule and launch counters for the SMM
convolution kernels.

Source note.  Two hand-written CUDA kernels replace the Pallas TPU
kernel ``src/repro/kernels/smm_conv/kernel.py:88`` (``smm_conv_pallas``
/ ``_smm_conv_kernel``): the paper's MPE/APE datapath -- differential
scalar×matrix products over each weight vector's sorted unique values,
routed by a crossbar into output-stationary accumulators.  Against the
H100's peaks the function is bound by bytes: at the VGG16 main-path
shapes its float32 input and output planes (0.05–0.4 GB per launch at
batch 4) take longer at 3.35 TB/s than its dense int8 work at 1,979
TOP/s.  Both instances sum in int32 and equal the plain version exactly.

* ``"sm90"`` (``csrc/smm_conv_sm90.cu``): stride 1, weights that fit
  int8 (``meta["int8_weights"]`` of :func:`pack_smm_operands`, known on
  the host, so routing needs no device sync) and a window that fits
  shared memory (:func:`sm90_plan`).  One cooperative launch decodes
  ``(deltas, entries)`` into a dense int8 weight matrix in a scratch
  buffer kept per (device, stream) here, then runs an implicit GEMM on
  ``wgmma`` ``.s32.s8.s8`` over windows staged as int8.  It stops the
  launch (``__trap``) on an x value outside int8, which a direct call
  could pass: the failure shows at the next sync.
* ``"simt"`` (``csrc/smm_conv.cu``): the first kernel, on the CUDA
  cores; every other shape (strided layers such as AlexNet conv1 and
  GoogLeNet conv1, weights outside int8).

With the layer's epilogue operands (the device scale of ``x``, the
layer's scale, bias, ReLU; an ``out`` that may be a channel slice) a call
returns the finished layer output, the ``int8_features`` epilogue's
numbers bit for bit: ``sm90`` applies it in its own store and writes no
raw sums (:data:`launches_with_epilogue` counts those launches); ``simt``
has no such store and is followed by the ``int8_features`` epilogue
launch.  Without them a call returns the raw sums, as before.

With ``raw_features`` as well, ``x`` is a layer's raw float32 features
(NCHW storage) rather than int8 features, and the call quantizes them
against that scale (the ``int8_features`` ``quantize`` arithmetic, bit
for bit): ``sm90`` in its phase 1b, as it converts ``x`` to int8, so one
launch reads the raw features and writes the layer's output
(:data:`launches_with_quantize` counts those launches); before ``simt``,
and on CPU tensors, the ``int8_features`` ``quantize`` runs first, then
the call as without.

The rule is :func:`pick_impl`.  ``impl=`` of :func:`smm_conv_cuda`
forces one instance (the tests and ``chip_smoke.py`` use it); forcing
``"sm90"`` on a shape it does not take raises ``ValueError``.  Nothing
gives way to another instance or to the plain version: a failed build
or launch raises.

Dispatch: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.smm_conv.ref.smm_conv_plain`, then
``epilogue_plain`` where the call has the epilogue operands); a CUDA
tensor launches a kernel or raises.  :data:`launches` counts kernel
launches, and only those (one per call); :data:`launches_by_impl`
splits the same count by instance.
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
from repro_torch.kernels.int8_features import ops as feats
from repro_torch.kernels.smm_conv.ref import smm_conv_plain

__all__ = ["KERNEL_CAPS", "IMPLS", "SOURCES", "launches", "launches_by_impl",
           "launches_with_epilogue", "launches_with_quantize",
           "pack_smm_operands", "smm_operands_on",
           "sm90_plan", "sm90_refusal", "pick_impl", "load_kernel",
           "smm_conv_cuda", "smm_conv_packed", "smm_conv_batched",
           "smm_conv"]

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

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = {"simt": _CSRC / "smm_conv.cu", "sm90": _CSRC / "smm_conv_sm90.cu"}
IMPLS = tuple(SOURCES)
# sm90: threads of a block, pixels of one warpgroup's wgmma, stages of the
# shared-memory ring, scratch bytes before the dense weights (the grid
# barrier's words), the most dynamic shared memory a block may use, the
# widest window a descriptor's leading byte offset can span
_SM90_THREADS, _SM90_WG_N, _SM90_STAGES, _SM90_HEAD = 256, 256, 3, 256
_SM90_MAX_SMEM, _SM90_MAX_P = 232448, 16383
# the least a stage holds: the epilogue stages 8 rows of 136 floats a warp
_SM90_MIN_STAGE = _SM90_THREADS // 32 * 8 * 136 * 4
_GRID_YZ = 65535

launches = 0          # kernel launches since the count was last set to 0
launches_by_impl = dict.fromkeys(IMPLS, 0)   # the same count, by instance
launches_with_epilogue = 0   # sm90 launches that applied the epilogue
launches_with_quantize = 0   # of them, those that quantized x in phase 1b


def pack_smm_operands(code: LayerCode, n_in: int
                      ) -> tuple[np.ndarray, np.ndarray, dict]:
    """UCR vectors → padded static-shape kernel operands (equal to
    ``repro.kernels.smm_conv.ops.pack_smm_operands``, vectorized).

    Returns ``(deltas, entries, meta)``:
      deltas  (m_tiles, N, U_max+1) float32 — Δs of sorted unique weights
      entries (m_tiles, N, L_max, 4) int32 — (u, m_local, r, c) per
              repetition; padding → (U_max, 0, 0, 0) = zero product row.

    ``meta`` holds ``m_tiles``, ``t_m``, ``u_max`` and ``l_max`` as the
    JAX packer's does, and ``int8_weights``: every unique value fits int8
    and no vector names a position twice, so the dense weights the
    operands decode to are int8 -- what the ``sm90`` instance takes.
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
    meta = {"m_tiles": m_tiles, "t_m": code.t_m, "u_max": u_max,
            "l_max": l_max, "int8_weights": True}
    if not len(code.ucr) or not n_u.sum():
        return deltas, entries, meta

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
    slots = l_vec * (code.t_m * rk * ck) + idx
    meta["int8_weights"] = bool(vals.min() >= -128 and vals.max() <= 127
                                and len(np.unique(slots)) == len(slots))
    return deltas, entries, meta


def smm_operands_on(code: LayerCode, n_in: int, device) -> tuple:
    """:func:`pack_smm_operands` with the arrays moved to ``device``."""
    deltas, entries, meta = pack_smm_operands(code, n_in)
    return (torch.from_numpy(deltas).to(device),
            torch.from_numpy(entries).to(device), meta)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def sm90_plan(x_shape, deltas_shape, *, t_m: int, ro: int, co: int) -> dict:
    """Tiles, shared memory and scratch of the sm90 instance at stride 1,
    as ``smm_conv_sm90_launch`` computes them: ``bm`` output channels x
    ``bn`` pixels a tile (128 x 256 for M > 64 where its stages fit shared
    memory, else 64 x 512), a window
    of ``p`` pixels (pixels linearized over the input width), three
    stages of ``stage_bytes``, the phase-1 buffer ``decode_bytes``, and in
    ``scratch_bytes`` the barrier words, the dense int8 matrix (``m_pad``
    rows, ``chunks`` · taps · 32 columns) and x in int8 (B · chunks · 32
    bytes a pixel)."""
    b, n_in, ri, ci = x_shape
    m_tiles, _, u_plus = deltas_shape
    kh, kw = ri - ro + 1, ci - co + 1
    taps, m = kh * kw, m_tiles * t_m

    def stage(wm):
        p = 2 * _SM90_WG_N // wm + (kh - 1) * ci + kw - 1
        return p, max(_cdiv(taps * 2 * 64 * wm * 16 + 2 * p * 16, 128) * 128,
                      _SM90_MIN_STAGE)
    # two warpgroups along the channels past 64, unless their stages
    # overflow shared memory (a wide kernel, e.g. 5x5 at 96 channels)
    wm = 2 if m > 64 and _SM90_STAGES * stage(2)[1] <= _SM90_MAX_SMEM else 1
    bm, bn = 64 * wm, 2 * _SM90_WG_N // wm
    p, stage_bytes = stage(wm)
    chunks, m_pad = _cdiv(n_in, 32), _cdiv(m, bm) * bm
    w_bytes = m_pad * chunks * taps * 32
    return dict(bm=bm, bn=bn, p=p, taps=taps, chunks=chunks, m_pad=m_pad,
                stage_bytes=stage_bytes, smem=_SM90_STAGES * stage_bytes,
                decode_bytes=(_SM90_THREADS // 16) * taps * t_m * 16
                + _SM90_THREADS * u_plus,
                scratch_bytes=_SM90_HEAD + w_bytes + b * chunks * 32 * ri * ci,
                tiles=b * _cdiv(ro * ci, bn) * (m_pad // bm))


@functools.lru_cache(maxsize=256)
def sm90_refusal(x_shape, deltas_shape, *, t_m: int, ro: int, co: int,
                 stride: int, int8_weights: bool) -> str | None:
    """Why the sm90 instance does not take this call, or None."""
    if stride != 1:
        return f"stride {stride}: the sm90 instance takes stride 1"
    if not int8_weights:
        return ("the operands are not known to decode to int8 weights "
                "(meta['int8_weights'] of pack_smm_operands)")
    plan = sm90_plan(x_shape, deltas_shape, t_m=t_m, ro=ro, co=co)
    if plan["smem"] > _SM90_MAX_SMEM or plan["p"] > _SM90_MAX_P:
        return (f"a window of {plan['p']} pixels and {plan['taps']} taps "
                f"needs {plan['smem']} bytes of shared memory "
                f"(at most {_SM90_MAX_SMEM})")
    if plan["decode_bytes"] > plan["smem"]:
        return f"t_m {t_m} and U+1 {deltas_shape[2]} overflow phase 1"
    if plan["tiles"] > 1 << 30:
        return f"{plan['tiles']} tiles exceed the schedule"
    return None


def pick_impl(x_shape, deltas_shape, *, t_m: int, ro: int, co: int,
              stride: int, int8_weights: bool) -> str:
    """The instance that runs a call: ``"sm90"`` wherever it takes the
    shape (:func:`sm90_refusal`), else ``"simt"``.  On the H100 sm90 is
    the faster at every VGG16 layer it takes, conv1_1 (N = 3, padded to
    32) included (chip_smoke.py's per-layer rows; PERF.md)."""
    return "simt" if sm90_refusal(
        x_shape, deltas_shape, t_m=t_m, ro=ro, co=co, stride=stride,
        int8_weights=int8_weights) else "sm90"


@functools.cache
def load_kernel(impl: str):
    """Build (at first use) and load one instance; returns its library."""
    lib = _build.load_library(SOURCES[impl])
    name = "smm_conv" if impl == "simt" else f"smm_conv_{impl}"
    fn = getattr(lib, f"{name}_launch")
    if impl == "simt":
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 10
                       + [ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


# Scratch of the sm90 instance per (device, stream), at least 1 MiB
# (:func:`_build.stream_buffer`): two barrier words, left ready by every
# launch, then the dense int8 weights and x in int8, written anew.
_scratch: dict[tuple, torch.Tensor] = {}


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


def _resolve_impl(x_shape, deltas_shape, impl, **kw) -> str:
    if impl is None:
        return pick_impl(x_shape, deltas_shape, **kw)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "sm90":
        why = sm90_refusal(x_shape, deltas_shape, **kw)
        if why:
            raise ValueError(f"the sm90 instance does not take this call: "
                             f"{why}")
    return impl


def _epilogue(x, m_out: int, ro: int, co: int, x_scale, layer_scale, bias,
              relu, out, m: int | None = None,
              raw_features: bool = False) -> tuple | None:
    """A call's epilogue operands, checked once whichever entry takes
    them: None for the raw sums (bias, relu, out and raw features need
    x_scale), else ``(x_scale, layer_scale, bias, relu, out, c)``, ``c``
    the channels written (``feats.check_epilogue``'s shape): ``m`` where
    given, else ``out``'s where it is NCHW with 1 .. ``m_out`` of them,
    else ``m_out``."""
    if x_scale is None:
        if bias is not None or relu or out is not None or raw_features:
            raise ValueError("bias, relu, out and raw_features belong to "
                             "the layer's epilogue: pass x_scale with them")
        return None
    if m is None:
        m = (out.shape[1] if out is not None and out.dim() == 4
             and 0 < out.shape[1] <= m_out else m_out)
    feats.check_epilogue((x.shape[0], m, ro, co), x.device, x_scale, bias,
                         out)
    return x_scale, float(layer_scale), bias, bool(relu), out, m


def _quantized(x: torch.Tensor, epi: tuple) -> torch.Tensor:
    """Raw features ``x`` (NCHW) as int8 features, contiguous NCHW: the
    ``int8_features`` ``quantize`` against the epilogue's scale (its plain
    version on CPU tensors), what precedes ``simt`` and the plain
    version."""
    return feats.quantize(x.permute(0, 2, 3, 1), epi[0])


def _unfused(y: torch.Tensor, epi: tuple | None) -> torch.Tensor:
    """The raw sums ``y``, or with ``epi`` the ``int8_features`` epilogue
    of their first ``c`` channels, into ``out`` where given: what follows
    ``simt`` and the plain version."""
    if epi is None:
        return y
    x_scale, layer_scale, bias, relu, out, c = epi
    return feats.epilogue(y[:, :c], x_scale, layer_scale, bias, relu=relu,
                          out=out)


def _launch(impl: str, x, deltas, entries, y, *, t_m: int, ro: int,
            co: int, stride: int, epi: tuple) -> None:
    """One launch of ``impl`` into ``y``; ``epi`` the sm90 launch's
    epilogue arguments (x_scale, layer_scale, bias, relu, m_rows, m_img,
    quantize_x; a null x_scale for the raw sums)."""
    global launches
    b, n_in, ri, ci = x.shape
    m_tiles, _, u_plus = deltas.shape
    lib = load_kernel(impl)
    stream = _build.stream_handle(x.device)
    args = (b, n_in, ri, ci, m_tiles, u_plus, entries.shape[2], t_m, ro, co)
    if impl == "simt":
        err = lib.smm_conv_launch(
            x.data_ptr(), deltas.data_ptr(), entries.data_ptr(),
            y.data_ptr(), *args, stride, stream)
        what = lib.smm_conv_error_string
    else:
        if entries.data_ptr() % 16:
            raise ValueError("entries must be 16-byte aligned")
        need = sm90_plan(tuple(x.shape), tuple(deltas.shape), t_m=t_m,
                         ro=ro, co=co)["scratch_bytes"]
        scratch = _build.stream_buffer(_scratch, x.device, stream,
                                       max(need, 1 << 20), torch.uint8)
        err = lib.smm_conv_sm90_launch(
            x.data_ptr(), deltas.data_ptr(), entries.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), scratch.numel(), *args, *epi,
            stream)
        what = lib.smm_conv_sm90_error_string
    if err != 0:
        raise RuntimeError(f"smm_conv ({impl}) launch failed: CUDA error "
                           f"{err} ({what(err).decode()})")
    launches += 1
    launches_by_impl[impl] += 1


def _on_cuda(x, deltas, entries, epi, int8_weights: bool,
             impl: str | None = None, *, t_m: int, ro: int, co: int,
             stride: int, raw: bool = False) -> torch.Tensor:
    """A call whose epilogue is checked, on its instance: ``sm90``
    applies ``epi`` in its store, and quantizes raw features ``x``
    (``raw``) in its phase 1b; before ``simt`` the ``int8_features``
    quantize runs, after it the ``int8_features`` epilogue."""
    global launches_with_epilogue, launches_with_quantize
    _check("x", x, torch.float32, 4, x.device)
    _check("deltas", deltas, torch.float32, 3, x.device)
    _check("entries", entries, torch.int32, 4, x.device)
    b, n_in, ri, ci = x.shape
    m_tiles, n2, _ = deltas.shape
    if n2 != n_in or entries.shape[:2] != (m_tiles, n_in) \
            or entries.shape[3] != 4:
        raise ValueError(f"operand shapes disagree: x {tuple(x.shape)}, "
                         f"deltas {tuple(deltas.shape)}, entries "
                         f"{tuple(entries.shape)}")
    if stride < 1 or t_m < 1 or ro < 1 or co < 1 \
            or (ro - 1) * stride >= ri or (co - 1) * stride >= ci:
        raise ValueError(f"bad geometry: t_m={t_m} ro={ro} co={co} "
                         f"stride={stride} for a {ri}x{ci} input")
    impl = _resolve_impl(tuple(x.shape), tuple(deltas.shape), impl, t_m=t_m,
                         ro=ro, co=co, stride=stride,
                         int8_weights=int8_weights)
    if x.device.type != "cuda":
        raise ValueError(f"smm_conv_cuda needs CUDA tensors, got x on "
                         f"{x.device}")
    if impl == "simt" and (b > _GRID_YZ or m_tiles > _GRID_YZ):
        raise ValueError(f"batch {b} and m_tiles {m_tiles} must be <= "
                         f"{_GRID_YZ}")
    fused = epi is not None and impl == "sm90"
    if raw and not fused:
        x = _quantized(x, epi)
    if fused:
        x_scale, layer_scale, bias, relu, out, c = epi
        bias = None if bias is None else bias.contiguous()
        if out is None:
            out = torch.empty(b, c, ro, co, dtype=torch.float32,
                              device=x.device)
        y, m_img = out, feats.channels_an_image("out", out, c, ro * co)
    else:
        y = torch.empty(b, m_tiles * t_m, ro, co, dtype=torch.float32,
                        device=x.device)
    if y.numel():
        _launch(impl, x, deltas, entries, y, t_m=t_m, ro=ro, co=co,
                stride=stride, epi=(
                    (x_scale.data_ptr(), layer_scale,
                     None if bias is None else bias.data_ptr(),
                     int(relu), c, m_img, int(raw)) if fused
                    else (None, 0.0, None, 0, 0, 0, 0)))
        launches_with_epilogue += int(fused)
        launches_with_quantize += int(fused and raw)
    return out.permute(0, 2, 3, 1) if fused else _unfused(y, epi)


def _packed(x, deltas, entries, epi, int8_weights: bool, raw: bool = False,
            **kw) -> torch.Tensor:
    """A call whose epilogue is checked, by device: the plain version on
    CPU tensors (raw features quantized first), a launch otherwise."""
    if x.device.type != "cpu":
        return _on_cuda(x, deltas, entries, epi, int8_weights, raw=raw, **kw)
    if raw:
        x = _quantized(x, epi)
    return _unfused(smm_conv_plain(x, deltas, entries, **kw), epi)


def smm_conv_cuda(x: torch.Tensor, deltas: torch.Tensor,
                  entries: torch.Tensor, *, t_m: int, ro: int, co: int,
                  stride: int = 1, int8_weights: bool = False,
                  impl: str | None = None,
                  x_scale: torch.Tensor | None = None,
                  layer_scale: float = 1.0,
                  bias: torch.Tensor | None = None, relu: bool = False,
                  out: torch.Tensor | None = None,
                  raw_features: bool = False) -> torch.Tensor:
    """Launch a CUDA kernel: ``x`` (B, N, RI, CI) float32 on a CUDA
    device → (B, m_tiles·t_m, RO, CO) float32, on the instance
    :func:`pick_impl` names, or ``impl``.  ``int8_weights`` is
    ``meta["int8_weights"]`` of :func:`pack_smm_operands` (False routes
    to simt).  Raises on anything the instance does not take, and when
    the launch is refused.

    With ``x_scale`` (``x``'s scale, one float32 on its device) the call
    applies the layer's epilogue, ``layer_scale``, ``bias`` and ``relu``
    as :func:`repro_torch.kernels.int8_features.ops.epilogue` takes them,
    and returns the layer's output NHWC ``(B, RO, CO, C)``, NCHW storage:
    ``out``'s (NCHW ``(B, C, RO, CO)``, C at most m_tiles·t_m, whole
    channel planes: a channel slice of a larger output) or a new tensor
    of C = m_tiles·t_m channels.  ``sm90`` applies it in its store, one
    launch and no raw sums (:data:`launches_with_epilogue`); after
    ``simt`` the ``int8_features`` epilogue runs.

    ``raw_features`` (with ``x_scale``): ``x`` is a layer's raw float32
    features, whose scale ``x_scale`` is, rather than int8 features; the
    call quantizes them first, ``sm90`` in its phase 1b
    (:data:`launches_with_quantize`), ``simt`` after the
    ``int8_features`` quantize launch."""
    epi = _epilogue(x, deltas.shape[0] * t_m, ro, co, x_scale, layer_scale,
                    bias, relu, out, raw_features=raw_features)
    return _on_cuda(x, deltas, entries, epi, int8_weights, impl, t_m=t_m,
                    ro=ro, co=co, stride=stride, raw=raw_features)


def smm_conv_packed(x: torch.Tensor, deltas: torch.Tensor,
                    entries: torch.Tensor, *, t_m: int, ro: int, co: int,
                    stride: int = 1, int8_weights: bool = False,
                    x_scale: torch.Tensor | None = None,
                    layer_scale: float = 1.0,
                    bias: torch.Tensor | None = None, relu: bool = False,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function on packed operands, by device: the plain
    version for CPU tensors (then, with ``x_scale``, the plain epilogue,
    into ``out`` where given), the CUDA instance that :func:`pick_impl`
    names otherwise (:func:`smm_conv_cuda`, whose epilogue operands these
    are)."""
    epi = _epilogue(x, deltas.shape[0] * t_m, ro, co, x_scale, layer_scale,
                    bias, relu, out)
    return _packed(x, deltas, entries, epi, int8_weights, t_m=t_m, ro=ro,
                   co=co, stride=stride)


def smm_conv_batched(x: torch.Tensor, code: LayerCode, *, stride: int = 1,
                     operands: tuple | None = None,
                     x_scale: torch.Tensor | None = None,
                     layer_scale: float = 1.0,
                     bias: torch.Tensor | None = None, relu: bool = False,
                     out: torch.Tensor | None = None,
                     raw_features: bool = False) -> torch.Tensor:
    """Batched CoDR SMM convolution: ``x`` (B, N, RI, CI) float32 →
    (B, M, RO, CO), int-exact, one launch for the whole batch.

    Pass ``operands`` (the ``(deltas, entries, meta)`` triple of
    :func:`smm_operands_on`, on ``x``'s device) to reuse a layer's packed
    operands across calls — the engine caches them per layer.

    With ``x_scale`` the layer's epilogue too (:func:`smm_conv_cuda`):
    the layer's output NHWC ``(B, RO, CO, M)``, NCHW storage, in ``out``
    (NCHW ``(B, M, RO, CO)``, a channel slice of a larger output is fine)
    or in a new tensor of M channels.  With ``raw_features`` ``x`` is the
    layer's raw float32 features, quantized against ``x_scale`` by the
    call (:func:`smm_conv_cuda`; on CPU tensors ``quantize_plain``
    first)."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    _, n_in, ri, ci = x.shape
    m = code.shape[0]
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    ro, co = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    if operands is None:
        operands = smm_operands_on(code, n_in, x.device)
    deltas, entries, meta = operands
    epi = _epilogue(x, deltas.shape[0] * meta["t_m"], ro, co, x_scale,
                    layer_scale, bias, relu, out, m, raw_features)
    y = _packed(x, deltas, entries, epi, meta.get("int8_weights", False),
                raw_features, t_m=meta["t_m"], ro=ro, co=co, stride=stride)
    return y if epi is not None else y[:, :m]


def smm_conv(x: torch.Tensor, code: LayerCode, *,
             stride: int = 1) -> torch.Tensor:
    """CoDR SMM convolution of one sample ``x`` (N, RI, CI) → (M, RO, CO)
    pre-activation int-exact accumulations (float32)."""
    return smm_conv_batched(x[None], code, stride=stride)[0]
