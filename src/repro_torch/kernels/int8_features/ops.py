"""Wrapper and launch counters of the ``smm_kernel`` lane's 8-bit feature
path and epilogue (``csrc/int8_features.cu``).

Source note.  These kernels replace no Pallas kernel: in the JAX package
the feature path and the epilogue are host code around ``smm_conv``
(``repro.core.backends._int_activations`` and ``_finish``).  On the card
they ran as some ten torch elementwise ops a layer and two scalar reads
back to the host.  Here they are three launches a layer around
``smm_conv``, and the scale never leaves the device:

* :func:`int8_features` — :func:`feature_scale`, the ``stats`` kernel
  (one pass: max |x| and the integer test into a per-stream accumulator,
  turned into the scale by the last block, which leaves the accumulator
  zero for the next launch), then :func:`quantize`, the ``quantize``
  kernel (one pass: the int8 features in the NCHW layout ``smm_conv``
  takes; ``quantize_nhwc`` where ``x`` is NHWC-contiguous, a transpose
  through shared memory; ``quantize_pad`` where the next convolution
  pads: the interior of a plane with a zero border, border written too).
  Where a layer's input is a layer's output with no border, the
  ``smm_kernel`` lane launches :func:`feature_scale` alone and hands
  ``smm_conv`` the raw features, whose ``sm90`` instance quantizes them
  in its phase 1b with the same numbers (``csrc/feature_quant.cuh``);
* :func:`max_pool` — the lane's max pooling of NCHW storage (a module's
  int8 features, the poolings between modules), no indices: the
  ``max_pool`` kernel, a block a few planes staged in shared memory;
* :func:`epilogue` — ``smm_conv``'s output times the layer's scale times
  the device scale, bias, ReLU, returned as the NHWC view of NCHW storage
  that the engine chain hands on, or written into a channel slice of a
  larger NCHW output (a branch's part of a concatenation).

All three are bound by bytes: each reads its float32 input once and
writes its output once.  The numbers are the plain versions' (:mod:`.ref`),
bit for bit.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernels or raises.  :data:`launches` counts kernel launches, and only
those; :data:`launches_by_impl` splits the same count by kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.dataflow import pool_out
from repro_torch.kernels import _build
from repro_torch.kernels.int8_features.ref import (epilogue_plain,
                                                   feature_scale_plain,
                                                   max_pool_plain,
                                                   quantize_plain)

__all__ = ["IMPLS", "SOURCE", "launches", "launches_by_impl", "load_kernel",
           "feature_scale", "quantize", "int8_features", "max_pool",
           "epilogue", "check_epilogue", "channels_an_image"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "int8_features.cu"
IMPLS = ("stats", "quantize", "quantize_nhwc", "quantize_pad", "max_pool",
         "epilogue")
# blocks of 256 threads an SM for the grid-stride passes (2048 threads)
_BLOCKS_PER_SM = 8
_GRID_YZ = 65535

launches = 0          # kernel launches since the count was last set to 0
launches_by_impl = dict.fromkeys(IMPLS, 0)   # the same count, by kernel


@functools.cache
def load_kernel():
    """Build (at first use) and load the library; returns it."""
    lib = _build.load_library(SOURCE)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.int8_features_stats_launch.argtypes = [vp, ll, vp, vp, i, vp]
    lib.int8_features_quantize_launch.argtypes = [vp, vp, vp, ll, ll, i, i,
                                                  i, vp]
    lib.int8_features_quantize_pad_launch.argtypes = [vp, vp, vp, ll, i, i,
                                                      i, vp]
    lib.int8_features_max_pool_launch.argtypes = [vp, vp, ll] + [i] * 8 + [
        vp]
    lib.int8_features_epilogue_launch.argtypes = [vp, vp, ctypes.c_double, vp,
                                                  i, vp, ll, i, i, i, ll, vp]
    for fn in (lib.int8_features_stats_launch,
               lib.int8_features_quantize_launch,
               lib.int8_features_quantize_pad_launch,
               lib.int8_features_max_pool_launch,
               lib.int8_features_epilogue_launch):
        fn.restype = ctypes.c_int
    lib.int8_features_error_string.argtypes = [ctypes.c_int]
    lib.int8_features_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _max_blocks(device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * _BLOCKS_PER_SM


# The stats accumulator, three uint32 words per (device, stream)
# (:func:`_build.stream_buffer`): made zero once and left zero by every
# launch.
_acc: dict[tuple, torch.Tensor] = {}


def _launched(impl: str, err: int) -> None:
    global launches
    if err != 0:
        what = load_kernel().int8_features_error_string(err).decode()
        raise RuntimeError(f"int8_features ({impl}) launch failed: CUDA "
                           f"error {err} ({what})")
    launches += 1
    launches_by_impl[impl] += 1


def _check_x(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"x must be torch.float32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D NHWC, got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"x is empty: shape {tuple(x.shape)}")


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one; raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_features needs CPU or CUDA tensors, got "
                         f"one on {t.device}")
    return t.device.type == "cpu"


def _dense(x: torch.Tensor) -> bool:
    """``x`` NHWC-contiguous or NCHW storage behind the NHWC view: either
    way its elements fill their storage, which ``stats`` reads flat."""
    return x.is_contiguous() or x.permute(0, 3, 1, 2).is_contiguous()


def feature_scale(x: torch.Tensor) -> torch.Tensor:
    """The ``stats`` kernel: the scale of NHWC float32 features ``x`` (any
    strides whose storage is dense), a one-element float32 tensor on
    ``x``'s device (:func:`.ref.feature_scale_plain`'s numbers).  One
    launch on a CUDA tensor, no host sync."""
    _check_x(x)
    if _on_cpu(x):
        return feature_scale_plain(x)
    if not _dense(x):
        x = x.contiguous()
    stream = _build.stream_handle(x.device)
    scale = torch.empty(1, dtype=torch.float32, device=x.device)
    acc = _build.stream_buffer(_acc, x.device, stream, 4, torch.int32)
    _launched("stats", load_kernel().int8_features_stats_launch(
        x.data_ptr(), x.numel(), acc.data_ptr(), scale.data_ptr(),
        _max_blocks(x.device.index), stream))
    return scale


def quantize(x: torch.Tensor, scale: torch.Tensor, pad: int = 0
             ) -> torch.Tensor:
    """The ``quantize`` kernels: ``clamp(rint(x / scale), -127, 127)`` of
    NHWC float32 ``x`` as contiguous NCHW ``(B, C, H + 2 pad, W + 2 pad)``,
    on a zero border of ``pad`` pixels (:func:`.ref.quantize_plain`'s
    numbers).  ``quantize`` where ``x`` is NCHW storage behind an NHWC
    view, ``quantize_nhwc`` (a transpose through shared memory) where it
    is NHWC-contiguous, ``quantize_pad`` wherever ``pad`` > 0 (from NCHW
    storage); other strides are copied first.  One launch on a CUDA
    tensor."""
    _check_x(x)
    if scale.device != x.device or scale.dtype != torch.float32 \
            or scale.shape != (1,):
        raise ValueError(f"scale must be one float32 on {x.device}, got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    if _on_cpu(x):
        return quantize_plain(x, scale, pad)
    b, h, w, c = x.shape
    stream = _build.stream_handle(x.device)
    if pad:
        if not x.permute(0, 3, 1, 2).is_contiguous():
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        q = torch.empty(b, c, h + 2 * pad, w + 2 * pad, dtype=torch.float32,
                        device=x.device)
        _launched("quantize_pad",
                  load_kernel().int8_features_quantize_pad_launch(
                      x.data_ptr(), scale.data_ptr(), q.data_ptr(), b * c, h,
                      w, pad, stream))
        return q
    nchw = x.permute(0, 3, 1, 2).is_contiguous()
    if not nchw and not x.is_contiguous():
        x = x.contiguous()
    if not nchw and (b > _GRID_YZ or -(-c // 32) > _GRID_YZ):
        raise ValueError(f"batch {b} and channels {c} too large for the "
                         f"NHWC transpose")
    q = torch.empty(b, c, h, w, dtype=torch.float32, device=x.device)
    _launched("quantize" if nchw else "quantize_nhwc",
              load_kernel().int8_features_quantize_launch(
                  x.data_ptr(), scale.data_ptr(), q.data_ptr(), b, h * w, c,
                  int(not nchw), _max_blocks(x.device.index), stream))
    return q


def int8_features(x: torch.Tensor, pad: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 8-bit feature path: ``x`` NHWC ``(B, H, W, C)`` float32 →
    ``(q, scale)``, ``q`` the integer-valued float32 features as
    contiguous NCHW ``(B, C, H + 2 pad, W + 2 pad)`` on a zero border of
    ``pad`` pixels and ``scale`` a one-element float32 tensor on ``x``'s
    device (:func:`.ref.int8_features_plain`'s numbers; the border changes
    neither): :func:`feature_scale`, then :func:`quantize`.  On a CUDA
    tensor two launches and no host sync."""
    scale = feature_scale(x)
    return quantize(x, scale, pad), scale


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """Max pooling of NCHW float32 ``x`` (any strides; NCHW storage is
    read as it is, other strides are copied first) → contiguous NCHW, as
    ``F.max_pool2d`` (:func:`.ref.max_pool_plain`'s numbers: a max is
    exact).  One launch on a CUDA tensor."""
    if x.dtype != torch.float32 or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be non-empty 4-D torch.float32, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if window < 1 or stride < 1 or not 0 <= padding <= window // 2:
        raise ValueError(f"window {window}, stride {stride}, padding "
                         f"{padding} (at most half the window)")
    if _on_cpu(x):
        return max_pool_plain(x, window, stride, padding, ceil_mode)
    b, c, h, w = x.shape
    x = x.contiguous()
    ho, wo = (pool_out(n, window, stride, padding, ceil_mode)
              for n in (h, w))
    out = torch.empty(b, c, ho, wo, dtype=torch.float32, device=x.device)
    stream = _build.stream_handle(x.device)
    _launched("max_pool", load_kernel().int8_features_max_pool_launch(
        x.data_ptr(), out.data_ptr(), b * c, h, w, ho, wo, window, stride,
        padding, _max_blocks(x.device.index), stream))
    return out


def epilogue(y: torch.Tensor, x_scale: torch.Tensor, layer_scale: float,
             bias: torch.Tensor | None = None, *, relu: bool = False,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """``smm_conv``'s accumulators ``y`` NCHW ``(B, M, RO, CO)`` (a channel
    slice of a padded output is fine) → the layer's output NHWC ``(B, RO,
    CO, M)``, NCHW storage: ``y · float32(layer_scale · x_scale)``
    (+ ``bias``, ``(M,)`` float32), ReLU if ``relu``
    (:func:`.ref.epilogue_plain`'s numbers).  ``out``, NCHW ``(B, M, RO,
    CO)`` with whole channel planes (a channel slice of a larger output),
    takes the result in place of a new tensor.  One launch on a CUDA
    tensor."""
    if y.dtype != torch.float32 or y.dim() != 4:
        raise ValueError(f"y must be 4-D torch.float32, got {y.dtype} of "
                         f"shape {tuple(y.shape)}")
    b, m, ro, co = y.shape
    check_epilogue(tuple(y.shape), y.device, x_scale, bias, out)
    if _on_cpu(y):
        res = epilogue_plain(y, x_scale, layer_scale, bias, relu)
        if out is None:
            return res
        out.copy_(res.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)
    p = ro * co
    m_in, m_out = (channels_an_image("y", y, m, p),
                   m if out is None else channels_an_image("out", out, m, p))
    if out is None:
        out = torch.empty(b, m, ro, co, dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out.permute(0, 2, 3, 1)
    stream = _build.stream_handle(y.device)
    _launched("epilogue", load_kernel().int8_features_epilogue_launch(
        y.data_ptr(), x_scale.data_ptr(), float(layer_scale),
        None if bias is None else bias.contiguous().data_ptr(),
        int(bool(relu)), out.data_ptr(), b, m, m_in, m_out, p, stream))
    return out.permute(0, 2, 3, 1)


def check_epilogue(shape: tuple, device: torch.device,
                   x_scale: torch.Tensor, bias: torch.Tensor | None,
                   out: torch.Tensor | None) -> None:
    """Raise unless the epilogue's operands fit accumulators ``y`` of NCHW
    ``shape`` ``(B, M, RO, CO)`` on ``device``: ``x_scale`` one float32,
    ``bias`` ``(M,)`` float32 or None, ``out`` float32 of ``shape`` or
    None, all on ``device`` (:func:`epilogue`'s checks, which
    ``smm_conv``'s fused call makes too)."""
    m = shape[1]
    checks = [("x_scale", x_scale, 1)] + ([] if bias is None
                                          else [("bias", bias, m)])
    for name, t, n in checks:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, y on {device}")
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be torch.float32 of shape "
                             f"({n},), got {t.dtype} {tuple(t.shape)}")
    if out is not None and (out.dtype != torch.float32
                            or out.shape != shape or out.device != device):
        raise ValueError(f"out must be torch.float32 of shape "
                         f"{tuple(shape)} on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


def channels_an_image(name: str, t: torch.Tensor, m: int, p: int) -> int:
    """The channels a batch stride of NCHW ``t`` spans (``m`` where the
    batch has one image); raises unless its channel planes are whole."""
    b, _, _, co = t.shape
    if t.numel() == 0:
        return m
    m_img = t.stride(0) // p if b > 1 else m
    if t.stride()[1:] != (p, co, 1) or (b > 1 and (t.stride(0) % p
                                                   or m_img < m)):
        raise ValueError(f"{name} must be NCHW with whole channel planes, "
                         f"got strides {t.stride()}")
    return m_img
