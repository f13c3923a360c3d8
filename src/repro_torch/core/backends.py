"""Pluggable execution backends for the port's CoDR engine (the CNN half
of ``repro.core.backends``).

* :class:`BackendCaps` — declarative capability flags (stride support,
  integer-activation requirement, which layer kinds execute natively).
  Kernel facts live next to the kernels (``KERNEL_CAPS`` in
  ``repro_torch.kernels.*.ops``) and are read here.
* :class:`Backend` — the protocol: ``conv(layer, x)`` / ``linear(layer,
  x)`` steps plus ``run_model(model, x)`` chaining, with ``supports``
  answering *can this backend execute that layer, and if not, why not*.
* a **registry** — :func:`register` / :func:`get_backend` /
  :func:`available_backends` / :func:`resolve`.

Built-ins registered at import:

``tiled``        one ``F.conv2d`` / matmul per layer over the decoded
                 tile stack (any stride, float32 datapath, TF32 off)
``smm``          NumPy faithful MPE/APE execution on the host (integer
                 activations)
``smm_kernel``   the hand-written CUDA MPE/APE kernel
                 (:mod:`repro_torch.kernels.smm_conv`), whole batch in one
                 launch (integer activations)
``codr_matmul``  the hand-written CUDA fused decode+matmul kernel
                 (:mod:`repro_torch.kernels.codr_matmul`): linear layers,
                 and every packed projection of the transformer lane

The transformer lane enters through :meth:`Backend.matmul` /
:meth:`Backend.gather` / :meth:`Backend.unembed`, which
``repro_torch.models.common`` calls on packed params leaves.

Layers are duck-typed (:class:`repro_torch.core.engine.CodrConv2D` /
``CodrLinear``); activations are NHWC torch tensors on the model's
device.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.core import smm

__all__ = [
    "Backend", "BackendCaps", "available_backends", "get_backend",
    "register", "resolve", "TiledBackend", "SmmBackend",
    "SmmKernelBackend", "CodrMatmulBackend",
]


# ---------------------------------------------------------------------------
# capabilities
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendCaps:
    """What a backend can execute, declaratively.

    ``max_stride``           ``None`` = any stride.
    ``integer_activations``  the backend runs the 8-bit feature datapath:
                             integer-valued inputs execute exactly,
                             anything else is int8-quantized first.
    ``native_kinds``         layer kinds the backend executes itself.
    ``fallback_kinds``       kinds delegated to the layer's own tiled
                             forward (empty = unsupported kinds error).
    ``packed_matmul``        the backend can execute a packed projection
                             leaf (:meth:`Backend.matmul`); gates
                             ``compile_params``.
    """

    max_stride: int | None = None
    integer_activations: bool = False
    native_kinds: frozenset = frozenset({"conv", "linear"})
    fallback_kinds: frozenset = frozenset()
    packed_matmul: bool = False
    description: str = ""

    def supports_stride(self, stride: int) -> bool:
        return self.max_stride is None or stride <= self.max_stride

    def supports_kind(self, kind: str) -> bool:
        return kind in self.native_kinds or kind in self.fallback_kinds


# ---------------------------------------------------------------------------
# backend protocol
# ---------------------------------------------------------------------------

def _finish(layer, y: torch.Tensor) -> torch.Tensor:
    """Shared epilogue: bias + activation (what every datapath appends
    after its accumulators drain)."""
    if layer.bias is not None:
        y = y + layer.bias_device
    return torch.relu(y) if layer.activation == "relu" else y


def _int_activations(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    """The accelerator's 8-bit feature path, on ``x``'s device: integer-
    valued inputs within int8 range pass through exactly; anything else
    is symmetric int8-quantized (its scale folds into the output).

    The numbers are ``repro.core.backends._int_activations``': scale =
    float32(amax / 127), round half to even, clip to ±127.  Returns the
    integer-valued float32 tensor and the scale; only two scalars reach
    the host."""
    x = x.to(torch.float32)
    amax = x.abs().max()
    if bool((x == torch.round(x)).all() & (amax <= 127)):
        return x, 1.0
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q, float(scale)


class Backend(abc.ABC):
    """One way to execute CoDR layers.

    * Subclasses MUST set a non-empty ``name`` (the registry key), a
      ``caps`` :class:`BackendCaps`, and implement :meth:`conv`.
      :meth:`linear` defaults to the layer's own tiled matmul (declare
      ``"linear"`` in ``caps.fallback_kinds`` when relying on that).
    * Callers gate on :meth:`supports` / :meth:`supports_model` before
      executing — ``compile`` and ``CompiledModel.run(backend=...)`` do.
    * Every datapath ends with :meth:`finish` (bias, then activation).
      Integer-activation backends quantize non-integer inputs to int8
      first.
    """

    name: str = ""
    caps: BackendCaps = BackendCaps()

    # -- capability queries -------------------------------------------------
    def supports(self, layer) -> tuple[bool, str]:
        """``(ok, reason)`` — can this backend execute ``layer``?  Reports,
        never raises."""
        if not self.caps.supports_kind(layer.kind):
            return False, (f"backend {self.name!r} has no {layer.kind!r} "
                           f"path (native: {sorted(self.caps.native_kinds)})")
        stride = getattr(layer, "stride", 1)
        if layer.kind == "conv" and not self.caps.supports_stride(stride):
            return False, (f"backend {self.name!r} supports stride <= "
                           f"{self.caps.max_stride}, layer {layer.name!r} "
                           f"has stride {stride}")
        return True, ""

    def supports_model(self, layers) -> tuple[bool, str]:
        """``(ok, reason)`` over a whole layer stack: the first failing
        layer's reason, or ``(True, "")``."""
        for layer in layers:
            ok, reason = self.supports(layer)
            if not ok:
                return False, reason
        return True, ""

    # -- execution ----------------------------------------------------------
    @abc.abstractmethod
    def conv(self, layer, x: torch.Tensor) -> torch.Tensor:
        """Forward one conv layer from its code: NHWC ``(B, RI, CI, N)`` →
        NHWC ``(B, RO, CO, M)`` float32, VALID padding, the layer's
        stride, scale, bias and activation applied."""

    def linear(self, layer, x: torch.Tensor) -> torch.Tensor:
        """Forward one linear layer, ``(B, N)`` → ``(B, M)``.  Default:
        the layer's own tiled matmul (the ``fallback_kinds`` path)."""
        return layer(x)

    def step(self, layer, x: torch.Tensor) -> torch.Tensor:
        """Dispatch one layer by ``layer.kind``."""
        if layer.kind == "conv":
            return self.conv(layer, x)
        if layer.kind == "linear":
            return self.linear(layer, x)
        raise ValueError(f"unknown layer kind {layer.kind!r}")

    def finish(self, layer, y: torch.Tensor) -> torch.Tensor:
        """The shared epilogue: ``+ bias`` (if any), then the activation."""
        return _finish(layer, y)

    def matmul(self, x: torch.Tensor, w) -> torch.Tensor:
        """Execute one packed projection leaf
        (:class:`repro_torch.core.codr_linear.PackedLinear`):
        ``(..., K) @ dequantize(w) → (..., out_features)`` in ``x``'s
        dtype.  The default is decode-then-matmul with exactly the dense
        ``linear`` numerics (the float32 dequantized weight cast to
        ``x.dtype``, then the product), so ``tiled`` serves logits
        bit-for-bit equal to the quantize-applied dense params.  Only
        meaningful when ``caps.packed_matmul`` is set."""
        return torch.matmul(x, w.dense().to(x.dtype))

    def gather(self, tokens: torch.Tensor, w) -> torch.Tensor:
        """Embedding lookup on a packed vocabulary table
        (:class:`repro_torch.core.codr_linear.PackedEmbedding`): gather
        the packed rows for ``tokens`` and decode only those — bit-for-bit
        equal to indexing the quantize-applied dense table."""
        return w.lookup(tokens)

    def unembed(self, x: torch.Tensor, w) -> torch.Tensor:
        """Logit projection ``x @ dense(w).T`` against a packed output
        embedding, with the dense ``unembed`` numerics."""
        return torch.matmul(x, w.dense().to(x.dtype).T)

    def run_model(self, model, batch) -> torch.Tensor:
        """Forward a batch through a :class:`~repro_torch.core.engine.
        CodrModel`: moved to the model's device as float32, then
        :meth:`step` chained over the layers."""
        return model._chain(model.as_input(batch), self.step)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Backend] = {}


def register(backend: Backend, *, overwrite: bool = False) -> Backend:
    """Add a backend instance to the registry (name taken from it)."""
    if not backend.name:
        raise ValueError("backend must set a non-empty .name")
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> tuple[str, ...]:
    """Registered backend names, registration order."""
    return tuple(_REGISTRY)


def get_backend(name: str) -> Backend:
    """Look up a registered backend; ``ValueError`` naming the
    registered alternatives on a miss."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{', '.join(_REGISTRY) or '(none)'}") from None


def resolve(backend: str | Backend) -> Backend:
    """Accept a registered name or a Backend instance."""
    if isinstance(backend, Backend):
        return backend
    return get_backend(backend)


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

# The backend names below are the registry keys of this package's own
# registry; repro.core.backends keeps a separate registry with the same
# names, which is what lets the two packages be compared name for name.

class TiledBackend(Backend):  # codrlint: disable=capability-consistency — 'tiled' keys the port's own registry, separate from repro.core.backends'
    """Each layer's decoded tile stack as one ``F.conv2d`` / matmul, float32
    with TF32 off (the counterpart of the reference's fused ``lax.conv``)."""

    name = "tiled"
    caps = BackendCaps(packed_matmul=True,
                       description="one F.conv2d/matmul per layer over the "
                                   "decoded tile stack, any stride, float32 "
                                   "datapath (TF32 off)")

    def conv(self, layer, x):
        return layer(x)


class SmmBackend(Backend):  # codrlint: disable=capability-consistency — 'smm' keys the port's own registry, separate from repro.core.backends'
    """Faithful MPE/APE execution model in NumPy on the host
    (:func:`repro_torch.core.smm.conv2d_smm_batched`), bit-exact in
    int64."""

    name = "smm"
    caps = BackendCaps(integer_activations=True,
                       native_kinds=frozenset({"conv"}),
                       fallback_kinds=frozenset({"linear"}),
                       description="NumPy faithful MPE/APE execution "
                                   "(8-bit feature path, host)")

    def conv(self, layer, x):
        xi, x_scale = _int_activations(x)
        scale = float(np.asarray(layer.code.scale)) * x_scale
        xi = xi.permute(0, 3, 1, 2).cpu().numpy().astype(np.int32)
        outs = smm.conv2d_smm_batched(xi, layer.code, layer.stride)
        y = torch.from_numpy(np.moveaxis(outs, 1, 3)).to(
            device=x.device, dtype=torch.float32)
        return _finish(layer, y * scale)


class SmmKernelBackend(Backend):  # codrlint: disable=capability-consistency — 'smm_kernel' keys the port's own registry, separate from repro.core.backends'
    """The CUDA MPE/APE kernel (:mod:`repro_torch.kernels.smm_conv`): the
    whole batch in one launch, operands packed once per layer and cached
    on it.  On CPU tensors the kernel's plain version runs instead."""

    name = "smm_kernel"
    _caps: BackendCaps | None = None

    @property
    def caps(self) -> BackendCaps:
        if self._caps is None:
            from repro_torch.kernels.smm_conv import ops as smm_ops
            kc = smm_ops.KERNEL_CAPS
            self._caps = BackendCaps(
                integer_activations=kc["integer_activations"],
                max_stride=kc["max_stride"],
                native_kinds=frozenset(kc["kinds"]),
                # linear layers fall back to the tiled matmul — a backend
                # policy, not a kernel fact
                fallback_kinds=frozenset({"linear"}),
                description=kc["description"])
        return self._caps

    def conv(self, layer, x):
        from repro_torch.kernels.smm_conv import smm_conv_batched
        xi, x_scale = _int_activations(x)
        scale = float(np.asarray(layer.code.scale)) * x_scale
        y = smm_conv_batched(xi.permute(0, 3, 1, 2).contiguous(), layer.code,
                             stride=layer.stride,
                             operands=layer.smm_operands())
        return _finish(layer, y.permute(0, 2, 3, 1) * scale)


class CodrMatmulBackend(Backend):  # codrlint: disable=capability-consistency — 'codr_matmul' keys the port's own registry, separate from repro.core.backends'
    """The CUDA fused decode+matmul kernel
    (:mod:`repro_torch.kernels.codr_matmul`): linear layers and packed
    projections execute from the fixed-width unique-index pack.
    Linear-only — a model with conv layers is rejected at compile time
    via :meth:`supports`.  On CPU tensors the kernel's plain version runs
    instead."""

    name = "codr_matmul"
    _caps: BackendCaps | None = None

    @property
    def caps(self) -> BackendCaps:
        if self._caps is None:
            from repro_torch.kernels.codr_matmul import ops as mm_ops
            kc = mm_ops.KERNEL_CAPS
            self._caps = BackendCaps(
                native_kinds=frozenset(kc["kinds"]),
                integer_activations=kc["integer_activations"],
                packed_matmul=kc.get("packed_matmul", False),
                description=kc["description"])
        return self._caps

    def conv(self, layer, x):                      # pragma: no cover
        raise NotImplementedError("codr_matmul is linear-only")

    def matmul(self, x, w):
        """Fused decode+matmul from the packed words, float32 activations
        and accumulation, cropped to ``out_features`` and cast back to
        ``x``'s dtype.  One matrix at a time: the layer loop slices a
        stacked pack first."""
        from repro_torch.kernels.codr_matmul import codr_matmul
        if w.weight.packed.dim() != 2:
            raise ValueError(
                "codr_matmul executes per-matrix packed operands; got a "
                f"stacked pack of shape {tuple(w.weight.packed.shape)} — "
                "slice the stack axis (w[i]) or decode via dense_weight() "
                "first")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
        y = codr_matmul(x2, w.weight)[:, : w.out_features]
        return y.reshape(*lead, w.out_features).to(x.dtype)

    def linear(self, layer, x):
        from repro_torch.core.codr_linear import pack_unique
        from repro_torch.kernels.codr_matmul import codr_matmul
        packed = getattr(layer, "_mm_packed", None)
        if packed is None:
            # decoded (M, N) int8 → (K=N_in, N=M_out) pack; M_out padded
            # to a multiple of 32, which every per-word width divides,
            # and the extra columns cropped after the matmul
            q = layer.decoded_weights().T            # (N_in, M_out) int8
            pad = (-q.shape[1]) % 32
            if pad:
                q = np.pad(q, ((0, 0), (0, pad)))
            packed = pack_unique(
                torch.from_numpy(np.ascontiguousarray(q)).to(layer.device),
                float(np.asarray(layer.code.scale)), dtype=torch.float32)
            layer._mm_packed = packed
        m = layer.code.shape[0]
        y = codr_matmul(x.to(torch.float32).contiguous(), packed)[:, :m]
        return _finish(layer, y)


register(TiledBackend())
register(SmmBackend())
register(SmmKernelBackend())
register(CodrMatmulBackend())
