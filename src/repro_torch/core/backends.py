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

``tiled``        one ``F.conv2d`` / matmul per output-channel group of
                 each layer's decoded tile stack (any stride, float32
                 datapath, TF32 off)
``smm``          NumPy faithful MPE/APE execution on the host (integer
                 activations)
``smm_kernel``   the hand-written CUDA MPE/APE kernel
                 (:mod:`repro_torch.kernels.smm_conv`), whole batch in one
                 launch (integer activations)
``codr_matmul``  the hand-written CUDA fused decode+matmul kernel
                 (:mod:`repro_torch.kernels.codr_matmul`): linear layers,
                 and every packed projection of the transformer lane
``sharded``      the tiled datapath's groups partitioned over the
                 output-tile axis of a device mesh (:class:`ShardedBackend`),
                 bit for bit ``tiled``

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
import functools

import numpy as np
import torch

from repro_torch.core import smm
from repro_torch.core.spans import span

__all__ = [
    "Backend", "BackendCaps", "available_backends", "get_backend",
    "register", "resolve", "TiledBackend", "SmmBackend",
    "SmmKernelBackend", "CodrMatmulBackend", "ShardedBackend",
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
    float32(amax / 127) correctly rounded, round half to even, clip to
    ±127.  Returns the integer-valued float32 tensor and the scale; only
    two scalars reach the host (the ``codr.host_read`` spans).  The
    ``smm`` backend's feature path."""
    with span("codr.features"):
        x = x.to(torch.float32)
        amax = x.abs().max()
        exact = (x == torch.round(x)).all() & (amax <= 127)
        with span("codr.host_read", what="integer_test"):
            exact = bool(exact)
        if exact:
            return x, 1.0
        # a divisor on the device: with a host scalar CUDA multiplies by
        # its reciprocal, one unit in the last place off amax / 127
        scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                            1.0)
        q = torch.clamp(torch.round(x / scale), -127, 127)
        with span("codr.host_read", what="scale"):
            scale = float(scale)
        return q, scale


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

    def pool_nchw(self, pool, x: torch.Tensor) -> torch.Tensor:
        """One max pooling (:class:`~repro_torch.core.engine.MaxPool2D`)
        of NCHW ``x``.  Default: ``F.max_pool2d``."""
        return pool.pool_nchw(x)

    def module(self, model, mod, x: torch.Tensor) -> torch.Tensor:
        """Forward one branch module (:class:`~repro_torch.core.engine.
        BranchModule`) of ``model``.  Default: the float path, each branch
        in turn through :meth:`step`, the outputs concatenated."""
        return model.run_module(mod, x, self.step, self)

    def run_model(self, model, batch) -> torch.Tensor:
        """Forward a batch through a :class:`~repro_torch.core.engine.
        CodrModel`: moved to the model's device as float32, then its
        steps in turn, :meth:`step` a layer, :meth:`pool_nchw` a pooling
        and :meth:`module` a module."""
        return model._chain(model.as_input(batch), self.step, self)


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
    """Each layer's decoded tile stack as one ``F.conv2d`` / matmul per
    output-channel group (:func:`repro_torch.core.engine.channel_groups`:
    4 groups of whole tiles, or one tile each where a layer has fewer),
    float32 with TF32 off, concatenated over the channel axis (the
    counterpart of the reference's fused ``lax.conv``)."""

    name = "tiled"
    caps = BackendCaps(packed_matmul=True,
                       description="one F.conv2d/matmul per output-channel "
                                   "group of the decoded tile stack, any "
                                   "stride, float32 datapath (TF32 off)")

    def conv(self, layer, x):
        return layer(x)


class _IntFeatureBackend(Backend):  # codrlint: disable=capability-consistency — the abstract base of the smm and smm_kernel lanes, never registered itself
    """What the two lanes of the 8-bit feature path share: a conv layer is
    :meth:`features` (the features of its input, on the layer's zero
    border, and their scale) then :meth:`conv_int` (the convolution and
    the epilogue); a branch module makes each distinct input's features
    once.  Features are int8 (whole-number float32), or raw where the lane
    leaves their quantization to its convolution (``smm_kernel``).

    In a module (:meth:`module`): the module input's features are made
    once and shared by every branch that starts on them, a 1×1
    convolution's directly and a pooling branch's max-pooled (``x`` ≥ 0
    after a ReLU keeps its amax under the pooling, and rounding is
    monotone, so this equals quantizing the pooled tensor unless that
    tensor is whole numbers within ±127; and raw features pooled, then
    quantized at the module's scale, equal the quantized features pooled:
    max and the quantization are both monotone under one positive scale,
    and both keep a NaN); a later convolution of a branch makes its
    input's features onto its zero border; each branch's last epilogue
    writes its channel slice of the module's NCHW output, so nothing is
    concatenated."""

    @abc.abstractmethod
    def features(self, x: torch.Tensor, pad: int):
        """``(q, scale, raw)``: NHWC float ``x``'s features as NCHW on a
        zero border of ``pad`` pixels, their scale (one float32 on ``x``'s
        device) and ``raw``: False where ``q`` holds the int8 features
        (contiguous), True where it is ``x``'s own float32 values, which
        :meth:`conv_int` quantizes against ``scale``."""

    @abc.abstractmethod
    def conv_int(self, layer, q: torch.Tensor, scale, raw: bool,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """``layer`` on features ``(q, scale, raw)`` of :meth:`features`
        (border included): NHWC output, its epilogue applied, written
        into NCHW ``out`` (a channel slice) where given."""

    def conv(self, layer, x):
        return self.conv_int(layer, *self.features(x, layer.padding))

    def module(self, model, mod, x):
        ro, co = mod.out_hw(x.shape[1], x.shape[2])
        out = torch.empty(x.shape[0], mod.out_channels, ro, co,
                          dtype=torch.float32, device=x.device)
        shared = None                  # the module input's features
        c0 = 0
        for i, branch in enumerate(mod.branches):
            m = branch[-1].code.shape[0]
            with mod.branch_span(i):
                if shared is None:
                    shared = self.features(x, 0)
                h, feats = x, shared
                for k, s in enumerate(branch):
                    if s.kind == "pool" and feats is not None:
                        with span("codr.pool", window=s.window,
                                  stride=s.stride):
                            feats = (self.pool_nchw(s, feats[0]),
                                     *feats[1:])
                    elif s.kind == "pool":
                        h = model.run_pool(s, h, self)
                    else:
                        h = model.run_layer(s, h, functools.partial(
                            self._conv_on, feats=feats,
                            out=out[:, c0:c0 + m] if k == len(branch) - 1
                            else None))
                        feats = None
            c0 += m
        return out.permute(0, 2, 3, 1)

    def _conv_on(self, layer, x, feats, out):
        """``layer`` on the shared features ``feats`` (on the layer's
        border: a zero border of raw features quantizes to zero), or on
        ``x``'s own where there are none."""
        if feats is None:
            feats = self.features(x, layer.padding)
        elif layer.padding:
            feats = (torch.nn.functional.pad(feats[0], (layer.padding,) * 4),
                     *feats[1:])
        return self.conv_int(layer, *feats, out=out)


def _epilogue(layer) -> dict:
    """``layer``'s epilogue operands, as ``int8_features.ops.epilogue``
    and ``smm_conv_batched`` take them."""
    return dict(layer_scale=layer.scale,
                bias=None if layer.bias is None else layer.bias_device,
                relu=layer.activation == "relu")


class SmmBackend(_IntFeatureBackend):  # codrlint: disable=capability-consistency — 'smm' keys the port's own registry, separate from repro.core.backends'
    """Faithful MPE/APE execution model in NumPy on the host
    (:func:`repro_torch.core.smm.conv2d_smm_batched`), bit-exact in
    int64; the int8 features are the host path (:func:`_int_activations`,
    two reads a layer)."""

    name = "smm"
    caps = BackendCaps(integer_activations=True,
                       native_kinds=frozenset({"conv"}),
                       fallback_kinds=frozenset({"linear"}),
                       description="NumPy faithful MPE/APE execution "
                                   "(8-bit feature path, host)")

    def features(self, x, pad):
        """The host path's int8 features (never raw)."""
        xi, scale = _int_activations(x)
        q = xi.permute(0, 3, 1, 2)
        if pad:
            q = torch.nn.functional.pad(q, (pad,) * 4)
        return q.contiguous(), torch.tensor([scale], dtype=torch.float32,
                                            device=x.device), False

    def conv_int(self, layer, q, scale, raw, out=None):
        """The NumPy sums of the int8 features ``q`` (this lane's are never
        raw), then the ``int8_features`` epilogue on ``q``'s device."""
        from repro_torch.kernels.int8_features import ops as feats
        y = smm.conv2d_smm_batched(q.cpu().numpy().astype(np.int32),
                                   layer.code, layer.stride)
        y = torch.from_numpy(y).to(device=q.device, dtype=torch.float32)
        return feats.epilogue(y, scale, out=out, **_epilogue(layer))


class SmmKernelBackend(_IntFeatureBackend):  # codrlint: disable=capability-consistency — 'smm_kernel' keys the port's own registry, separate from repro.core.backends'
    """The CUDA MPE/APE kernel (:mod:`repro_torch.kernels.smm_conv`): the
    whole batch in one launch, operands packed once per layer and cached
    on it, around the ``int8_features`` kernels.  The kernels' wrappers
    run their plain versions on CPU tensors."""

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

    def features(self, x, pad):
        """The ``int8_features`` kernels.  Where ``x`` needs no border and
        is NCHW storage behind the NHWC view (a layer's output: the input
        of a block's later layers, of a module after the first) ``stats``
        alone, and ``x`` goes to ``smm_conv`` as raw features, which it
        quantizes itself (``sm90`` in its phase 1b); else ``stats``, then
        ``quantize_nhwc`` (NHWC-contiguous ``x``) or ``quantize_pad``
        onto the border.  The scale stays on the device and nothing is
        read back."""
        from repro_torch.kernels.int8_features import ops as feats
        with span("codr.features"):
            x = x.to(torch.float32)
            nchw = x.permute(0, 3, 1, 2)
            if not pad and nchw.is_contiguous():
                return nchw, feats.feature_scale(x), True
            return (*feats.int8_features(x, pad), False)

    def pool_nchw(self, pool, x):
        """The ``int8_features`` ``max_pool`` kernel (no indices)."""
        from repro_torch.kernels.int8_features import ops as feats
        return feats.max_pool(x, pool.window, pool.stride, pool.padding,
                              pool.ceil_mode)

    def conv_int(self, layer, q, scale, raw, out=None):
        """``smm_conv`` with the layer's epilogue, written into ``out``
        where given: on the ``sm90`` instance one launch that quantizes
        raw features in its phase 1b and applies the epilogue in its
        store, on ``simt`` (strided layers, weights outside int8) the
        ``int8_features`` quantize of raw features, ``smm_conv``, then
        the ``int8_features`` epilogue."""
        from repro_torch.kernels.smm_conv import ops as smm_ops
        return smm_ops.smm_conv_batched(
            q, layer.code, stride=layer.stride,
            operands=layer.smm_operands(), x_scale=scale, out=out,
            raw_features=raw, **_epilogue(layer))


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


class ShardedBackend(Backend):  # codrlint: disable=capability-consistency — 'sharded' keys the port's own registry, separate from repro.core.backends'
    """Tile-parallel scale-out executor: each layer's decoded tile stack
    is partitioned over the devices of a 1-D mesh along the **output-tile
    axis** — the CoDR loop nest's model-parallel dimension, since every
    output-channel tile's results are produced exactly once (output
    stationary) while the input is broadcast to all tiles (paper
    §III-B).

    * The layer's output-channel groups (``layer.groups_device``: a
      fixed run of whole tiles each, set by the layer's shape alone) are
      zero-padded to a multiple of the device count and placed once, a
      contiguous run of groups on each device; where a device is the
      layer's own, the layer's group tensors themselves are used.
    * Each group runs the same ``F.conv2d`` / matmul as in ``tiled`` (the
      same weight shape and kind of tensor, the same NHWC input, float32
      with TF32 off) on its device; the outputs are gathered to the
      first device in group order and concatenated over the channel
      axis, with no collective between the devices.
    * Pad channels are cropped and the scale / bias / activation
      epilogue runs on the gathered output.  Every output channel thus
      comes from the same call with the same arguments as in ``tiled``,
      so the result is ``tiled``'s bit for bit at every mesh size,
      whichever algorithm the library picks for a call.

    Per-layer shard state is cached on the layer, keyed on the mesh, and
    so is the whole-chain state in :meth:`run_model`; a new mesh
    re-shards.  ``run_model`` chains the layers eagerly, the counterpart
    of the reference's ``jax.jit`` chain.

    Constructor args:
        ``mesh``: a 1-D tuple of devices (:func:`~repro_torch.sharding.
        rules.tile_mesh`; repeats allowed).  ``None`` (default) takes the
        default mesh of the model's device: every card for a model on
        the card, ``(cpu,)`` for a model on the CPU.  Pass an explicit
        mesh to pin the executor:
        ``register(ShardedBackend(mesh, name="..."))``.
    """

    name = "sharded"
    caps = BackendCaps(packed_matmul=True,
                       description="tile-parallel dispatch over the "
                                   "output-tile axis of a device mesh, any "
                                   "stride, float32 datapath (TF32 off), "
                                   "1-device fallback")

    # fault-injection hook (class attr: zero cost until installed; see
    # repro_torch.runtime.resilience — site "sharded.dispatch")
    _injector = None

    def __init__(self, mesh=None, *, name: str | None = None):
        self._mesh = None if mesh is None else tuple(mesh)
        if name is not None:
            self.name = name

    def set_fault_injector(self, injector) -> "ShardedBackend":
        """Install (or clear, with ``None``) a ``FaultInjector`` firing
        the ``"sharded.dispatch"`` site on every whole-model dispatch —
        the hook chaos runs use to simulate a lost mesh device."""
        self._injector = injector
        return self

    def mesh_for(self, device=None) -> tuple:
        """The mesh this backend runs a model on ``device`` over: the
        explicit one, else the default mesh of ``device`` (``None``: the
        card)."""
        if self._mesh is not None:
            return self._mesh
        from repro_torch.sharding import rules
        return rules.tile_mesh(device=device)

    @property
    def mesh(self) -> tuple:
        return self.mesh_for(None)

    @property
    def n_devices(self) -> int:
        return len(self.mesh)

    # -- per-layer preparation ---------------------------------------------
    def _prepare(self, layer, mesh: tuple) -> dict:
        """Place ``layer``'s output-channel groups over ``mesh`` (once per
        layer per mesh), cached on the layer: repeat dispatches reuse the
        placed groups.  ``state["weights"][i]`` is device i's run of
        groups."""
        state = getattr(layer, "_shard_state", None)
        if state is not None and state["mesh"] == mesh:
            return state
        from repro_torch.sharding import rules
        groups = list(layer.groups_device)
        n = rules.pad_to_multiple(len(groups), len(mesh))
        groups += [torch.zeros_like(groups[0])] * (n - len(groups))
        per = n // len(mesh)
        # .to() returns the layer's own tensor where the device is its own
        weights = [[g.to(dev) for g in groups[i * per:(i + 1) * per]]
                   for i, dev in enumerate(mesh)]
        bias = (None if layer.bias is None
                else torch.from_numpy(layer.bias).to(mesh[0]))
        state = {"mesh": mesh, "weights": weights, "bias": bias}
        layer._shard_state = state
        return state

    # -- execution ----------------------------------------------------------
    def conv(self, layer, x):
        state = self._prepare(layer, self.mesh_for(layer.device))
        first = state["mesh"][0]
        ys = []
        for dev, ws in zip(state["mesh"], state["weights"]):
            xd = x.to(dev)
            ys += [layer._local(xd, w).to(first) for w in ws]
        y = torch.cat(ys, dim=-1)[..., : layer.code.shape[0]] * layer.scale
        if state["bias"] is not None:
            y = y + state["bias"]
        return torch.relu(y) if layer.activation == "relu" else y

    linear = conv

    def run_model(self, model, batch):
        if self._injector is not None:
            self._injector.fire("sharded.dispatch")
        mesh = self.mesh_for(model.device)
        state = getattr(model, "_run_sharded", None)
        if state is None or state != mesh:
            for layer in model.layers:
                self._prepare(layer, mesh)
            model._run_sharded = mesh
        return super().run_model(model, batch)


register(TiledBackend())
register(SmmBackend())
register(SmmKernelBackend())
register(CodrMatmulBackend())
register(ShardedBackend())
