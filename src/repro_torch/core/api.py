"""Spec → compile → run: the port's CoDR engine API — the CNN lane and
the transformer lane of ``repro.core.api``.

1. :class:`ModelSpec` — a declarative sequence of steps: layers from raw
   arrays (:meth:`LayerSpec.conv`, VALID or zero-padded, /
   :meth:`LayerSpec.dense`), max poolings (:class:`PoolSpec`) and branch
   modules (:class:`ModuleSpec`, an inception module); from the paper
   CNNs' geometry (:meth:`ModelSpec.from_shapes`,
   :meth:`ModelSpec.from_paper_cnn`), or from any conv/dense params tree
   (:meth:`ModelSpec.from_params`).  No encoding happens here.
2. :class:`EncodeConfig` — every offline-encoder knob in one place.
3. :func:`compile` — runs the offline pipeline exactly once and returns
   a :class:`CompiledModel` living on one torch device (the card unless
   the caller passes ``device="cpu"``): ``.run`` from the bitstreams,
   ``.reference`` / ``.quantized_reference`` oracles, ``.stats`` /
   ``.sram_report`` accounting.
4. :func:`compile_params` — the transformer lane: a params tree of
   :mod:`repro_torch.models` with every projection leaf replaced by its
   packed form, served through the backend registry.

Import as ``repro_torch.api``::

    import repro_torch.api as codr

    spec = codr.ModelSpec.from_params(params)
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel")
    y = compiled.run(x)                             # NHWC, on the card
"""
from __future__ import annotations

import dataclasses
import re as _re
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import backends as _backends
from repro_torch.core import engine as _engine
from repro_torch.core.engine import resolve_device
from repro_torch.core.spans import span

__all__ = [
    "LayerSpec", "PoolSpec", "ModuleSpec", "ModelSpec", "EncodeConfig",
    "CompiledModel", "compile",
    "PACK_INCLUDE", "EMBED_INCLUDE", "CompiledParams", "compile_params",
]


# ---------------------------------------------------------------------------
# stage 1: the declarative spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class LayerSpec:
    """One declarative layer: float weights + geometry, nothing encoded.

    ``kind="conv"``   → ``weight`` is OIHW ``(M, N, RK, CK)``; ``padding``
                        zero pixels each side of its input (0: VALID).
    ``kind="linear"`` → ``weight`` is ``(M, N)`` = (out, in features).
    """

    kind: str
    weight: np.ndarray
    bias: np.ndarray | None = None
    stride: int = 1
    activation: str | None = None
    name: str = ""
    padding: int = 0

    def __post_init__(self):
        w = np.asarray(self.weight, dtype=np.float32)
        object.__setattr__(self, "weight", w)
        if self.kind not in ("conv", "linear"):
            raise ValueError(f"kind must be 'conv' or 'linear', "
                             f"got {self.kind!r}")
        want_ndim = 4 if self.kind == "conv" else 2
        if w.ndim != want_ndim:
            raise ValueError(f"{self.kind} weight must be {want_ndim}-D, "
                             f"got shape {w.shape} for layer "
                             f"{self.name or '?'}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.padding < 0 or (self.padding and self.kind != "conv"):
            raise ValueError(f"padding must be >= 0 and on a conv layer, "
                             f"got {self.padding} for layer "
                             f"{self.name or '?'}")
        if self.bias is not None:
            b = np.asarray(self.bias, dtype=np.float32)
            if b.shape != (w.shape[0],):
                raise ValueError(f"bias shape {b.shape} != ({w.shape[0]},) "
                                 f"for layer {self.name or '?'}")
            object.__setattr__(self, "bias", b)

    @classmethod
    def conv(cls, weight, bias=None, *, stride: int = 1, padding: int = 0,
             activation: str | None = None, name: str = "conv"):
        return cls("conv", weight, bias, stride=stride,
                   activation=activation, name=name, padding=padding)

    @classmethod
    def dense(cls, weight, bias=None, *, activation: str | None = None,
              name: str = "dense"):
        return cls("linear", weight, bias, activation=activation, name=name)

    @property
    def out_features(self) -> int:
        return int(self.weight.shape[0])

    @property
    def in_features(self) -> int:
        return int(self.weight.shape[1])


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """A max pooling step: ``window`` × ``window`` at ``stride`` (default
    ``window``), ``padding`` pixels each side that never win the max,
    ``ceil_mode`` as ``F.max_pool2d``'s."""

    window: int
    stride: int | None = None
    padding: int = 0
    ceil_mode: bool = False
    name: str = "pool"
    kind = "pool"


@dataclasses.dataclass(frozen=True, eq=False)
class ModuleSpec:
    """A branch module (an inception module): ``branches``, each a
    sequence of conv :class:`LayerSpec` and :class:`PoolSpec` steps that
    ends with a convolution, all reading the module's input; their outputs
    are concatenated on channels in declared order."""

    branches: tuple
    name: str = "module"
    kind = "module"

    def __post_init__(self):
        branches = tuple(tuple(b) for b in self.branches)
        object.__setattr__(self, "branches", branches)
        for i, b in enumerate(branches):
            if not b or b[-1].kind != "conv" or any(
                    s.kind not in ("conv", "pool") for s in b):
                raise ValueError(f"module {self.name!r} branch {i}: conv "
                                 f"layers and pools that end with a conv")

    @property
    def layers(self) -> list:
        return [s for b in self.branches for s in b if s.kind == "conv"]


def _flatten_with_path(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util`` flatten order for dicts
    (sorted keys), lists and tuples (by index); ``None`` is an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_path(v, path + (str(i),))]
    return [(path, tree)]


def _branch_channels(steps, given: tuple) -> tuple:
    """``(channels, what gives them)`` after a run of conv and pool steps
    on an input ``given`` the same way (``(None, "")``: not known yet);
    raises where a conv layer expects other channels."""
    channels, prev = given
    for st in steps:
        if st.kind == "conv":
            if channels is not None and st.in_features != channels:
                raise ValueError(f"layer {st.name!r} expects "
                                 f"{st.in_features} input channels, "
                                 f"previous {prev} produces {channels}")
            channels, prev = st.out_features, f"layer {st.name!r}"
    return channels, prev


class ModelSpec:
    """A declarative sequence of steps — conv :class:`LayerSpec`,
    :class:`PoolSpec` and :class:`ModuleSpec` first, then linear layers
    (the engine flattens at the boundary).  ``steps`` holds them as
    given (the argument ``layers``), ``layers`` every :class:`LayerSpec`
    in declared order, the modules' branches included; a plain list of
    layers is both."""

    def __init__(self, layers: Sequence):
        self.steps = list(layers)
        self.layers = [ls for st in self.steps
                       for ls in (st.layers if st.kind == "module"
                                  else [] if st.kind == "pool" else [st])]
        if not self.layers:
            raise ValueError("ModelSpec needs at least one layer")
        seen_linear = False
        given = (None, "")             # what the previous step produces
        for st in self.steps:
            if st.kind == "linear":
                seen_linear = True
                continue
            if seen_linear:
                what = "layer" if st.kind == "conv" else "step"
                raise ValueError(f"{st.kind} {what} {st.name!r} after a "
                                 f"linear layer — conv layers must precede "
                                 f"the linear head")
            if st.kind == "module":
                given = (sum(_branch_channels(b, given)[0]
                             for b in st.branches), f"module {st.name!r}")
            else:
                given = _branch_channels([st], given)

    def __len__(self) -> int:
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    def __repr__(self) -> str:
        inner = ", ".join(f"{ls.name or ls.kind}:{ls.kind}"
                          f"{tuple(ls.weight.shape)}" for ls in self.layers)
        return f"ModelSpec([{inner}])"

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_shapes(cls, shapes, n_out: int | None, *, density: float = 0.4,
                    rng=None, activation: str | None = "relu",
                    scale: float = 0.5) -> "ModelSpec":
        """Paper-style sparse Gaussian weights over ``ConvShape`` geometry
        plus a linear head sized from the spatial chain (the same draws
        as ``repro.core.api.ModelSpec.from_shapes`` for the same ``rng``).
        ``n_out=None`` leaves the head out: a conv-only stack."""
        rng = np.random.default_rng(0) if rng is None else rng
        layers: list[LayerSpec] = []
        ri, ci = shapes[0].ri, shapes[0].ci
        for i, s in enumerate(shapes):
            w = rng.normal(size=(s.m, s.n, s.rk, s.ck)
                           ).astype(np.float32) * scale
            w[rng.random(w.shape) > density] = 0
            layers.append(LayerSpec.conv(w, stride=s.stride,
                                         activation=activation,
                                         name=f"conv{i}"))
            ri = (ri - s.rk) // s.stride + 1
            ci = (ci - s.ck) // s.stride + 1
            if ri < 1 or ci < 1:
                raise ValueError(f"input {shapes[0].ri}x{shapes[0].ci} too "
                                 f"small: feature map vanishes at layer {i}")
        if n_out is not None:
            feat = ri * ci * shapes[-1].m
            wl = rng.normal(size=(n_out, feat)).astype(np.float32) * 0.1
            wl[rng.random(wl.shape) > density] = 0
            layers.append(LayerSpec.dense(wl, name="fc"))
        return cls(layers)

    @classmethod
    def from_paper_cnn(cls, net: str, *, n_conv: int = 2,
                       n_out: int | None = 10, ri: int | None = None,
                       ci: int | None = None, density: float = 0.4, rng=None,
                       activation: str | None = "relu") -> "ModelSpec":
        """Random weights on the published layer geometry of a paper CNN
        (``configs.paper_cnns``: alexnet / vgg16 / googlenet)."""
        shapes = _engine.paper_model_shapes(net, n_conv=n_conv, ri=ri, ci=ci)
        return cls.from_shapes(shapes, n_out, density=density, rng=rng,
                               activation=activation)

    @classmethod
    def from_params(cls, params, *, stride=1, activation=None,
                    linear_layout: str = "out_in",
                    min_size: int = 0) -> "ModelSpec":
        """Ingest any conv/dense params tree (nested dicts, lists and
        tuples of arrays), walked in ``jax.tree_util`` flatten order —
        dict keys sorted — so both packages name and order the layers of
        one tree alike: every 4-D leaf
        becomes a conv layer (OIHW), every 2-D leaf a linear layer, and a
        1-D leaf in the same subtree whose length matches a weight's
        output features becomes that layer's bias.

        ``stride``        int for all conv layers, or ``{name: int}``.
        ``activation``    ``None``/str for all layers, or ``{name: str}``
                          (names are '/'-joined paths to the weight's
                          subtree, e.g. ``"conv0"``).
        ``linear_layout`` ``"out_in"`` (M, N) or ``"in_out"`` (transposed
                          here).
        ``min_size``      skip weight leaves smaller than this.
        """
        if linear_layout not in ("out_in", "in_out"):
            raise ValueError(f"linear_layout must be 'out_in' or 'in_out', "
                             f"got {linear_layout!r}")

        def natural_key(name: str):
            # sorted-key flattening puts "conv10" before "conv2"; compare
            # digit runs numerically so numbered layers keep their order
            return tuple(tuple((0, int(p)) if p.isdigit() else (1, p)
                               for p in _re.split(r"(\d+)", comp) if p)
                         for comp in name.split("/"))

        groups: dict[str, dict] = {}
        for keys, leaf in _flatten_with_path(params):
            arr = np.asarray(leaf)
            keys = list(keys)
            gname = "/".join(keys[:-1]) if len(keys) > 1 else "/".join(keys)
            g = groups.setdefault(gname, {"weights": [], "biases": []})
            if arr.ndim in (2, 4) and arr.size >= min_size:
                g["weights"].append((keys[-1] if len(keys) > 1 else gname,
                                     arr))
            elif arr.ndim == 1:
                g["biases"].append(arr)

        def opt(option, name, default):
            if isinstance(option, dict):
                return option.get(name, default)
            return option

        layers: list[LayerSpec] = []
        for gname in sorted(groups, key=natural_key):
            g = groups[gname]
            for wname, w in g["weights"]:
                name = gname if len(g["weights"]) == 1 else \
                    f"{gname}/{wname}"
                if w.ndim == 2 and linear_layout == "in_out":
                    w = np.ascontiguousarray(w.T)
                # pair by matching length, CONSUMING the bias so two
                # same-shaped weights in one subtree never share one
                bi = next((i for i, b in enumerate(g["biases"])
                           if b.shape == (w.shape[0],)), None)
                bias = None if bi is None else g["biases"].pop(bi)
                if w.ndim == 4:
                    layers.append(LayerSpec.conv(
                        w, bias, stride=opt(stride, name, 1),
                        activation=opt(activation, name, None), name=name))
                else:
                    layers.append(LayerSpec.dense(
                        w, bias, activation=opt(activation, name, None),
                        name=name))
        if not layers:
            raise ValueError("from_params found no 2-D/4-D weight leaves "
                             "in the pytree")
        return cls(layers)


# ---------------------------------------------------------------------------
# stage 2: the encoder configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Every offline-encoder knob, in one declarative place.

    ``n_unique``    the paper's U budget (Fig. 6): total quantization
                    levels including zero; 256 = plain int8.
    ``t_m, t_n``    conv output/input-channel tile sizes (§II-D step i).
    ``t_m_linear``  output-feature tile for linear layers (clamped to M).
    ``rle_params``  fixed (delta, rep, index) RLE bit-lengths; ``None``
                    runs the per-layer, per-structure search of §III-C.
    ``decode_source``  ``"bitstream"`` decodes the real RLE streams;
                    ``"ucr"`` rebuilds from retained UCR vectors.
    """

    n_unique: int = 256
    t_m: int = 4
    t_n: int = 4
    t_m_linear: int = 256
    rle_params: tuple[int, int, int] | None = None
    decode_source: str = "bitstream"

    def __post_init__(self):
        # n_unique=2 would leave only the zero level — a dead model
        if not 3 <= self.n_unique <= 256:
            raise ValueError(f"n_unique must be in [3, 256], "
                             f"got {self.n_unique}")
        for field in ("t_m", "t_n", "t_m_linear"):
            v = getattr(self, field)
            if not isinstance(v, (int, np.integer)) or isinstance(v, bool):
                raise ValueError(f"{field} must be an integer >= 1, "
                                 f"got {v!r} ({type(v).__name__})")
            if v < 1:
                raise ValueError(f"{field} must be >= 1, got {v} — tile "
                                 f"sizes are channel counts, not flags")
        if self.rle_params is not None:
            try:
                p = tuple(self.rle_params)
            except TypeError:
                p = (self.rle_params,)
            if len(p) != 3:
                raise ValueError(
                    f"rle_params must be a (delta, rep, index) triple of "
                    f"bit-lengths, got {self.rle_params!r}")
            for stream, b in zip(("delta", "rep", "index"), p):
                if not isinstance(b, (int, np.integer)) \
                        or isinstance(b, bool) or not 1 <= b <= 16:
                    raise ValueError(
                        f"rle_params {stream} bit-length must be an "
                        f"integer in [1, 16], got {b!r} (the escape "
                        f"fallback is 8-bit; widths past 16 can never "
                        f"win the §III-C search)")
            object.__setattr__(self, "rle_params",
                               tuple(int(b) for b in p))
        if self.decode_source not in ("bitstream", "ucr"):
            raise ValueError(f"unknown decode_source "
                             f"{self.decode_source!r}")

    def metadata(self) -> dict:
        """JSON-friendly dict — what a packed checkpoint's manifest
        stores (and benchmark records stamp), as the reference's."""
        d = dataclasses.asdict(self)
        d["rle_params"] = (list(self.rle_params)
                          if self.rle_params is not None else None)
        return d


def _plan_config(plan, name: str, default: EncodeConfig) -> EncodeConfig:
    """Resolve a layer's per-layer config from a plan.

    A plan is anything with ``config_for(name, default)`` — e.g.
    :class:`repro_torch.tune.TunePlan` — or a plain ``{name:
    EncodeConfig}`` dict.  Layers the plan does not cover get
    ``default``, so a global config is exactly the degenerate
    empty/one-entry plan.
    """
    if plan is None:
        return default
    config_for = getattr(plan, "config_for", None)
    if config_for is not None:
        cfg = config_for(name, default)
    else:
        cfg = plan.get(name, default)
    if not isinstance(cfg, EncodeConfig):
        raise TypeError(f"plan entry for layer {name!r} must be an "
                        f"EncodeConfig, got {type(cfg).__name__}")
    return cfg


# ---------------------------------------------------------------------------
# stage 3: compile → executable
# ---------------------------------------------------------------------------

class CompiledModel:
    """What :func:`compile` returns: encode happened exactly once, every
    ``run`` executes from the stored bitstreams via the backend bound at
    compile time (overridable per call).

    Batches are float32 NHWC ``(B, RI, CI, N)`` when the first layer is a
    conv, ``(B, N)`` for linear-only models; arrays or tensors, moved to
    the model's device.  Outputs are torch tensors on that device:
    ``(B, out_features)`` of the last layer, or NHWC for conv-only
    models.  Integer-activation backends (``smm``/``smm_kernel``) quantize
    non-integer inputs to int8 internally.
    """

    def __init__(self, model: "_engine.CodrModel", spec: ModelSpec | None,
                 config: EncodeConfig, backend: _backends.Backend,
                 plan=None):
        self.model = model
        self.spec = spec              # None when built from codes
        self.config = config
        self.backend = backend
        self.plan = plan

    @property
    def device(self) -> torch.device:
        return self.model.device

    def run(self, batch, *, backend=None) -> torch.Tensor:
        """Forward a batch from the RLE bitstreams.  ``backend`` overrides
        the compile-time choice for this call; the override is
        capability-checked first (``ValueError`` with the reason)."""
        be = self.backend if backend is None else _backends.resolve(backend)
        if be is not self.backend:
            ok, reason = be.supports_model(self.model.layers)
            if not ok:
                raise ValueError(reason)
        with span("codr.run", backend=be.name, batch=len(batch)):
            return be.run_model(self.model, batch)

    __call__ = run

    def reference(self, batch) -> torch.Tensor:
        """Dense float oracle on the ORIGINAL uncompressed weights."""
        return self.model.reference(batch)

    def quantized_reference(self, batch) -> torch.Tensor:
        """Dense oracle on the dequantized decoded weights."""
        return self.model.quantized_reference(batch)

    def serve(self, *, max_batch: int = 8, flush_deadline_s: float = 0.01,
              max_pending: int | None = None):
        """Batched request path over this executable
        (:class:`repro_torch.core.serving.CodrBatchServer`).

        ``max_batch``         dispatch size cap AND the async path's load
                              trigger.
        ``flush_deadline_s``  async latency trigger: the longest a
                              pending :meth:`CodrBatchServer.submit_async`
                              request waits before a partial batch is
                              flushed anyway.
        ``max_pending``       bounded admission: with a full queue,
                              ``submit``/``submit_async`` shed the request
                              with ``RejectedError`` (retry-after hint)
                              instead of queueing unboundedly.  ``None``
                              (default) keeps the queue unbounded.

        The synchronous path (``submit``/``flush``) ignores the deadline —
        the caller owns batching cadence there.  Fault injection, retry
        and restart: ``server.configure_resilience(...)``.
        """
        from repro_torch.core.serving import CodrBatchServer
        return CodrBatchServer(self, max_batch=max_batch,
                               flush_deadline_s=flush_deadline_s,
                               max_pending=max_pending)

    # -- accounting ---------------------------------------------------------
    def stats(self):
        """Per-layer :class:`repro_torch.core.engine.LayerStats`."""
        return self.model.stats()

    def total_bits(self) -> int:
        """Real encoded size of the whole model, in bits."""
        return self.model.total_bits()

    def bits_per_weight(self) -> float:
        """``total_bits`` over the weight count (paper Fig. 6)."""
        return self.model.bits_per_weight()

    def sram_report(self, input_hw, **kw):
        """Per-layer SRAM access estimates (paper §IV) for one sample of
        spatial size ``input_hw = (RI, CI)``."""
        return self.model.sram_report(input_hw, **kw)

    def layer_table(self, input_hw: tuple[int, int] | None = None) -> str:
        """Human-readable per-layer accounting: the U budget and
        effective tile each layer encoded under, its measured
        bits/weight, and — when the model was compiled with a tune plan
        — the tuner's predicted bits/weight and SRAM accesses next to
        the measured numbers.

        ``input_hw`` enables the measured-SRAM column (per-layer
        effective tiling, same counting as :meth:`sram_report`); without
        it conv SRAM cannot be counted and the column shows ``-``.  The
        text is the reference's, character for character.
        """
        plan_layers = getattr(self.plan, "layers", None) or {}
        measured_sram: dict[str, float] = {}
        if input_hw is not None:
            measured_sram = {
                name: acc.total_sram
                for name, acc in self.model.sram_report(
                    input_hw, per_layer_tiling=True)}
        hdr = (f"{'layer':<16} {'kind':<7} {'U':>4} {'t_m':>5} "
               f"{'bits/w':>7} {'pred b/w':>9} {'sram':>12} "
               f"{'pred sram':>12}")
        lines = [hdr, "-" * len(hdr)]
        for st in self.stats():
            lp = plan_layers.get(st.name)
            pred_bpw = (f"{lp.predicted_bits_per_weight:9.2f}"
                        if lp is not None else f"{'-':>9}")
            pred_sram = (f"{lp.predicted_sram:12.3e}"
                         if lp is not None else f"{'-':>12}")
            sram = (f"{measured_sram[st.name]:12.3e}"
                    if st.name in measured_sram else f"{'-':>12}")
            lines.append(
                f"{st.name:<16} {st.kind:<7} {st.n_unique_budget:>4} "
                f"{st.t_m:>5} {st.bits_per_weight:7.2f} {pred_bpw} "
                f"{sram} {pred_sram}")
        lines.append(f"{'total':<16} {'':<7} {'':>4} {'':>5} "
                     f"{self.bits_per_weight():7.2f}")
        return "\n".join(lines)

    def verify_roundtrip(self) -> None:
        """Assert decode(bitstreams) == quantize(original floats) for
        every layer."""
        self.model.verify_roundtrip()

    def __repr__(self) -> str:
        return (f"CompiledModel({len(self.model.layers)} layers, "
                f"{self.bits_per_weight():.2f} bits/weight, "
                f"backend={self.backend.name!r}, device={self.device})")


def compile(spec: ModelSpec, config: EncodeConfig | None = None, *,
            backend: str | _backends.Backend = "tiled", plan=None,
            device=None) -> CompiledModel:
    """Run the offline pipeline once over a spec; return the executable.

    ``device`` — where the model runs; ``None`` means the card, and
    raises when there is none.  The backend is resolved and
    capability-checked against the spec BEFORE any encoding work.
    ``plan`` — optional per-layer configs: a
    :class:`repro_torch.tune.TunePlan` (anything with ``config_for``) or a
    ``{layer name: EncodeConfig}`` dict; layers it does not name encode
    under ``config``.
    """
    dev = resolve_device(device)
    config = EncodeConfig() if config is None else config
    be = _backends.resolve(backend)
    ok, reason = be.supports_model(spec.layers)
    if not ok:
        raise ValueError(f"cannot compile: {reason}")

    index = {id(ls): i for i, ls in enumerate(spec.layers)}

    def build(st):
        if st.kind == "pool":
            return _engine.MaxPool2D(st.window, st.stride, st.padding,
                                     st.ceil_mode, name=st.name)
        if st.kind == "module":
            return _engine.BranchModule(
                [[build(s) for s in b] for b in st.branches], name=st.name)
        name = st.name or f"layer{index[id(st)]}"
        cfg = _plan_config(plan, name, config)
        if st.kind == "conv":
            return _engine.CodrConv2D(
                st.weight, st.bias, stride=st.stride, padding=st.padding,
                t_m=cfg.t_m, t_n=cfg.t_n, activation=st.activation,
                name=name, decode_source=cfg.decode_source,
                n_unique=cfg.n_unique, rle_params=cfg.rle_params, device=dev)
        return _engine.CodrLinear(
            st.weight, st.bias, t_m=cfg.t_m_linear,
            activation=st.activation, name=name,
            decode_source=cfg.decode_source, n_unique=cfg.n_unique,
            rle_params=cfg.rle_params, device=dev)

    return CompiledModel(_engine.CodrModel([build(st) for st in spec.steps]),
                         spec, config, be, plan=plan)


# ---------------------------------------------------------------------------
# the transformer lane: compile a params tree
# ---------------------------------------------------------------------------

#: path substrings identifying projection leaves in ``repro_torch.models``
#: params (q/k/v/o, up/gate/down, router and expert stacks)
PACK_INCLUDE = ("proj", "router", "w_experts")
EMBED_INCLUDE = ("embed",)        # (V, d) leaves packed for row-gather


class _ConvLeafShim:
    """Duck-typed layer handed to ``Backend.supports`` so a conv-shaped
    leaf in ``compile_params`` fails with the capability error surface
    ``compile`` uses."""

    kind = "conv"
    stride = 1

    def __init__(self, name: str):
        self.name = name


@dataclasses.dataclass
class CompiledParams:
    """What :func:`compile_params` returns: the params tree with every
    projection leaf replaced by its packed form
    (:class:`~repro_torch.core.codr_linear.PackedLinear`) and every
    embedding by :class:`~repro_torch.core.codr_linear.PackedEmbedding`,
    plus the accounting.  ``params`` drops into the
    :mod:`repro_torch.models` forwards unchanged; the byte counts are
    measured on the stored packs."""

    params: object
    reports: list                 # serving.TensorReport per packed leaf
    packed_paths: list
    quantized_paths: list         # quantize-applied but served dense
    config: EncodeConfig
    backend: str
    plan: object = None           # TunePlan / {path: EncodeConfig} / None
    embed_paths: list = dataclasses.field(default_factory=list)

    def packed_leaves(self):
        """``(path_str, PackedLinear | PackedEmbedding)`` pairs, flatten
        order."""
        from repro_torch.core.codr_linear import PackedEmbedding, PackedLinear
        from repro_torch.core.tree import leaves_with_path
        return [(p, leaf) for p, leaf in leaves_with_path(self.params)
                if isinstance(leaf, (PackedLinear, PackedEmbedding))]

    # -- measured accounting ------------------------------------------------
    def hbm_bytes(self) -> int:
        """Real bytes of the packed representation (indices + tables +
        scales) — the number the serving path reports."""
        return sum(pl.hbm_bytes for _, pl in self.packed_leaves())

    def dense_bf16_bytes(self) -> int:
        return sum(pl.n_weights * 2 for _, pl in self.packed_leaves())

    def n_packed_weights(self) -> int:
        return sum(pl.n_weights for _, pl in self.packed_leaves())

    def bits_per_weight(self) -> float:
        return self.hbm_bytes() * 8 / max(self.n_packed_weights(), 1)

    def compression_vs_bf16(self) -> float:
        return self.dense_bf16_bytes() / max(self.hbm_bytes(), 1)

    def summary(self) -> str:
        """Human-readable accounting: the RLE/baseline comparison (when
        accounting ran) plus the measured packed-representation bytes."""
        lines = []
        if self.reports:
            from repro_torch.core.serving import codr_report
            lines.append(codr_report(self.reports))
        lines.append(
            f"packed {len(self.packed_paths)} projection tensors + "
            f"{len(self.embed_paths)} embedding tables "
            f"({self.n_packed_weights() / 1e6:.2f}M weights) for backend "
            f"{self.backend!r}: {self.hbm_bytes() / 1e6:.3f} MB HBM "
            f"measured ({self.bits_per_weight():.2f} bits/weight, "
            f"{self.compression_vs_bf16():.1f}x vs bf16); "
            f"{len(self.quantized_paths)} more tensors quantize-applied, "
            f"served dense")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"CompiledParams({len(self.packed_paths)} packed + "
                f"{len(self.quantized_paths)} quantized leaves, "
                f"{self.bits_per_weight():.2f} bits/weight, "
                f"backend={self.backend!r})")


def compile_params(params, config: EncodeConfig | None = None, *,
                   backend: str | _backends.Backend = "codr_matmul",
                   plan=None,
                   min_size: int | None = None,
                   include: Sequence[str] = PACK_INCLUDE,
                   exclude: Sequence[str] = (),
                   pack_embeddings: bool = True,
                   sample_rows: int | None = 4096,
                   accounting: bool = True,
                   device=None) -> CompiledParams:
    """Offline-encode a :mod:`repro_torch.models` params tree for serving
    from the compressed representation (the transformer lane).

    Every projection leaf (path matches ``include`` and not ``exclude``,
    ``ndim >= 2``, ``numel >= min_size``) is quantized under the
    ``config`` U budget and packed (:class:`PackedLinear`); 2-D leaves
    matching ``EMBED_INCLUDE`` become row-gatherable
    :class:`PackedEmbedding` tables (``pack_embeddings=False`` turns that
    off); every *other* large leaf gets the quantization applied in place
    and is served dense, as ``serving.codr_compress_params`` does — so
    packed and quantize-applied serving see bit-identical weights.
    Leading stack dims pack per matrix under one shared quantization.

    Each leaf is encoded with torch ops on ``device`` — ``None`` means
    the card, and raises when there is none; the packs are byte-identical
    to ``repro.core.api.compile_params``'.  The ``backend`` must declare
    ``caps.packed_matmul``; a conv-shaped leaf that matches ``include``
    raises that backend's capability error.  ``min_size`` defaults to
    ``serving.MIN_COMPRESS_SIZE``; ``sample_rows`` / ``accounting``
    bound the per-tensor RLE accounting on the host (the packed bytes
    are always measured in full).  ``plan`` — optional per-leaf configs
    keyed by path (a :class:`repro_torch.tune.TunePlan` from
    :func:`repro_torch.tune.tune_params`, or a ``{path: EncodeConfig}``
    dict); leaves it does not name use ``config``.
    """
    from repro_torch.core import serving as _serving
    from repro_torch.core.codr_linear import pack_embedding, pack_projection
    from repro_torch.core.tree import map_with_path

    dev = resolve_device(device)
    config = EncodeConfig() if config is None else config
    be = _backends.resolve(backend)
    if not be.caps.packed_matmul:
        raise ValueError(
            f"backend {be.name!r} has no packed-projection matmul path "
            f"(caps.packed_matmul is False); packed-capable backends: "
            f"{', '.join(n for n in _backends.available_backends() if _backends.get_backend(n).caps.packed_matmul)}")
    if min_size is None:
        min_size = _serving.MIN_COMPRESS_SIZE

    reports: list = []
    packed_paths: list = []
    quantized_paths: list = []
    embed_paths: list = []

    def report(pstr, t, n_unique, pack_bits):
        if accounting:
            acc = _serving.account_tensor(
                _serving._host(t.reshape(-1, t.shape[-1])),
                n_unique=n_unique, sample_rows=sample_rows)
            acc["pack_bits"] = pack_bits    # measured, not estimated
            reports.append(_serving.TensorReport(
                path=pstr, n_weights=t.numel(), **acc))

    def leaf_fn(pstr, leaf):
        t = leaf.to(dev)
        if t.dim() < 2 or t.numel() < min_size:
            return t
        n_unique = _plan_config(plan, pstr, config).n_unique
        excluded = any(tok in pstr for tok in exclude)
        if (pack_embeddings and t.dim() == 2 and not excluded
                and any(tok in pstr for tok in EMBED_INCLUDE)):
            pe = pack_embedding(t, n_unique=n_unique, backend=be.name)
            embed_paths.append(pstr)
            report(pstr, t, n_unique, pe.hbm_bytes * 8)
            return pe
        if excluded or not any(tok in pstr for tok in include):
            # quantize-applied, served dense (the codr_compress_params
            # lane) — norms and biases past min_size, and embeddings
            # when pack_embeddings is off
            deq, _ = _serving._quantize_only(t.reshape(-1, t.shape[-1]),
                                             n_unique)
            quantized_paths.append(pstr)
            return deq.reshape(t.shape).to(t.dtype)
        if t.dim() == 4 and max(t.shape[-2:]) < 16:
            # OIHW conv kernel: both trailing dims are small spatial
            # extents, unlike a stacked expert projection
            ok, reason = be.supports(_ConvLeafShim(pstr))
            raise ValueError(reason if not ok else
                             f"compile_params packs linear projections "
                             f"only; conv leaf {pstr!r} must go through "
                             f"ModelSpec.from_params → compile")
        pl = pack_projection(t, n_unique=n_unique, backend=be.name)
        packed_paths.append(pstr)
        report(pstr, t, n_unique, pl.hbm_bytes * 8)
        return pl

    new_params = map_with_path(leaf_fn, params)
    if not packed_paths:
        raise ValueError(
            "compile_params found no packable projection leaves "
            f"(include={tuple(include)!r}, min_size={min_size}) — for "
            "conv/dense checkpoint trees use ModelSpec.from_params")
    return CompiledParams(new_params, reports, packed_paths, quantized_paths,
                          config, be.name, plan, embed_paths=embed_paths)
