"""CoDR inference engine of the port: encode once, run many (paper
§II-D + §III-B).

* :class:`CodrConv2D` / :class:`CodrLinear` — one layer each.  At
  construction the float weights run through the offline pipeline
  exactly once (quantize → tile → sort/densify/unify → Δ → RLE
  bitstreams); :meth:`CodrConv2D.from_code` adopts an existing code
  instead.  The float weights are kept only as the test oracle; the
  layer *executes* from the bitstreams.
* **Decode on first dispatch** — the first forward pass decodes the
  layer's RLE bitstreams in one vectorized pass
  (:func:`repro_torch.core.rle.decode_layer`) and keeps the int8 tile
  stack, cut into the layer's output-channel groups
  (:func:`channel_groups`) as float32 on the layer's device, for every
  later request.
* :class:`CodrModel` — runs a sequence of steps over NHWC batches:
  layers (flattening at the conv→linear boundary), max poolings
  (:class:`MaxPool2D`) and branch modules (:class:`BranchModule`, an
  inception module), with dense float32 oracles and per-layer SRAM
  access estimates.  Zero padding (``CodrConv2D(padding=...)``), pooling
  and branches go beyond the JAX package's engine, which chains VALID
  convolutions only; a plain chain of VALID layers is what it was.

Execution goes through the backend registry
(:mod:`repro_torch.core.backends`).  Layers live on one torch device;
float32 convolutions and matmuls here run with TF32 off
(:func:`full_fp32`), so ``tiled`` and the oracles keep float32 accuracy
on the card as on the CPU.

The float lanes (``tiled``, and ``sharded`` at any mesh size) compute a
layer as one ``F.conv2d`` / matmul per output-channel group, each group
a fixed run of whole tiles that depends on the layer's shape alone.  A
shard is a union of groups, so every output channel comes from the same
call with the same arguments in every lane, and the lanes agree bit for
bit whichever algorithm cuDNN or cuBLAS picks for a call.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import backends as _backends
from repro_torch.core import dataflow, rle, ucr
from repro_torch.core.dataflow import CODR_TILING, ConvShape, pool_out
from repro_torch.core.spans import span

__all__ = [
    "BranchModule", "CHANNEL_GROUPS", "CodrConv2D", "CodrLinear",
    "CodrModel", "LayerStats", "MaxPool2D", "build_random_model",
    "channel_groups", "decode_all_tiles", "decode_tile", "full_fp32",
    "paper_model_shapes", "resolve_device",
]

# output-channel groups a layer is computed in (fewer where it has fewer
# tiles): 4 splits evenly over meshes of 1, 2 and 4 devices, and on the
# H100 VGG16 ran fastest at 4 of the counts 1, 4, 8 and 16, with none of
# the FFT kernels cuDNN picks for a full-width conv2 call
# (sharded_probe.py)
CHANNEL_GROUPS = 4


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  Asking for CUDA where there is none raises — the port
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain CPU path")
    return dev


def channel_groups(n_tiles: int) -> tuple[int, int]:
    """``(groups, tiles per group)`` of a layer with ``n_tiles`` output
    tiles: :data:`CHANNEL_GROUPS` groups, or one tile each where the layer
    has fewer tiles.  Zero tiles pad the stack to ``groups · tiles per
    group``.  A function of the layer alone, never of a mesh."""
    groups = min(CHANNEL_GROUPS, n_tiles)
    return groups, -(-n_tiles // groups)


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in full float32: cuDNN's
    default for float32 convolutions is TF32 (about three decimal
    digits), which the ``tiled`` lane and the oracles must not use."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# per-layer statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerStats:
    name: str
    kind: str                      # "conv" | "linear"
    shape: tuple[int, ...]
    n_weights: int
    encoded_bits: int
    bits_per_weight: float
    density: float
    n_unique: int                  # sum of per-vector unique counts
    n_nonzero: int
    n_unique_budget: int = 256     # the U budget the layer encoded under
    t_m: int = 4                   # EFFECTIVE output tile (clamped to M)
    t_n: int = 4


def _layer_stats(name: str, kind: str, code: ucr.LayerCode,
                 n_unique_budget: int = 256) -> LayerStats:
    n_unique = sum(len(u.unique_vals) for u in code.ucr)
    n_nonzero = sum(u.n_nonzero for u in code.ucr)
    return LayerStats(
        name=name, kind=kind, shape=code.shape, n_weights=code.n_weights,
        encoded_bits=code.total_bits, bits_per_weight=code.bits_per_weight,
        density=n_nonzero / max(code.n_weights, 1),
        n_unique=n_unique, n_nonzero=n_nonzero,
        n_unique_budget=n_unique_budget,
        t_m=min(code.t_m, code.shape[0]), t_n=code.t_n)


# ---------------------------------------------------------------------------
# bitstream → dense tiles
# ---------------------------------------------------------------------------

def _flat_vectors(code: ucr.LayerCode, vectors, ucrs, pad_to: int,
                  source: str) -> np.ndarray:
    if source == "bitstream":
        return rle.decode_layer(vectors, pad_to=pad_to)
    if source == "ucr":
        flat = np.zeros((len(ucrs), pad_to), dtype=np.int8)
        for i, u in enumerate(ucrs):
            flat[i, : u.vector_len] = ucr.ucr_reconstruct(u)
        return flat
    raise ValueError(f"unknown decode source {source!r} "
                     f"(expected 'bitstream' or 'ucr')")


def decode_all_tiles(code: ucr.LayerCode, *,
                     source: str = "bitstream") -> np.ndarray:
    """All tiles, stacked: int8 ``(n_tiles, t_m, N, RK, CK)``.

    ``source="bitstream"`` decodes the real RLE bitstreams in one
    vectorized pass; ``source="ucr"`` rebuilds from the retained UCR
    vectors (bit-identical)."""
    n_tiles = -(-code.shape[0] // code.t_m)
    n = code.shape[1]
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    flat = _flat_vectors(code, code.vectors, code.ucr, code.t_m * rk * ck,
                         source)
    return np.ascontiguousarray(
        flat.reshape(n_tiles, n, code.t_m, rk, ck).transpose(0, 2, 1, 3, 4))


def decode_tile(code: ucr.LayerCode, mt: int, *,
                source: str = "bitstream") -> np.ndarray:
    """Decode output-channel tile ``mt`` only — O(tile), not O(layer).
    Returns int8 ``(t_m, N, RK, CK)``; rows past the true output-channel
    count (ragged last tile) are zero."""
    n = code.shape[1]
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    sl = slice(mt * n, (mt + 1) * n)
    flat = _flat_vectors(code, code.vectors[sl], code.ucr[sl],
                         code.t_m * rk * ck, source)
    return np.ascontiguousarray(
        flat.reshape(n, code.t_m, rk, ck).transpose(1, 0, 2, 3))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class _CodrLayer:
    """What conv and linear layers share: the code, the decoded tile
    cache, the device, the bias and the oracle weights."""

    kind = ""

    def _setup(self, code: ucr.LayerCode, w_ref, bias, *, activation, name,
               decode_source, n_unique, device) -> None:
        self.code = code
        self.name = name
        self.activation = activation
        self.decode_source = decode_source
        self.n_unique = int(n_unique)
        self.device = resolve_device(device)
        self.bias = None if bias is None else np.asarray(bias, np.float32)
        self._w_ref = w_ref                  # oracle only — never executed
        self._tiles: np.ndarray | None = None
        self._tiles_dev: torch.Tensor | None = None
        self._groups_dev: tuple[torch.Tensor, ...] | None = None
        self._bias_dev: torch.Tensor | None = None

    @property
    def tiles(self) -> np.ndarray:
        """Decoded int8 tile stack ``(n_tiles, t_m, N, RK, CK)`` (cached)."""
        if self._tiles is None:
            self._tiles = decode_all_tiles(self.code,
                                           source=self.decode_source)
        return self._tiles

    @property
    def tiles_device(self) -> torch.Tensor:
        """The tile stack as float32 on the layer's device (cached)."""
        if self._tiles_dev is None:
            self._tiles_dev = torch.from_numpy(
                self.tiles.astype(np.float32)).to(self.device)
        return self._tiles_dev

    @property
    def groups_device(self) -> tuple[torch.Tensor, ...]:
        """The tile stack cut into the layer's output-channel groups
        (:func:`channel_groups`), each its own contiguous float32 weight
        on the layer's device: ``(tiles per group · t_m, N, RK, CK)`` for
        conv, ``(tiles per group · t_m, N)`` for linear; pad tiles are
        zero (cached).  Every float lane runs one call per group."""
        if self._groups_dev is None:
            t = self.tiles
            n_groups, per = channel_groups(t.shape[0])
            pad = n_groups * per - t.shape[0]
            if pad:
                t = np.concatenate([t, np.zeros((pad, *t.shape[1:]),
                                                t.dtype)])
            tail = t.shape[2:] if self.kind == "conv" else t.shape[2:3]
            w = t.astype(np.float32).reshape(n_groups, per * t.shape[1],
                                             *tail)
            self._groups_dev = tuple(torch.from_numpy(g).to(self.device)
                                     for g in w)
        return self._groups_dev

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled forward: one float32 call of the layer's kind
        (``_local``: conv NHWC ``(B, RI, CI, N)`` → ``(B, RO, CO, M)``,
        linear ``(B, N)`` → ``(B, M)``) per output-channel group
        (:attr:`groups_device`), all on the same input, concatenated over
        the channel axis and cropped to the layer's channels, then scale,
        bias, activation."""
        y = torch.cat([self._local(x, w) for w in self.groups_device],
                      dim=-1)
        return _backends._finish(self, y[..., : self.code.shape[0]]
                                 * self.scale)

    @property
    def bias_device(self) -> torch.Tensor:
        if self._bias_dev is None:
            self._bias_dev = torch.from_numpy(self.bias).to(self.device)
        return self._bias_dev

    @property
    def scale(self) -> float:
        return float(np.asarray(self.code.scale))

    def decoded_weights(self) -> np.ndarray:
        """Dense int8 weights rebuilt from the bitstreams: ``(M, N, RK,
        CK)`` for conv, ``(M, N)`` for linear."""
        t = self.tiles
        m = self.code.shape[0]
        return t.reshape(-1, *self.code.shape[1:])[:m]

    def verify_roundtrip(self) -> None:
        """Bitstream decode must equal direct quantization (plus any
        unique-level restriction) of the float weights."""
        if self._w_ref is None:
            raise ValueError(f"{self.name}: no float weights to verify "
                             f"against (layer built from a code)")
        q, _ = ucr.quantize_int8(self._w_ref)
        q = ucr.restrict_unique(q, self.n_unique)
        if not np.array_equal(self.decoded_weights(), q):
            raise AssertionError(f"{self.name}: UCR+RLE roundtrip mismatch")

    def stats(self) -> LayerStats:
        return _layer_stats(self.name, self.kind, self.code,
                            n_unique_budget=self.n_unique)

    def _oracle_weights(self) -> torch.Tensor:
        if self._w_ref is None:
            raise ValueError(f"{self.name}: no float weights for the dense "
                             f"oracle (layer built from a code)")
        return torch.from_numpy(self._w_ref).to(self.device)

    def _dequantized_weights(self) -> torch.Tensor:
        w = self.decoded_weights().astype(np.float32) * self.scale
        return torch.from_numpy(w).to(self.device)


class CodrConv2D(_CodrLayer):
    """A conv layer executed from its CoDR code (NHWC): VALID by default,
    or on a zero border of ``padding`` pixels each side (SAME for an odd
    kernel at stride 1; beyond the JAX package's engine).

    ``w`` is float ``(M, N, RK, CK)`` (OIHW); encoding happens once here.
    """

    kind = "conv"

    def __init__(self, w: np.ndarray, bias: np.ndarray | None = None, *,
                 stride: int = 1, padding: int = 0, t_m: int = 4,
                 t_n: int = 4,
                 activation: str | None = None, name: str = "conv",
                 decode_source: str = "bitstream", n_unique: int = 256,
                 rle_params: tuple[int, int, int] | None = None,
                 device="cuda"):
        w = np.asarray(w, dtype=np.float32)
        if w.ndim != 4:
            raise ValueError("conv weights must be (M, N, RK, CK)")
        code = ucr.encode_conv_layer(w, t_m=t_m, t_n=t_n, n_unique=n_unique,
                                     params=rle_params)
        self.stride, self.padding = _geometry(stride, padding)
        self._setup(code, w, bias, activation=activation, name=name,
                    decode_source=decode_source, n_unique=n_unique,
                    device=device)
        self._smm_ops = None                  # packed SMM kernel operands

    @classmethod
    def from_code(cls, code: ucr.LayerCode, bias=None, *, stride: int = 1,
                  activation: str | None = None, name: str = "conv",
                  decode_source: str = "bitstream", n_unique: int = 256,
                  device="cuda") -> "CodrConv2D":
        """A layer that executes an existing code (no float weights, so
        no dense ``reference``), VALID."""
        self = cls.__new__(cls)
        self.stride, self.padding = _geometry(stride, 0)
        self._setup(code, None, bias, activation=activation, name=name,
                    decode_source=decode_source, n_unique=n_unique,
                    device=device)
        self._smm_ops = None
        return self

    def out_hw(self, ri: int, ci: int) -> tuple[int, int]:
        rk, ck = self.code.shape[2], self.code.shape[3]
        p = 2 * self.padding
        return ((ri + p - rk) // self.stride + 1,
                (ci + p - ck) // self.stride + 1)

    def conv_shape(self, ri: int, ci: int) -> ConvShape:
        """The layer's geometry on an ``ri`` × ``ci`` input, the input's
        zero border included."""
        m, n, rk, ck = self.code.shape
        p = 2 * self.padding
        return ConvShape(m, n, rk, ck, ri + p, ci + p, self.stride)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.padding:
            p = self.padding
            x = F.pad(x, (0, 0, p, p, p, p))
        with full_fp32():
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride)
        return y.permute(0, 2, 3, 1)

    _local = _conv

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        """Dense float32 oracle on the ORIGINAL float weights."""
        return _backends._finish(self, self._conv(x, self._oracle_weights()))

    def quantized_reference(self, x: torch.Tensor) -> torch.Tensor:
        """Dense float32 oracle on the dequantized decoded weights."""
        return _backends._finish(
            self, self._conv(x, self._dequantized_weights()))

    def smm_operands(self):
        """Padded SMM kernel operands, packed once per layer and kept on
        the layer's device — every dispatch (any batch size) reuses them."""
        if self._smm_ops is None:
            from repro_torch.kernels.smm_conv.ops import smm_operands_on
            self._smm_ops = smm_operands_on(self.code, self.code.shape[1],
                                            self.device)
        return self._smm_ops

    def smm_forward(self, x: torch.Tensor, *, kernel: bool = False
                    ) -> torch.Tensor:
        """Shim: run the differential SMM mechanism through the backend
        registry — ``kernel=False`` → the ``smm`` backend (NumPy faithful
        execution on the host), ``kernel=True`` → ``smm_kernel`` (the
        CUDA ``smm_conv`` kernel on the card, its plain version on the
        CPU).  New code names the backend at compile or run time."""
        backend = _backends.get_backend("smm_kernel" if kernel else "smm")
        return backend.conv(self, x)


def _geometry(stride, padding) -> tuple[int, int]:
    stride, padding = int(stride), int(padding)
    if stride < 1 or padding < 0:
        raise ValueError(f"stride must be >= 1 and padding >= 0, got "
                         f"{stride} and {padding}")
    return stride, padding


class CodrLinear(_CodrLayer):
    """A fully-connected layer executed from its CoDR code.

    ``w`` is float ``(M, N)`` = (out features, in features) — a conv with a
    1×1 kernel (paper Fig. 1).
    """

    kind = "linear"

    def __init__(self, w: np.ndarray, bias: np.ndarray | None = None, *,
                 t_m: int = 256, activation: str | None = None,
                 name: str = "linear", decode_source: str = "bitstream",
                 n_unique: int = 256,
                 rle_params: tuple[int, int, int] | None = None,
                 device="cuda"):
        w = np.asarray(w, dtype=np.float32)
        if w.ndim != 2:
            raise ValueError("linear weights must be (M, N)")
        code = ucr.encode_linear_layer(w, t_m=min(t_m, w.shape[0]),
                                       n_unique=n_unique, params=rle_params)
        self._setup(code, w, bias, activation=activation, name=name,
                    decode_source=decode_source, n_unique=n_unique,
                    device=device)

    @classmethod
    def from_code(cls, code: ucr.LayerCode, bias=None, *,
                  activation: str | None = None, name: str = "linear",
                  decode_source: str = "bitstream", n_unique: int = 256,
                  device="cuda") -> "CodrLinear":
        """A layer that executes an existing code (see
        :meth:`CodrConv2D.from_code`)."""
        self = cls.__new__(cls)
        self._setup(code, None, bias, activation=activation, name=name,
                    decode_source=decode_source, n_unique=n_unique,
                    device=device)
        return self

    def decoded_weights(self) -> np.ndarray:
        t = self.tiles
        m, n = self.code.shape[0], self.code.shape[1]
        return t.reshape(-1, n)[:m]

    def _matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return x @ w.T

    _local = _matmul

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        return _backends._finish(self,
                                 self._matmul(x, self._oracle_weights()))

    def quantized_reference(self, x: torch.Tensor) -> torch.Tensor:
        return _backends._finish(
            self, self._matmul(x, self._dequantized_weights()))


# ---------------------------------------------------------------------------
# steps without weights: pooling and branch modules
# ---------------------------------------------------------------------------

class MaxPool2D:
    """A max pooling step over NHWC batches, as ``F.max_pool2d``:
    ``window`` × ``window`` at ``stride`` (default ``window``), ``padding``
    pixels each side that never win the max, ``ceil_mode`` rounding the
    output size up.  Not in the JAX package's engine."""

    kind = "pool"

    def __init__(self, window: int, stride: int | None = None,
                 padding: int = 0, ceil_mode: bool = False,
                 name: str = "pool"):
        self.window = int(window)
        self.stride = self.window if stride is None else int(stride)
        self.padding, self.ceil_mode, self.name = int(padding), ceil_mode, name
        if self.window < 1 or self.stride < 1 or \
                not 0 <= self.padding <= self.window // 2:
            raise ValueError(f"pool {name!r}: window {self.window}, stride "
                             f"{self.stride}, padding {self.padding} (at "
                             f"most half the window)")

    def out_hw(self, ri: int, ci: int) -> tuple[int, int]:
        return tuple(pool_out(n, self.window, self.stride, self.padding,
                              self.ceil_mode) for n in (ri, ci))

    def pool_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """The pooling of NCHW ``x`` (float, or int8 features held as
        whole-number float32: a max is exact), contiguous NCHW."""
        return F.max_pool2d(x, self.window, self.stride, self.padding,
                            ceil_mode=self.ceil_mode).contiguous()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``x`` → NHWC, the view of NCHW storage."""
        return self.pool_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BranchModule:
    """Parallel branches that read one NHWC input, their outputs
    concatenated on channels in declared order: an inception module.  A
    branch is a sequence of :class:`CodrConv2D` and :class:`MaxPool2D`
    steps that ends with a convolution; every branch gives the same
    plane.  Not in the JAX package's engine."""

    kind = "module"

    def __init__(self, branches, name: str = "module"):
        self.name = name
        self.branches = [list(b) for b in branches]
        if not self.branches:
            raise ValueError(f"module {name!r} has no branch")
        for i, b in enumerate(self.branches):
            if not b or any(s.kind not in ("conv", "pool") for s in b) \
                    or b[-1].kind != "conv":
                raise ValueError(f"module {name!r} branch {i}: convolutions "
                                 f"and poolings that end with a convolution")

    @property
    def layers(self) -> list:
        return [s for b in self.branches for s in b if s.kind == "conv"]

    @property
    def out_channels(self) -> int:
        return sum(b[-1].code.shape[0] for b in self.branches)

    def branch_kind(self, i: int) -> str:
        """``"pool"`` for a branch that pools, else its last kernel's size
        (``"1x1"``, ``"3x3"``, ``"5x5"``)."""
        b = self.branches[i]
        if any(s.kind == "pool" for s in b):
            return "pool"
        return "x".join(str(k) for k in b[-1].code.shape[2:])

    def branch_span(self, i: int):
        return span("codr.branch", module=self.name, index=i,
                    kind=self.branch_kind(i))

    def out_hw(self, ri: int, ci: int) -> tuple[int, int]:
        planes = set()
        for b in self.branches:
            hw = (ri, ci)
            for s in b:
                hw = s.out_hw(*hw)
            planes.add(hw)
        if len(planes) != 1:
            raise ValueError(f"module {self.name!r}: the branches give the "
                             f"planes {sorted(planes)} on a {ri}x{ci} input")
        return planes.pop()


# ---------------------------------------------------------------------------
# model = a sequence of steps
# ---------------------------------------------------------------------------

class CodrModel:
    """A sequence of steps on one device — CoDR layers, max poolings and
    branch modules, given as ``layers`` and kept as ``steps`` — with dense
    float32 oracles.  ``layers`` lists every layer in declared order, the
    modules' branches included.

    ``run`` executes from the RLE bitstreams (decoded on first dispatch);
    ``reference`` runs the original float weights, ``quantized_reference``
    the dequantized decoded ones.
    """

    def __init__(self, layers: Sequence):
        self.steps = list(layers)
        self.layers = [l for s in self.steps
                       for l in (s.layers if s.kind == "module"
                                 else [] if s.kind == "pool" else [s])]
        if not self.layers:
            raise ValueError("CodrModel needs at least one layer")
        devices = {l.device for l in self.layers}
        if len(devices) != 1:
            raise ValueError(f"layers live on several devices: {devices}")
        self.device = self.layers[0].device
        self._index = {id(l): i for i, l in enumerate(self.layers)}

    def as_input(self, batch) -> torch.Tensor:
        """A batch (array or tensor) as float32 on the model's device."""
        return torch.as_tensor(batch, dtype=torch.float32, device=self.device)

    def _chain(self, x: torch.Tensor, step, lane=None) -> torch.Tensor:
        """``x`` through the steps: ``step(layer, x)`` a layer; a pooling
        and a module through ``lane`` (a backend: its ``pool_nchw`` and
        ``module``) where given, else on the float path
        (:meth:`run_pool`, :meth:`run_module`)."""
        for s in self.steps:
            if s.kind == "pool":
                x = self.run_pool(s, x, lane)
            elif s.kind == "module":
                with span("codr.module", name=s.name):
                    x = (lane.module(self, s, x) if lane is not None
                         else self.run_module(s, x, step))
            else:
                if s.kind == "linear" and x.dim() > 2:
                    x = x.reshape(x.shape[0], -1)
                x = self.run_layer(s, x, step)
        return x

    def run_layer(self, layer, x: torch.Tensor, step) -> torch.Tensor:
        with span("codr.layer", name=layer.name,
                  index=self._index[id(layer)], kind=layer.kind):
            return step(layer, x)

    @staticmethod
    def run_pool(pool: MaxPool2D, x: torch.Tensor, lane=None
                 ) -> torch.Tensor:
        """A pooling of NHWC ``x``: ``lane.pool_nchw`` where a lane is
        given, else :meth:`MaxPool2D.pool_nchw`."""
        with span("codr.pool", window=pool.window, stride=pool.stride):
            h = x.permute(0, 3, 1, 2)
            h = pool.pool_nchw(h) if lane is None else lane.pool_nchw(pool, h)
            return h.permute(0, 2, 3, 1)

    def run_module(self, mod: BranchModule, x: torch.Tensor, step,
                   lane=None) -> torch.Tensor:
        """A module on the float path: each branch's steps in turn on
        ``x``, the outputs concatenated on channels."""
        outs = []
        for i, branch in enumerate(mod.branches):
            with mod.branch_span(i):
                h = x
                for s in branch:
                    h = (self.run_pool(s, h, lane) if s.kind == "pool"
                         else self.run_layer(s, h, step))
                outs.append(h)
        return torch.cat(outs, dim=-1)

    def __call__(self, batch, *,
                 backend: str | _backends.Backend = "tiled") -> torch.Tensor:
        return self.run(batch, backend=backend)

    def run(self, batch, *,
            backend: str | _backends.Backend = "tiled") -> torch.Tensor:
        """Forward an NHWC batch through the compressed model via the
        registry (a registered name or a ``Backend`` instance)."""
        return _backends.resolve(backend).run_model(self, batch)

    def reference(self, batch) -> torch.Tensor:
        """Dense float oracle (uncompressed weights)."""
        return self._chain(self.as_input(batch), lambda l, x: l.reference(x))

    def quantized_reference(self, batch) -> torch.Tensor:
        """Dense oracle on the DEQUANTIZED decoded weights — ``run`` must
        match this up to float summation order."""
        return self._chain(self.as_input(batch),
                           lambda l, x: l.quantized_reference(x))

    # -- bookkeeping --------------------------------------------------------
    def verify_roundtrip(self) -> None:
        for layer in self.layers:
            layer.verify_roundtrip()

    def stats(self) -> list[LayerStats]:
        return [l.stats() for l in self.layers]

    def total_bits(self) -> int:
        return sum(l.code.total_bits for l in self.layers)

    def bits_per_weight(self) -> float:
        n = sum(l.code.n_weights for l in self.layers)
        return self.total_bits() / max(n, 1)

    def layer_shapes(self, input_hw: tuple[int, int]
                     ) -> list[tuple[object, ConvShape]]:
        """``(layer, ConvShape)`` of every layer in :attr:`layers` order
        for one sample of spatial size ``input_hw``, tracking the plane
        through the steps: a conv's input border included, a module's
        branches each from the module's input, a linear layer a 1×1 conv
        on a 1×1 feature map."""
        out: list = []

        def walk(steps, hw):
            for s in steps:
                if s.kind == "pool":
                    hw = s.out_hw(*hw)
                elif s.kind == "module":
                    for b in s.branches:
                        walk(b, hw)
                    hw = s.out_hw(*hw)
                elif s.kind == "conv":
                    out.append((s, s.conv_shape(*hw)))
                    hw = s.out_hw(*hw)
                else:
                    m, n = s.code.shape[0], s.code.shape[1]
                    out.append((s, ConvShape(m, n, 1, 1, 1, 1, 1)))
            return hw

        walk(self.steps, tuple(input_hw))
        return out

    def sram_report(self, input_hw: tuple[int, int],
                    cfg: dataflow.TilingConfig = CODR_TILING,
                    per_layer_tiling: bool = False
                    ) -> list[tuple[str, dataflow.AccessCounts]]:
        """Per-layer CoDR SRAM access estimates for one sample, tracking
        spatial dims through the steps (:meth:`layer_shapes`).
        ``per_layer_tiling`` counts each layer under its own effective
        encode tile geometry."""
        out = []
        for layer, shape in self.layer_shapes(input_hw):
            st = layer.stats()
            tiling = dataflow.codr_tiling(st.t_m, st.t_n, base=cfg) \
                if per_layer_tiling else cfg
            out.append((layer.name, dataflow.codr_accesses(
                shape, tiling, float(layer.code.total_bits),
                float(st.n_unique), float(st.n_nonzero))))
        return out


def paper_model_shapes(net: str = "alexnet", n_conv: int = 2,
                       ri: int | None = None, ci: int | None = None
                       ) -> list[ConvShape]:
    """Channel/kernel geometry of the first ``n_conv`` conv layers of a
    paper CNN, optionally with reduced spatial dims on the first layer
    (channel structure — what UCR compresses — is untouched)."""
    from repro_torch.configs.paper_cnns import PAPER_CNNS
    shapes = []
    for s in PAPER_CNNS[net][:n_conv]:
        use_ri = ri if ri is not None else s.ri
        use_ci = ci if ci is not None else s.ci
        shapes.append(ConvShape(s.m, s.n, s.rk, s.ck, use_ri, use_ci,
                                s.stride))
        ri = ci = None                      # only the first layer is forced
    return shapes


def build_random_model(shapes: Sequence[ConvShape], n_out: int, *,
                       density: float = 0.4, rng=None,
                       t_m: int = 4, t_n: int = 4,
                       activation: str | None = "relu",
                       decode_source: str = "bitstream",
                       device=None) -> CodrModel:
    """conv×len(shapes) → linear model with paper-style sparse Gaussian
    weights; consecutive shapes must be spatially consistent.  A shim
    over ``ModelSpec.from_shapes`` + ``compile`` (the same draws as the
    reference's for the same ``rng``); ``device`` as ``compile``'s."""
    from repro_torch.core import api
    spec = api.ModelSpec.from_shapes(shapes, n_out=n_out, density=density,
                                     rng=rng, activation=activation)
    cfg = api.EncodeConfig(t_m=t_m, t_n=t_n, decode_source=decode_source)
    return api.compile(spec, cfg, device=device).model
