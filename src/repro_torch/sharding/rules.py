"""Sharding rules: one place that knows the mesh axes — the port's
``repro.sharding.rules``.

Axes (transformer serving stack, as in the reference):
  * ``pod``   — outer pure-DP axis (multi-pod).
  * ``data``  — FSDP axis: batch + parameter/optimizer-state sharding.
  * ``model`` — TP axis: attention heads / FFN hidden / MoE experts / vocab.

The port's mesh is a single-controller mesh, as JAX's is: one process
holds a named N-D :class:`Mesh` whose positions are ``torch.device``\\ s
(an object array), and a lane that runs "on the mesh" loops over the
positions it needs, each block on its position's device.  A device may
fill more than one position — ``cuda:0`` ×4 on one H100, ``cpu`` ×4 in
the tests — which is the port's counterpart of
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.  A *meta* mesh
(:meth:`Mesh.meta`) fills every position with ``torch.device("meta")``:
the dry-run's production meshes, shape only.

Models are mesh-agnostic, as in the reference: layers call
:func:`maybe_constrain` with logical specs.  The reference hands the
resolved spec to GSPMD (``with_sharding_constraint``); eager torch has no
partitioner, so the port resolves the spec the same way
(:func:`resolve_spec`) and returns ``x`` unchanged — what the constraint
guarantees is the values, and those are unchanged.  The lanes that the
reference writes as ``shard_map`` bodies (the sequence-parallel decode
attention, the expert-parallel and 2-D MoE) consume their operands as
blocks (:class:`ShardedTensor`, :func:`region`) and count the bytes of
their combines (:func:`count_collectives`).

:func:`param_spec` / :func:`named_sharding_tree` are the reference's
path-pattern rules line for line; :class:`P` compares equal, as a tuple,
to ``jax.sharding.PartitionSpec``.

The CoDR engine adds one more axis: ``tile`` — the output-tile axis the
``sharded`` backend (:class:`repro_torch.core.backends.ShardedBackend`)
partitions each layer's decoded tile stack over.  Its mesh is 1-D, a
tuple of devices (:func:`tile_mesh`); :func:`shard_leading` zero-pads an
array's leading axis to a multiple of D and places slice i on device i.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading

import numpy as np
import torch

from repro_torch.core.engine import resolve_device

__all__ = ["ENGINE_TILE_AXIS", "tile_mesh", "pad_to_multiple",
           "shard_leading", "P", "Mesh", "NamedSharding", "ShardCtx",
           "set_ctx", "current_ctx", "use_ctx", "resolve_spec",
           "maybe_constrain", "param_spec", "named_sharding_tree",
           "ShardedTensor", "place", "region", "block_shape",
           "per_device_bytes", "COLLECTIVES", "count_collectives",
           "record_collective", "batch_split", "positions"]

_STATE = threading.local()

# the CoDR engine's output-tile model-parallel axis (sharded backend)
ENGINE_TILE_AXIS = "tile"


# ---------------------------------------------------------------------------
# the engine's 1-D tile mesh
# ---------------------------------------------------------------------------

def tile_mesh(devices=None, *, device=None) -> tuple[torch.device, ...]:
    """1-D mesh over ``devices`` (repeats allowed).  With ``devices``
    ``None`` the mesh follows ``device``: every card for the card (the
    default; raises when there is none), ``(cpu,)`` for the CPU.  One
    device is a valid 1-element mesh, the single-device fallback."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if not mesh:
            raise ValueError("a tile mesh needs at least one device")
        return mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (>= k for n == 0)."""
    return max(-(-n // k), 1) * k


def shard_leading(x, mesh) -> tuple[torch.Tensor, ...]:
    """``x`` (array or tensor) split over its leading axis, slice i on
    ``mesh[i]``.  The leading axis is zero-padded up to a multiple of
    the mesh size first (a ragged tile stack still shards; the pad rows
    compute zeros the caller crops away), so any ``n >= 1`` works on any
    device count.  Returns the D shards, each ``(n_pad / D, ...)``."""
    x = torch.as_tensor(x)
    d = len(mesh)
    pad = pad_to_multiple(x.shape[0], d) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return tuple(part.to(dev).contiguous()
                 for part, dev in zip(torch.chunk(x, d), mesh))


# ---------------------------------------------------------------------------
# the named mesh, partition specs, the context
# ---------------------------------------------------------------------------

def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per dimension — ``None``
    (replicated), a mesh axis name, or a tuple of names (the first
    major).  A one-name tuple is stored as the name, as JAX's
    ``PartitionSpec`` normalizes it, so ``tuple(P(...))`` equals
    ``tuple(jax.sharding.PartitionSpec(...))`` for the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_norm_entry(e) for e in entries))

    def __add__(self, other):
        return P(*tuple(self), *tuple(other))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (major first)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Mesh:
    """A named N-D mesh: ``axis_names``, ``shape`` (an ordered
    ``{name: size}``, as JAX's ``mesh.shape``) and ``devices``, an
    object array of ``torch.device`` of that shape (a device may repeat).
    """

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = torch.device(given[idx])
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names) or devs.size == 0:
            raise ValueError(f"devices of shape {devs.shape} for axes "
                             f"{axis_names}")
        self.devices = devs
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devs.shape))

    @classmethod
    def meta(cls, shape, axis_names) -> "Mesh":
        """A mesh of ``shape`` whose every position is the meta device
        (shape only; nothing placed on it allocates)."""
        return cls(np.full(tuple(shape), torch.device("meta"), dtype=object),
                   axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_meta(self) -> bool:
        return all(d.type == "meta" for d in self.devices.flat)

    @property
    def first_device(self) -> torch.device:
        """Where the leaves that no lane consumes sharded live whole."""
        return self.devices.flat[0]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        kind = "meta" if self.is_meta else sorted(
            {str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, {kind})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s fields)."""
    mesh: Mesh
    spec: P


@dataclasses.dataclass
class ShardCtx:
    mesh: Mesh
    batch_axes: tuple[str, ...] = ("pod", "data")   # axes present → used
    fsdp_axis: str = "data"
    model_axis: str = "model"

    @property
    def batch_spec(self):
        axes = tuple(a for a in self.batch_axes if a in self.mesh.axis_names)
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    def axis_size(self, name: str) -> int:
        if name in self.mesh.axis_names:
            return self.mesh.shape[name]
        return 1


def set_ctx(ctx: ShardCtx | None) -> None:
    _STATE.ctx = ctx


def current_ctx() -> ShardCtx | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: ShardCtx | None):
    prev = current_ctx()
    set_ctx(ctx)
    try:
        yield ctx
    finally:
        set_ctx(prev)


def resolve_spec(ctx: ShardCtx, *spec) -> P:
    """The reference's resolution of a logical spec: 'batch' → the batch
    axes, a mesh axis name → itself, anything else → replicated."""
    resolved = []
    for s in spec:
        if s == "batch":
            resolved.append(ctx.batch_spec)
        elif s in (None,):
            resolved.append(None)
        elif isinstance(s, str) and s in ctx.mesh.axis_names:
            resolved.append(s)
        else:
            resolved.append(None)
    return P(*resolved)


def maybe_constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` hint: under a context
    the spec is resolved as the reference resolves it, and ``x`` comes
    back unchanged (eager torch has no partitioner; the constraint moves
    no value).  Outside a context, the identity."""
    ctx = current_ctx()
    if ctx is not None:
        resolve_spec(ctx, *spec)
    return x


# ---------------------------------------------------------------------------
# parameter sharding rules (path-pattern → PartitionSpec)
# ---------------------------------------------------------------------------

def param_spec(path: str, shape: tuple[int, ...], mesh: Mesh,
               *, fsdp: bool = True, moe2d: bool = False) -> P:
    """PartitionSpec for a parameter by its tree path — the reference's
    rules: 2-D weights ``(d_in, d_out)`` are column-parallel (out over
    ``model``) when they *enter* a parallel region (qkv/up/gate),
    row-parallel (in over ``model``) when they *leave* one
    (o_proj/down).  FSDP shards the complementary dimension over
    ``data``.  Stacked-layer leading axes are never sharded.  MoE expert
    stacks shard experts over ``model`` (``moe2d``: the expert-FFN
    hidden dim over ``data``).  Embeddings shard vocab over ``model``.
    Any dim not divisible by its axis is left unsharded."""
    dsize = mesh.shape.get("data", 1)
    msize = mesh.shape.get("model", 1)
    name = path.split("/")[-1]
    stacked = "stack" in path          # leading (n_periods, ...) axis

    def fits(dim: int, size: int) -> bool:
        return size > 1 and dim % size == 0

    ndim = len(shape)
    spec: list = [None] * ndim
    base = 1 if stacked else 0         # skip the stack axis

    def setax(i: int, axis: str, size: int):
        if 0 <= i < ndim and spec[i] is None and fits(shape[i], size):
            spec[i] = axis

    if name in ("embed", "out_embed", "lm_head"):
        # (V, D): vocab over model, D over data (FSDP)
        setax(base, "model", msize)
        if fsdp:
            setax(base + 1, "data", dsize)
    elif name in ("w_experts_in", "w_experts_gate", "w_experts_out"):
        # (E, d_in, d_out): experts over model; FSDP over data on d_in;
        # moe2d: the expert-FFN hidden dim over data (the 2-D lane's
        # blocks)
        setax(base, "model", msize)
        if moe2d and name in ("w_experts_in", "w_experts_gate"):
            setax(base + 2, "data", dsize)
        elif fsdp or moe2d:
            setax(base + 1, "data", dsize)
    elif name.endswith(("q_proj", "k_proj", "v_proj", "up_proj", "gate_proj",
                        "in_proj", "qkv_proj", "kv_a_proj", "q_a_proj",
                        "q_b_proj", "kv_b_proj")):
        # column parallel (d_in, d_out): out over model
        setax(base + 1, "model", msize)
        if fsdp:
            setax(base, "data", dsize)
    elif name.endswith(("o_proj", "down_proj", "out_proj")):
        # row parallel: in over model
        setax(base, "model", msize)
        if fsdp:
            setax(base + 1, "data", dsize)
    elif ndim - base >= 2:
        # generic 2-D: FSDP over data on d_in
        if fsdp:
            setax(base, "data", dsize)
    return P(*spec)


def named_sharding_tree(params, mesh: Mesh, *, fsdp: bool = True,
                        moe2d: bool = False):
    """Map a params tree (tensors, meta tensors or packed leaves — any
    leaf with a ``shape``) to :class:`NamedSharding`\\ s."""
    from repro_torch.core.tree import map_with_path
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(
            path, tuple(leaf.shape), mesh, fsdp=fsdp, moe2d=moe2d)),
        params)


# ---------------------------------------------------------------------------
# blocks: a tensor placed under a spec
# ---------------------------------------------------------------------------

def _splits(spec, mesh: Mesh, ndim: int) -> list[int]:
    """Blocks along each dimension."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [math.prod(mesh.shape[a] for a in _axes(e)) for e in spec]


def block_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of one block of a ``shape`` tensor under ``spec``
    (every sharded dim divides its axes, as the rules guarantee)."""
    out = []
    for dim, n in zip(shape, _splits(spec, mesh, len(shape))):
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"into {n} blocks under {spec}")
        out.append(dim // n)
    return tuple(out)


def _coords(spec, mesh: Mesh, ndim: int, index) -> tuple[int, ...]:
    """The block coordinates (one per dim) held at mesh position
    ``index``: the entry's axes read as one mixed-radix number, the
    first axis major (JAX's order)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    pos = dict(zip(mesh.axis_names, index))
    out = []
    for e in spec:
        c = 0
        for a in _axes(e):
            c = c * mesh.shape[a] + pos[a]
        out.append(c)
    return tuple(out)


class ShardedTensor:
    """A tensor of ``shape`` placed under ``spec`` on ``mesh``: its
    distinct blocks, each on the device of the first mesh position that
    holds it (``blocks[coords]``, one coordinate per dimension).  A block
    placed from a tensor on its own device is a view of it (no copy).
    Read whole with :meth:`full`; index a leading, unsharded axis with
    ``x[i]`` (a view of every block: the layer stack)."""

    def __init__(self, shape, dtype, spec, mesh: Mesh, blocks: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        self.mesh = mesh
        self.blocks = blocks

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def block_shape(self) -> tuple[int, ...]:
        return block_shape(self.shape, self.spec, self.mesh)

    @property
    def block_nbytes(self) -> int:
        return math.prod(self.block_shape) * _itemsize(self.dtype)

    def __getitem__(self, i: int) -> "ShardedTensor":
        if not isinstance(i, int) or self.spec[0] is not None:
            raise TypeError("a ShardedTensor indexes only an int on a "
                            "leading unsharded axis")
        return ShardedTensor(self.shape[1:], self.dtype, P(*self.spec[1:]),
                             self.mesh, {c[1:]: b[i]
                                         for c, b in self.blocks.items()})

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first
        device), assembled from the blocks."""
        dev = self.mesh.first_device if device is None else device
        return region(self, tuple(slice(None) for _ in self.shape)).to(dev)

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.spec}, {len(self.blocks)} blocks of "
                f"{self.block_shape})")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def place(x, spec, mesh: Mesh) -> ShardedTensor:
    """``x`` (a whole tensor, or a :class:`ShardedTensor` to re-place)
    under ``spec`` on ``mesh``: each distinct block on the device of the
    first position (in mesh order) that holds it."""
    if isinstance(x, ShardedTensor):
        if x.mesh == mesh and x.spec == P(*(tuple(spec) + (None,) * (
                x.ndim - len(spec)))):
            return x
        x = x.full()
    bshape = block_shape(x.shape, spec, mesh)
    blocks = {}
    for index in np.ndindex(mesh.devices.shape):
        c = _coords(spec, mesh, x.dim(), index)
        if c in blocks:
            continue
        sl = tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, bshape))
        blocks[c] = x[sl].to(mesh.devices[index])
    return ShardedTensor(x.shape, x.dtype, spec, mesh, blocks)


def region(x, index: tuple, *, write: bool = False) -> torch.Tensor:
    """The region ``x[index]`` (a tuple of slices over the leading dims)
    of a whole tensor or a :class:`ShardedTensor`.  A region inside one
    block is a view of that block; one that spans blocks is assembled
    (a copy), which ``write=True`` refuses — a lane writes only into
    blocks it owns."""
    if not isinstance(x, ShardedTensor):
        return x[index]
    index = tuple(index) + (slice(None),) * (x.ndim - len(index))
    bshape = x.block_shape
    spans = []
    for sl, n, dim in zip(index, bshape, x.shape):
        start, stop, step = sl.indices(dim)
        if step != 1 or stop <= start:
            raise ValueError(f"region {index} of {tuple(x.shape)}")
        spans.append((start, stop, n))
    per_dim = [range(a // n, (b - 1) // n + 1) for a, b, n in spans]
    if all(len(r) == 1 for r in per_dim):
        c = tuple(r[0] for r in per_dim)
        return x.blocks[c][tuple(slice(a - ci * n, b - ci * n)
                                 for (a, b, n), ci in zip(spans, c))]
    if write:
        raise ValueError(f"region {index} spans blocks of {x}; a lane "
                         f"writes only inside one block")

    def assemble(d: int, prefix: tuple, dev):
        if d == x.ndim:
            blk = x.blocks[prefix]
            return blk[tuple(slice(max(a, ci * n) - ci * n,
                                   min(b, (ci + 1) * n) - ci * n)
                             for (a, b, n), ci in zip(spans, prefix))].to(dev)
        return torch.cat([assemble(d + 1, prefix + (c,), dev)
                          for c in per_dim[d]], dim=d)

    return assemble(0, (), x.mesh.first_device)


def per_device_bytes(shape, spec, mesh: Mesh, bytes_per_elem: float
                     ) -> float:
    """Bytes one device holds of a ``shape`` leaf under ``spec``."""
    return math.prod(block_shape(shape, spec, mesh)) * bytes_per_elem


# ---------------------------------------------------------------------------
# collective accounting: what the lanes' combines move
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@contextlib.contextmanager
def count_collectives():
    """Count the combines the lanes run inside the block: yields
    ``{"by_op_bytes", "by_op_count", "total_bytes"}`` (filled when the
    block exits), the keys of the reference's HLO accounting.  Bytes
    are per participating device: each combine's result shape on one
    device, as the reference takes them from partitioned HLO."""
    log = {"by_op_bytes": dict.fromkeys(COLLECTIVES, 0.0),
           "by_op_count": dict.fromkeys(COLLECTIVES, 0), "total_bytes": 0.0}
    prev = getattr(_STATE, "collectives", None)
    _STATE.collectives = log
    try:
        yield log
    finally:
        _STATE.collectives = prev
        log["total_bytes"] = sum(log["by_op_bytes"].values())


def record_collective(op: str, shape, dtype) -> None:
    """One combine of ``op`` whose per-device result is ``shape`` of
    ``dtype`` (a no-op outside :func:`count_collectives`)."""
    log = getattr(_STATE, "collectives", None)
    if log is None:
        return
    log["by_op_bytes"][op] += math.prod(shape) * _itemsize(dtype)
    log["by_op_count"][op] += 1


def batch_split(ctx: ShardCtx, n: int) -> int:
    """How many blocks ``n`` rows split into over the context's batch
    axes: their product when it divides ``n``, else 1 (replicated), as
    the reference's lanes choose ``bspec``."""
    total = math.prod(ctx.axis_size(a) for a in _axes(ctx.batch_spec))
    return total if n % total == 0 else 1


def positions(ctx: ShardCtx, *axes: str):
    """Every coordinate dict over ``axes`` (C order, the first major)."""
    sizes = [range(ctx.axis_size(a)) for a in axes]
    for combo in itertools.product(*sizes):
        yield dict(zip(axes, combo))
