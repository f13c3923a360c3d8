"""Step functions + abstract state + shardings for every (arch × shape ×
mesh) cell — the port's ``repro.launch.steps``, shared by the dry-run
and the card's mesh checks.

Abstract state is meta tensors (``torch.device("meta")``: shapes and
dtypes, nothing allocated), the counterpart of the reference's
``jax.eval_shape`` / ``ShapeDtypeStruct``.  Specs are the reference's,
rule for rule (:func:`batch_spec`, :func:`_cache_leaf_spec`,
:func:`repro_torch.sharding.rules.param_spec`).

:func:`build_cell` returns ``(step, arg_shapes, in_shardings, None)``
as the reference does.  Where the reference hands ``in_shardings`` to
``jax.jit``, the returned :class:`PlacedStep` places its arguments
itself at every call, then runs the step under the mesh context:

* the leaves a lane consumes sharded are held as blocks on their
  devices (:class:`~repro_torch.sharding.rules.ShardedTensor`, under
  the lane's own spec): the GQA caches under ``decode_attn="dist"``
  (sequence over ``model``, batch over the batch axes where it
  divides) and, in prefill and decode, the expert stacks under the
  expert-parallel lane (experts over ``model``) or the 2-D lane
  (``P("model", None, "data")`` / ``P("model", "data", None)``).  A
  leaf already held so is not moved again, so a decode loop that passes
  its cache back places it once;
* every other leaf stays whole on the mesh's first device, its spec
  recorded in ``in_shardings`` only.  In the train step that includes
  the expert stacks: autograd and AdamW run over whole leaves, and the
  expert lane reads its slices as views.

``int4`` serving weights are held as int8 on the meta device (torch has
no 4-bit tensor dtype) and accounted at 0.5 bytes a weight, the
reference's ``bpp``; the dry-run's byte counts use
:data:`WEIGHT_BYTES`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tree import (leaves, map_leaves, map_with_path,
                                   unflatten_like)
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sharding.rules import (Mesh, NamedSharding, P, ShardCtx,
                                        ShardedTensor, named_sharding_tree,
                                        place, use_ctx)

__all__ = ["SERVE_DTYPE", "TRAIN_PARAM_DTYPE", "WEIGHT_BYTES",
           "CellOptions", "batch_axes", "batch_spec", "input_specs",
           "batch_shardings", "cache_shardings", "abstract_params",
           "abstract_opt_state", "abstract_cache", "make_train_step",
           "make_prefill_step", "make_decode_step", "serve_param_fsdp",
           "PlacedStep", "build_cell"]

SERVE_DTYPE = torch.bfloat16
TRAIN_PARAM_DTYPE = torch.bfloat16      # bf16 params + fp32 master in opt

# int4 is held as int8 on meta, accounted at WEIGHT_BYTES["int4"]
_WEIGHT_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8,
                  "int4": torch.int8}
WEIGHT_BYTES = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}
_CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
_EXPERT_LEAVES = ("w_experts_in", "w_experts_gate", "w_experts_out")


@dataclasses.dataclass(frozen=True)
class CellOptions:
    """Levers applied at the step boundary (model-level levers —
    decode_attn / moe_decode_2d / block_causal — live on ModelConfig).

    ``serve_weight_dtype`` — storage dtype of ≥2-D serving weights
    (int8 = weight-only quantization; int4 ≈ the CoDR U16 unique-index
    pack: 4 bits/weight).  ``cache_dtype`` — KV-cache storage dtype.
    """

    serve_weight_dtype: str = "bf16"
    cache_dtype: str = "bf16"

    def tag(self) -> str:
        """The non-default levers as a name suffix (``"wint8-cint8"``;
        ``""`` at the defaults)."""
        parts = []
        if self.serve_weight_dtype != "bf16":
            parts.append(f"w{self.serve_weight_dtype}")
        if self.cache_dtype != "bf16":
            parts.append(f"c{self.cache_dtype}")
        return "-".join(parts)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh: Mesh, batch_size: int) -> P:
    axes = batch_axes(mesh)
    total = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and batch_size % total == 0:
        return P(axes)
    # fall back to the largest prefix of the axes that divides
    for cut in range(len(axes) - 1, 0, -1):
        total = math.prod(mesh.shape[a] for a in axes[:cut])
        if batch_size % total == 0:
            return P(axes[:cut])
    return P()


# ---------------------------------------------------------------------------
# input specs (meta tensors — never allocate)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train" or shape.kind == "prefill":
        specs = {}
        if cfg.family == "encdec":
            # encoder consumes S frames; decoder gets a short target prefix
            specs["prefix"] = _meta((b, s, cfg.d_model), torch.bfloat16)
            specs["tokens"] = _meta((b, min(s, 1024)), torch.int32)
        elif cfg.frontend:
            fs = min(cfg.frontend_seq, s // 2)
            specs["prefix"] = _meta((b, fs, cfg.d_model), torch.bfloat16)
            specs["tokens"] = _meta((b, s - fs), torch.int32)
        else:
            specs["tokens"] = _meta((b, s), torch.int32)
        return specs
    # decode: one new token against a seq_len cache
    return {"token": _meta((b,), torch.int32),
            "pos": _meta((), torch.int32)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    specs = input_specs(cfg, shape)
    bspec = batch_spec(mesh, shape.global_batch)
    out = {}
    for k, v in specs.items():
        if k == "pos":
            out[k] = NamedSharding(mesh, P())
        else:
            out[k] = NamedSharding(mesh, P(*(bspec + (None,) * (v.dim() - 1))))
    return out


# ---------------------------------------------------------------------------
# cache shardings
# ---------------------------------------------------------------------------

def _cache_leaf_spec(shape: tuple[int, ...], mesh: Mesh, batch: int,
                     stacked: bool) -> P:
    """KV caches (B,S,H,D) / (B,S,C); recurrent states (B,...).
    ``stacked`` leaves carry a leading (n_periods,) layer axis that stays
    unsharded."""
    bspec = batch_spec(mesh, batch)
    baxes = bspec[0] if bspec else None
    msize = mesh.shape.get("model", 1)
    ndim = len(shape)
    spec: list = [None] * ndim
    base = 1 if stacked else 0
    dims = shape[base:]
    if baxes is not None:
        covered = math.prod(mesh.shape[a] for a in
                            (baxes if isinstance(baxes, tuple)
                             else (baxes,)))
        if dims and dims[0] % covered == 0 and covered > 1:
            spec[base] = baxes
    if len(dims) >= 3 and dims[1] > 1024:
        # (B, S, ...) long-sequence cache: heads over model if they fit,
        # else sequence over model
        if len(dims) == 4 and dims[2] % msize == 0 and msize > 1:
            spec[base + 2] = "model"
        elif dims[1] % msize == 0 and msize > 1:
            spec[base + 1] = "model"
    elif len(dims) >= 2 and msize > 1:
        # recurrent state: model on the widest trailing dim that divides
        widest = int(np.argmax(dims[1:])) + 1
        if dims[widest] % msize == 0:
            spec[base + widest] = "model"
    return P(*spec)


def cache_shardings(cache_shapes, mesh: Mesh, batch: int):
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, _cache_leaf_spec(
            tuple(leaf.shape), mesh, batch, path.startswith("stack"))),
        cache_shapes)


# ---------------------------------------------------------------------------
# abstract params / optimizer state / cache
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: ``init_params`` draws every
    leaf on the meta device (shapes only)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig, dtype=TRAIN_PARAM_DTYPE):
    """Meta param tree.  Integer dtypes apply only to ≥2-D projection
    weights; norms/biases stay bf16."""
    api = get_model(cfg)
    shapes = api.init_params(_MetaGenerator(), cfg)
    integer = not dtype.is_floating_point

    def leaf(s):
        return _meta(s.shape, torch.bfloat16 if integer and s.dim() < 2
                     else dtype)

    return map_leaves(leaf, shapes)


def abstract_opt_state(params, opt_cfg: AdamWConfig):
    return adamw_init(params, opt_cfg)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   dtype=SERVE_DTYPE):
    api = get_model(cfg)
    return api.init_cache(cfg, shape.global_batch, shape.seq_len,
                          dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, mesh: Mesh,
                    opt_cfg: AdamWConfig | None = None):
    """``(params, opt_state, batch) → (params, opt_state, metrics)``:
    the loss and its gradients by autograd, then AdamW (new trees, as
    the reference's), under the mesh context."""
    opt_cfg = opt_cfg or AdamWConfig()
    api = get_model(cfg)
    ctx = ShardCtx(mesh)

    def train_step(params, opt_state, batch):
        with use_ctx(ctx):
            p_leaves = [t.detach().requires_grad_() for t in leaves(params)]
            with torch.enable_grad():
                loss = api.train_loss(unflatten_like(params, p_leaves),
                                      batch, cfg)
                grads = torch.autograd.grad(loss, p_leaves)
            params, opt_state, metrics = adamw_update(
                params, unflatten_like(params, grads), opt_state, opt_cfg)
            metrics["loss"] = loss.detach()
            return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh: Mesh):
    api = get_model(cfg)
    ctx = ShardCtx(mesh)

    def prefill_step(params, batch):
        with use_ctx(ctx), torch.no_grad():
            return api.prefill(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh: Mesh):
    api = get_model(cfg)
    ctx = ShardCtx(mesh)

    def serve_step(params, cache, token, pos):
        with use_ctx(ctx), torch.no_grad():
            return api.decode_step(params, cache, token, pos, cfg)

    return serve_step


# ---------------------------------------------------------------------------
# placement: the counterpart of jit(in_shardings=)
# ---------------------------------------------------------------------------

class PlacedStep:
    """A step that places its arguments before it runs: for argument i,
    ``holds[i](path)`` names the spec a lane consumes that leaf under
    (held as blocks) or ``None`` (whole on the mesh's first device)."""

    def __init__(self, fn, mesh: Mesh, holds):
        self.fn, self.mesh, self.holds = fn, mesh, holds

    def place_args(self, *args) -> tuple:
        return tuple(self._place(a, h) for a, h in zip(args, self.holds))

    def _place(self, tree, hold):
        first = self.mesh.first_device

        def one(path, leaf):
            spec = hold(path) if hold is not None else None
            if spec is not None and isinstance(leaf, (torch.Tensor,
                                                      ShardedTensor)):
                return place(leaf, spec, self.mesh)
            if isinstance(leaf, ShardedTensor):
                return leaf.full(first)
            if isinstance(leaf, torch.Tensor):
                return leaf.to(first)
            return leaf                  # ints, packed leaves

        return map_with_path(one, tree)

    def __call__(self, *args):
        return self.fn(*self.place_args(*args))


def _expert_hold(cfg: ModelConfig, mesh: Mesh, kind: str):
    """The spec the expert lane of this cell consumes each stacked
    expert leaf under (``None``: no expert lane runs)."""
    msize, dsize = mesh.shape.get("model", 1), mesh.shape.get("data", 1)
    e = cfg.n_experts
    if not e or msize <= 1 or e % msize:
        return lambda path: None
    two_d = (cfg.moe_decode_2d and kind == "decode" and dsize > 1
             and cfg.moe_d_ff % dsize == 0)

    def hold(path):
        name = path.split("/")[-1]
        if name not in _EXPERT_LEAVES:
            return None
        lead = (None,) if "stack" in path else ()
        if not two_d:
            return P(*lead, "model", None, None)
        if name == "w_experts_out":
            return P(*lead, "model", "data", None)
        return P(*lead, "model", None, "data")

    return hold


def _dist_cache_hold(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig):
    """The spec the ``dist`` lane consumes each GQA cache leaf under
    (sequence over ``model``, batch over the batch axes where it
    divides); ``None`` where the lane does not run."""
    msize = mesh.shape.get("model", 1)
    if (cfg.decode_attn != "dist" or msize <= 1
            or shape.seq_len % msize):
        return lambda path: None
    ctx = ShardCtx(mesh)
    total = math.prod(ctx.axis_size(a) for a in batch_axes(mesh))
    bentry = ctx.batch_spec if shape.global_batch % total == 0 else None
    if cfg.family == "encdec":
        gqa = ("self/",)
    elif cfg.use_mla:
        gqa = ()
    else:
        gqa = tuple(f"stack/b{i}/" for i, (kind, _) in
                    enumerate(cfg.layer_plan()) if kind == "attn")
        gqa += ("prologue/",) if cfg.n_dense_layers else ()

    def hold(path):
        if not path.startswith(gqa):
            return None
        lead = (None,) if not path.startswith("prologue/") else ()
        return P(*lead, bentry, "model", None, None)

    return hold


# ---------------------------------------------------------------------------
# full cell assembly (used by the dry-run and the card's mesh checks)
# ---------------------------------------------------------------------------

def serve_param_fsdp(cfg: ModelConfig, mesh: Mesh,
                     bytes_per_param: float = 2.0) -> bool:
    """2-D-shard serving weights when a model-axis-only shard would not
    fit comfortably (8 GB a device, the reference's threshold)."""
    msize = mesh.shape.get("model", 1)
    bytes_per_chip = cfg.param_count() * bytes_per_param / max(msize, 1)
    return bytes_per_chip > 8e9


def build_cell(arch, shape: ShapeConfig, mesh: Mesh,
               opt_cfg: AdamWConfig | None = None,
               options: CellOptions | None = None):
    """Returns (step, arg_shapes, in_shardings, out_shardings_hint):
    ``step`` a :class:`PlacedStep`, ``arg_shapes`` meta trees."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    options = options or CellOptions()
    serve_dtype = _WEIGHT_DTYPES[options.serve_weight_dtype]
    cache_dtype = _CACHE_DTYPES[options.cache_dtype]
    if shape.kind == "train":
        params = abstract_params(cfg, TRAIN_PARAM_DTYPE)
        opt_cfg = opt_cfg or AdamWConfig()
        opt = abstract_opt_state(params, opt_cfg)
        batch = input_specs(cfg, shape)
        p_sh = named_sharding_tree(params, mesh, fsdp=True)
        # moments/master shard like params
        o_sh = {
            "m": named_sharding_tree(opt["m"], mesh, fsdp=True),
            "v": named_sharding_tree(opt["v"], mesh, fsdp=True),
            "step": NamedSharding(mesh, P()),
        }
        if "master" in opt:
            o_sh["master"] = named_sharding_tree(opt["master"], mesh,
                                                 fsdp=True)
        b_sh = batch_shardings(cfg, shape, mesh)
        fn = PlacedStep(make_train_step(cfg, mesh, opt_cfg), mesh,
                        (None, None, None))
        return fn, (params, opt, batch), (p_sh, o_sh, b_sh), None

    bpp = WEIGHT_BYTES[options.serve_weight_dtype]
    fsdp = serve_param_fsdp(cfg, mesh, bpp)
    params = abstract_params(cfg, serve_dtype)
    moe2d = bool(cfg.moe_decode_2d and shape.kind == "decode")
    p_sh = named_sharding_tree(params, mesh, fsdp=fsdp, moe2d=moe2d)
    experts = _expert_hold(cfg, mesh, shape.kind)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        b_sh = batch_shardings(cfg, shape, mesh)
        fn = PlacedStep(make_prefill_step(cfg, mesh), mesh, (experts, None))
        return fn, (params, batch), (p_sh, b_sh), None

    # decode
    cache = abstract_cache(cfg, shape, dtype=cache_dtype)
    c_sh = cache_shardings(cache, mesh, shape.global_batch)
    specs = input_specs(cfg, shape)
    tok_sh = NamedSharding(mesh, batch_spec(mesh, shape.global_batch))
    pos_sh = NamedSharding(mesh, P())
    fn = PlacedStep(make_decode_step(cfg, mesh), mesh,
                    (experts, _dist_cache_hold(cfg, mesh, shape), None,
                     None))
    return (fn, (params, cache, specs["token"], specs["pos"]),
            (p_sh, c_sh, tok_sh, pos_sh), None)
