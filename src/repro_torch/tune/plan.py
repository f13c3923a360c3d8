"""The tune-plan artifact: per-layer encode configs + predicted costs —
the port's copy of ``repro.tune.plan``.  The JSON is the reference's
field for field, so a plan written by either package loads in the other.

A :class:`TunePlan` is what the per-layer search (:mod:`repro_torch.tune.autotune`)
emits and what ``codr.compile(spec, plan=...)`` /
``codr.compile_params(params, plan=...)`` consume: a mapping from layer
name (or pytree leaf path) to the :class:`~repro.core.api.EncodeConfig`
that layer should encode under, carrying the tuner's predicted cost
numbers alongside so the compiled model's measured stats can be checked
against them (``CompiledModel.layer_table``).

Plans serialize to JSON (``save``/``load``) and cache by a **weight-stats
fingerprint**: layer geometry + quantized-value statistics (density,
unique-level count, magnitude histogram).  Two layers with the same
fingerprint have identical candidate cost tables, so re-tuning a model
with repeated layer shapes — or re-running the tuner across sessions —
hits the cache instead of re-scoring (docs/DESIGN.md §2.1).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from repro_torch.core.api import EncodeConfig
from repro_torch.core.ucr import quantize_int8

__all__ = ["TuneBudget", "LayerPlan", "TunePlan", "layer_fingerprint"]


@dataclasses.dataclass(frozen=True)
class TuneBudget:
    """What the search optimizes and what it must not exceed.

    ``max_rel_err``       per-layer quality gate: candidates whose
                          relative weight-quantization error exceeds
                          this are infeasible (``None`` = any error).
    ``target_bits_per_weight``  model-wide storage target: after the
                          per-layer optimum, the search greedily trades
                          quality headroom for bits until the total
                          measured-size prediction meets the target (or
                          no feasible move remains).
    ``max_sram_accesses`` model-wide predicted-SRAM ceiling, same greedy
                          semantics as the bits target.
    ``objective``         what each layer minimizes once feasible:
                          ``"sram"`` (default — the paper's §IV metric),
                          ``"bits"`` (Fig. 6 metric), or ``"energy"``
                          (§V).  Ties break on bits, then n_unique.
    """

    max_rel_err: float | None = 0.05
    target_bits_per_weight: float | None = None
    max_sram_accesses: float | None = None
    objective: str = "sram"

    def __post_init__(self):
        if self.objective not in ("sram", "bits", "energy"):
            raise ValueError(f"objective must be 'sram', 'bits' or "
                             f"'energy', got {self.objective!r}")
        for field in ("max_rel_err", "target_bits_per_weight",
                      "max_sram_accesses"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"{field} must be positive or None, "
                                 f"got {v}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fingerprint(kind: str, shape, stride: int, hist, n_levels: int,
                 scale: float) -> str:
    """The hash behind :func:`layer_fingerprint`, from the statistics of
    the int8 image: its 32-bin magnitude histogram, its level count and
    its scale (``tune_params`` computes them with torch on the leaf's
    device)."""
    h = hashlib.sha256()
    h.update(repr((kind, tuple(int(d) for d in shape), int(stride),
                   tuple(int(c) for c in hist), int(n_levels),
                   float(scale))).encode())
    return h.hexdigest()[:16]


def layer_fingerprint(w: np.ndarray, kind: str, stride: int = 1) -> str:
    """Geometry + weight-stats cache key for one layer.

    Hashes the shape/kind/stride plus statistics of the *quantized*
    tensor — int8 magnitude histogram, density, unique-level count —
    which are exactly the quantities every candidate score is a function
    of.  Float payloads with the same int8 image share a key on purpose.
    """
    w = np.asarray(w, dtype=np.float32)
    q, scale = quantize_int8(w)
    hist = np.bincount(((q.astype(np.int16) + 128) // 8).ravel(),
                       minlength=32)
    return _fingerprint(kind, w.shape, stride, hist, len(np.unique(q)),
                        float(np.asarray(scale)))


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's chosen config + the tuner's predicted costs for it."""

    name: str
    kind: str                        # "conv" | "linear"
    config: EncodeConfig
    n_weights: int
    predicted_bits: float            # exact when unsampled
    predicted_sram: float            # total SRAM accesses, CoDR dataflow
    predicted_energy_uj: float
    rel_err: float                   # relative weight quantization error
    fingerprint: str
    from_cache: bool = False

    @property
    def predicted_bits_per_weight(self) -> float:
        return self.predicted_bits / max(self.n_weights, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["config"] = self.config.metadata()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LayerPlan":
        cfg = dict(d["config"])
        if cfg.get("rle_params") is not None:
            cfg["rle_params"] = tuple(cfg["rle_params"])
        d = dict(d, config=EncodeConfig(**cfg))
        d.pop("predicted_bits_per_weight", None)
        return cls(**d)


class TunePlan:
    """Per-layer encode configs, consumable by ``codr.compile(plan=...)``.

    ``config_for(name, default)`` is the whole runtime contract — any
    layer the plan does not name encodes under the caller's default, so
    the empty plan is exactly the global-config path.
    """

    def __init__(self, layers: dict[str, LayerPlan] | None = None, *,
                 default: EncodeConfig | None = None,
                 budget: TuneBudget | None = None,
                 meta: dict | None = None):
        self.layers: dict[str, LayerPlan] = dict(layers or {})
        self.default = EncodeConfig() if default is None else default
        self.budget = TuneBudget() if budget is None else budget
        self.meta = dict(meta or {})

    # -- the compile-side contract ------------------------------------------
    def config_for(self, name: str,
                   default: EncodeConfig | None = None) -> EncodeConfig:
        lp = self.layers.get(name)
        if lp is not None:
            return lp.config
        return self.default if default is None else default

    def __len__(self) -> int:
        return len(self.layers)

    def __contains__(self, name: str) -> bool:
        return name in self.layers

    # -- predicted totals ----------------------------------------------------
    def predicted_total_sram(self) -> float:
        return sum(lp.predicted_sram for lp in self.layers.values())

    def predicted_total_bits(self) -> float:
        return sum(lp.predicted_bits for lp in self.layers.values())

    def predicted_bits_per_weight(self) -> float:
        n = sum(lp.n_weights for lp in self.layers.values())
        return self.predicted_total_bits() / max(n, 1)

    def max_rel_err(self) -> float:
        return max((lp.rel_err for lp in self.layers.values()), default=0.0)

    def table(self) -> str:
        hdr = (f"{'layer':<16} {'kind':<7} {'U':>4} {'t_m':>5} "
               f"{'pred b/w':>9} {'pred sram':>12} {'pred uJ':>10} "
               f"{'rel err':>8} {'cached':>7}")
        lines = [hdr, "-" * len(hdr)]
        for lp in self.layers.values():
            t_m = lp.config.t_m if lp.kind == "conv" else lp.config.t_m_linear
            lines.append(
                f"{lp.name:<16} {lp.kind:<7} {lp.config.n_unique:>4} "
                f"{t_m:>5} {lp.predicted_bits_per_weight:9.2f} "
                f"{lp.predicted_sram:12.3e} {lp.predicted_energy_uj:10.4f} "
                f"{lp.rel_err:8.4f} {str(lp.from_cache):>7}")
        lines.append(f"{'total':<16} {'':<7} {'':>4} {'':>5} "
                     f"{self.predicted_bits_per_weight():9.2f} "
                     f"{self.predicted_total_sram():12.3e}")
        return "\n".join(lines)

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": 1,
            "default": self.default.metadata(),
            "budget": self.budget.as_dict(),
            "meta": self.meta,
            "layers": {name: lp.as_dict()
                       for name, lp in self.layers.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "TunePlan":
        default = dict(d["default"])
        if default.get("rle_params") is not None:
            default["rle_params"] = tuple(default["rle_params"])
        return cls(
            {name: LayerPlan.from_dict(lp)
             for name, lp in d["layers"].items()},
            default=EncodeConfig(**default),
            budget=TuneBudget(**d["budget"]),
            meta=d.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "TunePlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def __repr__(self) -> str:
        return (f"TunePlan({len(self.layers)} layers, "
                f"{self.predicted_bits_per_weight():.2f} pred bits/weight, "
                f"objective={self.budget.objective!r})")
