"""Cost-model-driven per-layer encoding search (paper §II-D, §III-C, Fig. 6)
— the port's copy of ``repro.tune.autotune``.  The CNN lane is NumPy on
the host, line for line the reference's (a sampled grid draws the same
vectors, so a plan is the same plan in both packages); the transformer
lane quantizes each leaf with torch on its own device.

The paper's point is that the U budget, tile geometry, and RLE field
widths must follow each layer's sparsity/repetition/similarity
structure.  This module makes that search a first-class artifact:

1. :func:`layer_candidate_table` scores every (n_unique, t_m[, rle])
   candidate per layer — **exact** encoded bits via
   :func:`repro_torch.core.rle.layer_bits_size_only` (statistically exact
   when vector-sampled on huge layers), SRAM accesses and energy via
   :func:`repro_torch.core.cost_model.layer_cost` under that candidate's tile
   geometry, and the relative weight-quantization error as the quality
   proxy.  Tables cache by weight-stats fingerprint
   (:func:`repro_torch.tune.plan.layer_fingerprint`).
2. :func:`select_plan` picks each layer's feasible cost-optimal
   candidate under a :class:`~repro_torch.tune.plan.TuneBudget`, then greedily
   trades quality headroom toward any model-wide bits/SRAM target.
3. :func:`best_global_config` scores every *single* global config over
   the same candidate table — the baseline a per-layer plan must beat.
4. :func:`tune_spec` = 1+2 end to end; :func:`tune_params` is the
   transformer-lane analogue over a params pytree (per-leaf U budgets
   for the ``PackedLinear`` pack path).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from repro_torch.core import cost_model, rle, ucr
from repro_torch.core.api import PACK_INCLUDE, EncodeConfig, ModelSpec
from repro_torch.core.dataflow import ConvShape, codr_tiling
from repro_torch.tune.plan import LayerPlan, TuneBudget, TunePlan, \
    _fingerprint, layer_fingerprint

__all__ = ["TuneGrid", "Candidate", "layer_candidate_table", "select_plan",
           "best_global_config", "tune_spec", "tune_params",
           "clear_cache", "cache_stats"]


@dataclasses.dataclass(frozen=True)
class TuneGrid:
    """The candidate space swept per layer.

    ``t_n`` stays a single value: the input-channel tile only reorders
    vector iteration — neither encoded bits nor the CoDR access counts
    depend on it — so sweeping it would triple the search for identical
    scores.  ``max_vectors`` bounds per-candidate UCR work on huge
    layers (sampled vectors, bits scaled back — same estimator as
    ``benchmarks.common.sampled_layer_vectors``); ``None`` scores every
    vector (exact, required when predicted bits must equal measured).
    """

    n_uniques: tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    t_ms_conv: tuple[int, ...] = (2, 4, 8, 16)
    t_ms_linear: tuple[int, ...] = (64, 128, 256, 512)
    t_n: int = 4
    rle_options: tuple[tuple[int, int, int] | None, ...] = (None,)
    max_vectors: int | None = 2000
    seed: int = 0

    def key(self) -> str:
        return repr((self.n_uniques, self.t_ms_conv, self.t_ms_linear,
                     self.t_n, self.rle_options, self.max_vectors,
                     self.seed))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored (layer × encode-config) point."""

    kind: str
    n_unique: int
    t_m: int                     # requested tile (conv t_m / t_m_linear)
    t_m_eff: int                 # clamped to the layer's M
    rle_params: tuple[int, int, int] | None
    n_weights: int
    bits: float                  # predicted encoded bits (exact unsampled)
    sram: float                  # predicted total SRAM accesses
    energy_uj: float
    rel_err: float               # quality proxy, depends on n_unique only

    @property
    def bits_per_weight(self) -> float:
        return self.bits / max(self.n_weights, 1)

    def config(self, base: EncodeConfig) -> EncodeConfig:
        kw = dict(n_unique=self.n_unique, rle_params=self.rle_params,
                  decode_source=base.decode_source)
        if self.kind == "conv":
            return EncodeConfig(t_m=self.t_m, t_n=base.t_n,
                                t_m_linear=base.t_m_linear, **kw)
        return EncodeConfig(t_m=base.t_m, t_n=base.t_n,
                            t_m_linear=self.t_m, **kw)


# --------------------------------------------------------------------------
# per-layer candidate scoring (cached by weight-stats fingerprint)
# --------------------------------------------------------------------------

_CACHE: dict[tuple[str, str], list[Candidate]] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def clear_cache() -> None:
    _CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0


def cache_stats() -> dict:
    return dict(_CACHE_STATS)


def _score_layer(w: np.ndarray, kind: str, shape: ConvShape,
                 grid: TuneGrid) -> list[Candidate]:
    w = np.asarray(w, dtype=np.float32)
    m = int(w.shape[0])
    kernel = int(np.prod(w.shape[2:])) if w.ndim > 2 else 1
    t_ms = grid.t_ms_conv if kind == "conv" else grid.t_ms_linear
    w_norm = float(np.linalg.norm(w)) or 1.0
    q0, scale = ucr.quantize_int8(w)
    rng = np.random.default_rng(grid.seed)
    out: list[Candidate] = []
    for u in grid.n_uniques:
        q = ucr.restrict_unique(q0, u) if u < 256 else q0
        deq = q.astype(np.float32) * float(np.asarray(scale))
        rel_err = float(np.linalg.norm(deq - w)) / w_norm
        for t_m in t_ms:
            t_m_eff = min(int(t_m), m)
            vecs = ucr.layer_ucr_vectors(q, t_m=t_m, t_n=grid.t_n)
            n_total = len(vecs)
            if grid.max_vectors is not None and n_total > grid.max_vectors:
                idx = rng.choice(n_total, grid.max_vectors, replace=False)
                sample = [vecs[i] for i in sorted(idx)]
                vec_scale = n_total / len(sample)
            else:
                sample, vec_scale = vecs, 1.0
            vector_len = t_m_eff * kernel
            n_unique_sum = vec_scale * sum(len(v.unique_vals)
                                           for v in sample)
            n_nonzero = vec_scale * sum(v.n_nonzero for v in sample)
            tiling = codr_tiling(t_m_eff, grid.t_n)
            for rp in grid.rle_options:
                payload = rle.layer_bits_size_only(sample, vector_len,
                                                   params=rp) \
                    - 3 * rle.HEADER_BITS
                bits = payload * vec_scale + 3 * rle.HEADER_BITS
                cost = cost_model.layer_cost(shape, tiling, bits,
                                             n_unique_sum, n_nonzero)
                out.append(Candidate(
                    kind=kind, n_unique=int(u), t_m=int(t_m),
                    t_m_eff=t_m_eff, rle_params=rp,
                    n_weights=int(w.size), bits=float(bits),
                    sram=float(cost["sram"]),
                    energy_uj=float(cost["energy_uj"]),
                    rel_err=rel_err))
    return out


def _spec_shapes(spec: ModelSpec, input_hw: tuple[int, int]
                 ) -> list[tuple[str, str, np.ndarray, ConvShape]]:
    """(name, kind, weights, ConvShape) per layer, spatial dims tracked
    through the conv stack the way ``CodrModel.sram_report`` does."""
    ri, ci = input_hw
    out = []
    for i, ls in enumerate(spec.layers):
        name = ls.name or f"layer{i}"
        if ls.kind == "conv":
            m, n, rk, ck = ls.weight.shape
            shape = ConvShape(m, n, rk, ck, ri, ci, ls.stride)
            ri = (ri - rk) // ls.stride + 1
            ci = (ci - ck) // ls.stride + 1
        else:
            m, n = ls.weight.shape
            shape = ConvShape(m, n, 1, 1, 1, 1, 1)
        out.append((name, ls.kind, ls.weight, shape))
    return out


def layer_candidate_table(spec: ModelSpec, input_hw: tuple[int, int], *,
                          grid: TuneGrid | None = None,
                          use_cache: bool = True
                          ) -> dict[str, list[Candidate]]:
    """Score the full candidate grid for every layer of a spec.

    Cached per (weight-stats fingerprint + ConvShape, grid): layers with
    identical geometry, quantized-value statistics, AND spatial position
    share one scoring pass — the spatial dims ride in the key because
    SRAM counts depend on the feature-map size, not just the weights.
    """
    grid = TuneGrid() if grid is None else grid
    table: dict[str, list[Candidate]] = {}
    for name, kind, w, shape in _spec_shapes(spec, input_hw):
        key = (layer_fingerprint(w, kind, shape.stride) + repr(shape),
               grid.key())
        if use_cache and key in _CACHE:
            _CACHE_STATS["hits"] += 1
            table[name] = _CACHE[key]
            continue
        _CACHE_STATS["misses"] += 1
        cands = _score_layer(w, kind, shape, grid)
        if use_cache:
            _CACHE[key] = cands
        table[name] = cands
    return table


# --------------------------------------------------------------------------
# selection under a budget
# --------------------------------------------------------------------------

def _objective(budget: TuneBudget):
    attr = {"sram": "sram", "bits": "bits", "energy": "energy_uj"}
    key = attr[budget.objective]

    def obj(c: Candidate) -> tuple:
        return (getattr(c, key), c.bits, c.sram, c.n_unique)
    return obj


def _feasible(cands: list[Candidate],
              budget: TuneBudget) -> list[Candidate]:
    if budget.max_rel_err is None:
        return list(cands)
    ok = [c for c in cands if c.rel_err <= budget.max_rel_err]
    # best effort when the gate is unreachable (e.g. a layer whose amax
    # outlier makes every restricted grid lossy): the least-lossy U
    return ok or [min(cands, key=lambda c: (c.rel_err, c.bits))]


def _greedy_toward_target(chosen: dict[str, Candidate],
                          feasible: dict[str, list[Candidate]],
                          metric, target: float) -> bool:
    """Swap layer candidates, cheapest quality loss per unit of metric
    gained first, until ``sum(metric)`` meets ``target``.  Returns
    whether the target was met."""
    total = sum(metric(c) for c in chosen.values())
    while total > target:
        best = None
        for name, cands in feasible.items():
            cur = chosen[name]
            for c in cands:
                gain = metric(cur) - metric(c)
                if gain <= 0:
                    continue
                loss = max(c.rel_err - cur.rel_err, 0.0)
                score = (loss / gain, -gain)
                if best is None or score < best[0]:
                    best = (score, name, c)
        if best is None:
            return False
        _, name, c = best
        total -= metric(chosen[name]) - metric(c)
        chosen[name] = c
    return True


def select_plan(table: dict[str, list[Candidate]], *,
                budget: TuneBudget | None = None,
                base: EncodeConfig | None = None,
                meta: dict | None = None,
                fingerprints: dict[str, str] | None = None,
                cached: dict[str, bool] | None = None) -> TunePlan:
    """Per-layer feasible cost-optimum, then the greedy walk toward any
    model-wide bits/SRAM target."""
    budget = TuneBudget() if budget is None else budget
    base = EncodeConfig() if base is None else base
    obj = _objective(budget)
    feasible = {name: _feasible(cands, budget)
                for name, cands in table.items()}
    chosen = {name: min(cands, key=obj)
              for name, cands in feasible.items()}

    met = True
    if budget.target_bits_per_weight is not None:
        n_weights = sum(c.n_weights for c in chosen.values())
        met &= _greedy_toward_target(
            chosen, feasible, lambda c: c.bits,
            budget.target_bits_per_weight * n_weights)
    if budget.max_sram_accesses is not None:
        met &= _greedy_toward_target(chosen, feasible,
                                     lambda c: c.sram,
                                     budget.max_sram_accesses)

    layers = {}
    for name, c in chosen.items():
        layers[name] = LayerPlan(
            name=name, kind=c.kind, config=c.config(base),
            n_weights=c.n_weights, predicted_bits=c.bits,
            predicted_sram=c.sram, predicted_energy_uj=c.energy_uj,
            rel_err=c.rel_err,
            fingerprint=(fingerprints or {}).get(name, ""),
            from_cache=(cached or {}).get(name, False))
    plan_meta = dict(meta or {})
    plan_meta["meets_budget"] = met
    return TunePlan(layers, default=base, budget=budget, meta=plan_meta)


def best_global_config(table: dict[str, list[Candidate]], *,
                       budget: TuneBudget | None = None,
                       base: EncodeConfig | None = None,
                       grid: TuneGrid | None = None
                       ) -> tuple[EncodeConfig, dict]:
    """The best SINGLE EncodeConfig over the same candidate table — the
    baseline every per-layer plan is judged against.  Scored with the
    same objective and feasibility gate as :func:`select_plan`; returns
    ``(config, totals)`` where totals carries the predicted sums."""
    budget = TuneBudget() if budget is None else budget
    base = EncodeConfig() if base is None else base
    grid = TuneGrid() if grid is None else grid
    obj = _objective(budget)

    by_key: dict[str, dict] = {}
    kinds: dict[str, str] = {}
    for name, cands in table.items():
        kinds[name] = cands[0].kind
        by_key[name] = {(c.n_unique, c.t_m, c.rle_params): c
                        for c in cands}
    has_conv = any(k == "conv" for k in kinds.values())
    has_linear = any(k == "linear" for k in kinds.values())
    t_ms_conv = grid.t_ms_conv if has_conv else grid.t_ms_conv[:1]
    t_ms_linear = grid.t_ms_linear if has_linear else grid.t_ms_linear[:1]

    best = None
    for u in grid.n_uniques:
        for rp in grid.rle_options:
            for tmc in t_ms_conv:
                for tml in t_ms_linear:
                    picks, worst = [], 0.0
                    for name, kind in kinds.items():
                        tm = tmc if kind == "conv" else tml
                        c = by_key[name].get((u, tm, rp))
                        if c is None:
                            picks = None
                            break
                        picks.append(c)
                        worst = max(worst, c.rel_err)
                    if picks is None:
                        continue
                    feasible = (budget.max_rel_err is None
                                or worst <= budget.max_rel_err)
                    totals = (sum(c.sram for c in picks),
                              sum(c.bits for c in picks),
                              sum(c.energy_uj for c in picks))
                    score = {"sram": (totals[0], totals[1]),
                             "bits": (totals[1], totals[0]),
                             "energy": (totals[2], totals[1])
                             }[budget.objective]
                    entry = (not feasible, score, u, tmc, tml, rp,
                             totals, worst)
                    if best is None or entry[:2] < best[:2]:
                        best = entry
    if best is None:
        raise ValueError("empty candidate table")
    _, _, u, tmc, tml, rp, totals, worst = best
    cfg = EncodeConfig(n_unique=u, t_m=tmc, t_n=base.t_n,
                       t_m_linear=tml, rle_params=rp,
                       decode_source=base.decode_source)
    n_weights = sum(cands[0].n_weights for cands in table.values())
    return cfg, {"sram": totals[0], "bits": totals[1],
                 "energy_uj": totals[2],
                 "bits_per_weight": totals[1] / max(n_weights, 1),
                 "max_rel_err": worst,
                 "feasible": not best[0]}


def tune_spec(spec: ModelSpec, input_hw: tuple[int, int], *,
              budget: TuneBudget | None = None,
              base: EncodeConfig | None = None,
              grid: TuneGrid | None = None,
              use_cache: bool = True) -> TunePlan:
    """End-to-end per-layer search over a :class:`ModelSpec`: candidate
    table (fingerprint-cached) → budgeted selection → serializable
    :class:`TunePlan` consumable by ``codr.compile(spec, plan=plan)``."""
    grid = TuneGrid() if grid is None else grid
    hits_before = _CACHE_STATS["hits"]
    fingerprints, cached = {}, {}
    for name, kind, w, shape in _spec_shapes(spec, input_hw):
        fp = layer_fingerprint(w, kind, shape.stride)
        fingerprints[name] = fp
        cached[name] = use_cache and \
            (fp + repr(shape), grid.key()) in _CACHE
    table = layer_candidate_table(spec, input_hw, grid=grid,
                                  use_cache=use_cache)
    meta = {"input_hw": list(input_hw), "grid": grid.key(),
            "cache_hits": _CACHE_STATS["hits"] - hits_before,
            "sampled": grid.max_vectors is not None}
    return select_plan(table, budget=budget, base=base, meta=meta,
                       fingerprints=fingerprints, cached=cached)


# --------------------------------------------------------------------------
# the transformer lane: per-leaf U budgets for the pack path
# --------------------------------------------------------------------------

def _leaf_stats(mat: torch.Tensor) -> tuple:
    """``ucr.quantize_int8`` of a ``(rows, d_out)`` leaf with torch on its
    device: ``(q0 int8, 0-d float32 scale, |mat| as a float, non-zeros
    of q0, fingerprint)``, the fingerprint that
    :func:`~repro_torch.tune.plan.layer_fingerprint` gives the same leaf
    on the host."""
    from repro_torch.core.codr_linear import _CHUNK, quantize_restrict
    q0, scale, present = quantize_restrict(mat, 256)
    flat, qflat = mat.reshape(-1), q0.reshape(-1)
    sq = torch.zeros((), dtype=torch.float64, device=mat.device)
    hist = torch.zeros(32, dtype=torch.int64, device=mat.device)
    for s in range(0, flat.numel(), _CHUNK):
        sq += flat[s:s + _CHUNK].to(torch.float64).square().sum()
        hist += torch.bincount(
            torch.div(qflat[s:s + _CHUNK].to(torch.int64) + 128, 8,
                      rounding_mode="floor"), minlength=32)
    nnz = int(torch.count_nonzero(q0))
    fp = _fingerprint("linear", mat.shape, 1, hist.tolist(),
                      int(present.sum()), float(scale))
    return q0, scale, float(sq.sqrt()), nnz, fp


def _rel_err(mat: torch.Tensor, q0: torch.Tensor, scale: torch.Tensor,
             n_unique: int, w_norm: float) -> float:
    """``|restrict_unique(q0, U) · scale − mat| / |mat|``: the dequantized
    weights and their difference from ``mat`` in float32, as the
    reference forms them; the sum of squares in float64."""
    from repro_torch.core.codr_linear import _CHUNK, _restrict
    flat, qflat = mat.reshape(-1), q0.reshape(-1)
    sq = torch.zeros((), dtype=torch.float64, device=mat.device)
    for s in range(0, flat.numel(), _CHUNK):
        q = _restrict(qflat[s:s + _CHUNK].to(torch.int32), n_unique)
        d = q.to(torch.float32) * scale - flat[s:s + _CHUNK]
        sq += d.to(torch.float64).square().sum()
    return float(sq.sqrt()) / w_norm


def tune_params(params, *,
                budget: TuneBudget | None = None,
                base: EncodeConfig | None = None,
                n_uniques: Sequence[int] = (4, 8, 16, 32, 64),
                include: Sequence[str] = PACK_INCLUDE,
                exclude: Sequence[str] = (),
                min_size: int | None = None) -> TunePlan:
    """Per-leaf U budgets for ``codr.compile_params(params, plan=...)``.

    For every packable projection leaf (same include/size filter as
    ``compile_params``, the same '/'-joined paths), picks the smallest U
    whose relative weight error passes the budget gate — the packed
    representation's bits are ``ceil(log2 U)`` per weight
    (:func:`repro_torch.core.codr_linear.choose_bits`), so minimizing U
    minimizes serving HBM directly.  Leaves the filter skips stay on the
    caller's default config.  Each leaf is quantized and restricted with
    torch on its own device (no copy to the host); the norms sum in
    float64, so a ``rel_err`` may differ from the reference's float32
    norm in its last digits.
    """
    from repro_torch.core import serving as _serving
    from repro_torch.core.codr_linear import _as_tensor, choose_bits
    from repro_torch.core.tree import leaves_with_path

    budget = TuneBudget() if budget is None else budget
    base = EncodeConfig() if base is None else base
    if min_size is None:
        min_size = _serving.MIN_COMPRESS_SIZE

    layers: dict[str, LayerPlan] = {}
    for pstr, leaf in leaves_with_path(params):
        t = _as_tensor(leaf)
        if t.dim() < 2 or t.numel() < min_size:
            continue
        if not (any(tok in pstr for tok in include)
                and not any(tok in pstr for tok in exclude)):
            continue
        mat = t.reshape(-1, t.shape[-1]).to(torch.float32)
        q0, scale, w_norm, nnz, fp = _leaf_stats(mat)
        w_norm = w_norm or 1.0
        best = None
        for u in sorted(set(int(v) for v in n_uniques)):
            rel_err = _rel_err(mat, q0, scale, u, w_norm)
            bits = float(t.numel() * choose_bits(u))
            entry = (rel_err, u, bits)
            feasible = (budget.max_rel_err is None
                        or rel_err <= budget.max_rel_err)
            if feasible:
                best = entry               # smallest feasible U wins
                break
            if best is None or entry < best:
                best = entry               # least-lossy fallback
        del q0
        rel_err, u, bits = best
        m, n = mat.shape[1], mat.shape[0]  # (d_in, d_out) leaves
        shape = ConvShape(m, n, 1, 1, 1, 1, 1)
        cost = cost_model.layer_cost(
            shape, codr_tiling(min(base.t_m_linear, m), base.t_n),
            bits, float(u), float(nnz))
        layers[pstr] = LayerPlan(
            name=pstr, kind="linear",
            config=dataclasses.replace(base, n_unique=u),
            n_weights=int(t.numel()), predicted_bits=bits,
            predicted_sram=cost["sram"],
            predicted_energy_uj=cost["energy_uj"], rel_err=rel_err,
            fingerprint=fp)
    if not layers:
        raise ValueError("tune_params found no packable projection "
                         f"leaves (include={tuple(include)!r}, "
                         f"min_size={min_size})")
    return TunePlan(layers, default=base, budget=budget,
                    meta={"lane": "params"})
