"""``repro_torch.tune`` — per-layer encoding autotuner + quality eval
harness, the port's copy of ``repro.tune``.

The paper's §III-C search as a first-class offline subsystem: score
every (U budget × tile geometry × RLE params) candidate per layer with
the cost model, select under a budget, emit a serializable
:class:`TunePlan`, and compile with it::

    from repro_torch import tune
    import repro_torch.api as codr

    plan = tune.tune_spec(spec, input_hw=(20, 20),
                          budget=tune.TuneBudget(max_rel_err=0.04))
    compiled = codr.compile(spec, plan=plan)    # on the card
    print(compiled.layer_table((20, 20)))     # predicted vs measured

Quality numbers come from :mod:`repro_torch.tune.eval`; the CLI entry
point is ``python -m repro_torch.launch.tune`` (``--small --check``
asserts the tuned plan beats the best global config).  A plan's JSON is
the reference's, so plans move between the packages both ways.
"""
from repro_torch.tune.autotune import (Candidate, TuneGrid,  # noqa: F401
                                       best_global_config, cache_stats,
                                       clear_cache, layer_candidate_table,
                                       select_plan, tune_params, tune_spec)
from repro_torch.tune.eval import (cnn_quality, eval_batch,  # noqa: F401
                                   pareto_curve, transformer_quality)
from repro_torch.tune.plan import (LayerPlan, TuneBudget,  # noqa: F401
                                   TunePlan, layer_fingerprint)

__all__ = [
    "TuneBudget", "TuneGrid", "TunePlan", "LayerPlan", "Candidate",
    "tune_spec", "tune_params", "select_plan", "best_global_config",
    "layer_candidate_table", "layer_fingerprint",
    "cache_stats", "clear_cache",
    "cnn_quality", "eval_batch", "pareto_curve", "transformer_quality",
]
