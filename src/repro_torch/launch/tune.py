"""Autotune driver: per-layer encoding search vs the best global config
— the port's copy of ``repro.launch.tune``, with the same flags.

  PYTHONPATH=src python -m repro_torch.launch.tune [--small] [--check]
      [--model vgg16] [--max-rel-err 0.03] [--objective sram]
      [--out plan.json]

Runs the §III-C-style per-layer search (:func:`repro_torch.tune.tune_spec`)
on paper-CNN geometry, scores the best *single* global
``EncodeConfig`` over the same candidate table as the baseline, compiles
both, and reports predicted-vs-measured bits/weight, SRAM accesses, and
dense-oracle logit agreement side by side.  ``--check`` asserts the
tuned plan's measured bits/weight and predicted SRAM are no worse than
the global baseline's at equal-or-better top-1 logit agreement — the CI
smoke gate (``--small --check``).  ``--out`` writes the plan JSON so a
later ``codr.compile(spec, plan=TunePlan.load(...))`` skips the search
(in either package: the JSON is the reference's).  The search runs on
the host (NumPy); both models compile and run on the card, or where
``run_tune(device=...)`` says.
"""
from __future__ import annotations

import argparse

import numpy as np

import repro_torch.api as codr
from repro_torch import tune
from repro_torch.core.engine import resolve_device


def run_tune(*, model: str = "vgg16", n_conv: int = 2, n_out: int = 10,
             input_hw: tuple[int, int] = (20, 20), density: float = 0.4,
             max_rel_err: float | None = 0.03, objective: str = "sram",
             target_bits_per_weight: float | None = None,
             max_sram_accesses: float | None = None,
             exact: bool = True, batch: int = 32, seed: int = 0,
             out: str | None = None, verbose: bool = True,
             device=None) -> dict:
    """One tuning run: search → plan → compile → measure, against the
    best-global-config baseline.  Importable so tests, benchmarks, and
    CI drive the same path as the CLI.  ``exact=True`` scores every UCR
    vector (predicted bits/SRAM equal measured); set ``False`` to sample
    on large layers.  ``device`` — where the two models compile and
    run; ``None`` means the card, and raises when there is none."""
    dev = resolve_device(device)
    spec = codr.ModelSpec.from_paper_cnn(
        model, n_conv=n_conv, n_out=n_out, ri=input_hw[0], ci=input_hw[1],
        density=density, rng=np.random.default_rng(seed))
    budget = tune.TuneBudget(
        max_rel_err=max_rel_err, objective=objective,
        target_bits_per_weight=target_bits_per_weight,
        max_sram_accesses=max_sram_accesses)
    grid = tune.TuneGrid(max_vectors=None if exact else 2000)

    plan = tune.tune_spec(spec, input_hw, budget=budget, grid=grid)
    table = tune.layer_candidate_table(spec, input_hw, grid=grid)
    global_cfg, global_pred = tune.best_global_config(
        table, budget=budget, grid=grid)

    tuned = codr.compile(spec, plan=plan, device=dev)
    baseline = codr.compile(spec, global_cfg, device=dev)
    x = tune.eval_batch(spec, input_hw, batch=batch, seed=seed)
    q_tuned = tune.cnn_quality(tuned, x)
    q_global = tune.cnn_quality(baseline, x)
    sram_tuned = sum(a.total_sram for _, a in
                     tuned.sram_report(input_hw, per_layer_tiling=True))
    sram_global = sum(a.total_sram for _, a in
                      baseline.sram_report(input_hw, per_layer_tiling=True))

    if verbose:
        print(plan.table())
        print()
        print(tuned.layer_table(input_hw))
        print()
        print(f"global baseline: {global_cfg.metadata()}")
        hdr = (f"{'':<8} {'bits/w':>8} {'pred b/w':>9} {'sram':>12} "
               f"{'pred sram':>12} {'top1':>6} {'rel err':>8}")
        print(hdr)
        print(f"{'tuned':<8} {tuned.bits_per_weight():8.3f} "
              f"{plan.predicted_bits_per_weight():9.3f} "
              f"{sram_tuned:12.3e} {plan.predicted_total_sram():12.3e} "
              f"{q_tuned['top1_match']:6.3f} "
              f"{q_tuned['rel_logit_err']:8.4f}")
        print(f"{'global':<8} {baseline.bits_per_weight():8.3f} "
              f"{global_pred['bits_per_weight']:9.3f} "
              f"{sram_global:12.3e} {global_pred['sram']:12.3e} "
              f"{q_global['top1_match']:6.3f} "
              f"{q_global['rel_logit_err']:8.4f}")
    if out is not None:
        plan.save(out)
        if verbose:
            print(f"plan written to {out}")

    return {
        "plan": plan,
        "global_config": global_cfg,
        "tuned": {"bits_per_weight": tuned.bits_per_weight(),
                  "predicted_bits_per_weight":
                      plan.predicted_bits_per_weight(),
                  "sram_accesses": float(sram_tuned),
                  "predicted_sram": plan.predicted_total_sram(),
                  **q_tuned},
        "global": {"bits_per_weight": baseline.bits_per_weight(),
                   "predicted_bits_per_weight":
                       global_pred["bits_per_weight"],
                   "sram_accesses": float(sram_global),
                   "predicted_sram": global_pred["sram"],
                   **q_global},
    }


def check_result(result: dict) -> None:
    """The CI gate: the tuned plan must be no worse than the best global
    config on measured bits/weight AND predicted SRAM, at
    equal-or-better top-1 logit agreement."""
    t, g = result["tuned"], result["global"]
    if t["bits_per_weight"] > g["bits_per_weight"]:
        raise AssertionError(
            f"tuned bits/weight {t['bits_per_weight']:.4f} worse than "
            f"global {g['bits_per_weight']:.4f}")
    if t["predicted_sram"] > g["predicted_sram"]:
        raise AssertionError(
            f"tuned predicted SRAM {t['predicted_sram']:.0f} worse than "
            f"global {g['predicted_sram']:.0f}")
    if t["top1_match"] < g["top1_match"]:
        raise AssertionError(
            f"tuned top-1 agreement {t['top1_match']:.3f} below global "
            f"{g['top1_match']:.3f}")
    print("CHECK OK: tuned <= global on bits/weight and predicted SRAM "
          f"at equal-or-better agreement "
          f"({t['top1_match']:.3f} vs {g['top1_match']:.3f})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vgg16",
                    choices=["alexnet", "vgg16", "googlenet"])
    ap.add_argument("--n-conv", type=int, default=3)
    ap.add_argument("--n-out", type=int, default=10)
    ap.add_argument("--hw", type=int, default=28,
                    help="square input feature-map size")
    ap.add_argument("--density", type=float, default=0.4)
    ap.add_argument("--max-rel-err", type=float, default=0.03)
    ap.add_argument("--objective", default="sram",
                    choices=["sram", "bits", "energy"])
    ap.add_argument("--target-bpw", type=float, default=None,
                    help="model-wide bits/weight target (greedy walk)")
    ap.add_argument("--max-sram", type=float, default=None,
                    help="model-wide predicted-SRAM ceiling")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write plan JSON here")
    ap.add_argument("--small", action="store_true",
                    help="CI smoke geometry (2 conv layers, 20x20 input)")
    ap.add_argument("--check", action="store_true",
                    help="assert tuned <= global at equal-or-better "
                         "agreement (exit 1 otherwise)")
    args = ap.parse_args(argv)
    if args.small:
        args.n_conv, args.hw = 2, 20
    result = run_tune(
        model=args.model, n_conv=args.n_conv, n_out=args.n_out,
        input_hw=(args.hw, args.hw), density=args.density,
        max_rel_err=args.max_rel_err, objective=args.objective,
        target_bits_per_weight=args.target_bpw,
        max_sram_accesses=args.max_sram,
        batch=args.batch, seed=args.seed, out=args.out)
    if args.check:
        check_result(result)


if __name__ == "__main__":
    main()
