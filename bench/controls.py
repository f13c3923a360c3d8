"""The controls behind each cell's correctness limits, run on the card at
the cell's own size; not part of a measured run.

    python3 -m bench.controls --workload <name> --seconds <s> --seeds 1 2 3

For each seed: one run of the cell (a short window at the cell's own
load), which gives the program's reading of every compared number, then
the control's reading of the same numbers: the plain reference put in
the program's place and computed one precision below the configuration's
(the driver's ``control``).  One JSON line a seed.  The limits in
``bench/workloads/<cell>.json`` lie between the program's largest
reading and the control's smallest (``PERF.md``).
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import sys
import time

from bench import harness
from bench import run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m bench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    err = bench_run.setup_env()
    if err:
        return bench_run.fail(err)
    import torch
    for seed in args.seeds:
        _, cell, run = bench_run.prepare(args.workload, seed, args.seconds,
                                         False)
        err = bench_run.card_error(int(cell["chips"]))
        if err:
            return bench_run.fail(err)
        driver = harness.load_module("drivers", run.config["driver"])
        try:
            driver.drive(run, device="cuda", t_start=time.perf_counter())
        finally:
            faulthandler.cancel_dump_traceback_later()
        t0 = time.perf_counter()
        ctrl = driver.control(run, "cuda")
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in run.checks.items()},
            "limit": {k: v["limit"] for k, v in run.checks.items()},
            "control": ctrl, "control_s": time.perf_counter() - t0,
            "attempted": run.attempted, "failed": run.failed,
            "checked_tokens": run.work.get("checked_tokens")}), flush=True)
        del run, driver
        torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        return bench_run.fail(f"JAX or the JAX package was loaded: "
                              f"{', '.join(bad)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
