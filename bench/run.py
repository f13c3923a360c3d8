"""The port's benchmark: one run of one cell.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures ``repro_torch`` (under
``src/``) on the card and prints, as its last line, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
for ``correct`` beside its limit (also the last lines on standard
error).  It exits non-zero, and prints no result, without enough cards,
without the program, or where JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from bench import harness  # noqa: E402

# fixed cache directories inside the checkout: only a checkout's first run
# builds; the CUDA kernels themselves build into <checkout>/build
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    if args.seconds <= 0:
        p.error("--seconds must be > 0")
    return args


def fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return 2


def prepare(workload: str, seed: int, seconds: float, trace_on: bool,
            overrides=None):
    """``(BENCHMARK.json, its workload entry, an empty Run)`` for a cell,
    its files merged with ``overrides`` (``{"config": {...}, "traffic":
    {...}, "cell": {...}}``, for the harness's own tests).  Raises
    ``KeyError`` for a workload the benchmark does not name."""
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, workload)
    overrides = overrides or {}

    def merged(kind, name, key):
        return {**harness.load_json(harness.BENCH / kind / f"{name}.json"),
                **overrides.get(key, {})}
    run = harness.Run(
        workload=workload, seed=seed, seconds=seconds, trace_on=trace_on,
        config=merged("configs", cell["config"], "config"),
        traffic=merged("traffic", cell["traffic"], "traffic"),
        cell_file=merged("workloads", workload, "cell"))
    return bench, cell, run


def setup_env() -> str | None:
    """Cache directories inside the checkout and ``src`` on the path; an
    error message where the program is missing."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(harness.ROOT / rel)
    if not (harness.ROOT / "src" / "repro_torch").is_dir():
        return (f"the program is missing: no src/repro_torch under "
                f"{harness.ROOT}")
    if str(harness.ROOT / "src") not in sys.path:
        sys.path.insert(0, str(harness.ROOT / "src"))
    return None


def card_error(chips: int) -> str | None:
    """Why the card cannot take the cell, or ``None``."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA device(s), the cell "
                f"asks for {chips}")
    return None


def main(argv=None, *, device: str = "cuda", overrides=None,
         build=None) -> int:
    """One run.  ``device``, ``overrides`` and ``build`` (a wrapper around
    the program's model or server, a fault planted under the timed path)
    are for the harness's own tests on the CPU; a measured run takes the
    card."""
    args = parse_args(argv)
    err = setup_env()
    if err:
        return fail(err)
    try:
        bench, cell, run = prepare(args.workload, args.seed, args.seconds,
                                   bool(args.trace), overrides)
    except KeyError as exc:
        return fail(str(exc))

    import torch
    if device.startswith("cuda"):
        err = card_error(int(cell["chips"]))
        if err:
            return fail(err)
        torch.cuda.reset_peak_memory_stats()
    driver = harness.load_module("drivers", run.config["driver"])
    try:
        driver.drive(run, device=device, t_start=T_START, build=build)
        metrics = harness.read_metrics(
            run, harness.metric_defs(bench, args.workload, run.trace_on))
    finally:
        faulthandler.cancel_dump_traceback_later()
    if device.startswith("cuda"):
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell["chips"]),
               "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
    line = harness.result_line(run, metrics, dev)

    bad = harness.forbidden_modules()
    if bad:
        return fail(f"JAX or the JAX package was loaded: {', '.join(bad)}")
    for note in run.notes[-20:]:
        print(f"bench: {note}", file=sys.stderr)
    print(f"bench: {args.workload} seed {args.seed} setup_s "
          f"{run.setup_s} window_s {run.window_s} attempted "
          f"{run.attempted} failed {run.failed}", file=sys.stderr)
    if run.trace is not None:
        print(f"bench: trace: {len(run.trace.ops)} device operations "
              f"({sum(o.corr >= 0 for o in run.trace.ops)} matched to a "
              f"launch), {len(run.trace.host)} host operations, read in "
              f"{run.trace.read_s:.1f} s", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
