"""The harness's core: finding a cell's pieces by name, the record of one
run, the metrics read from it, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``bench/configs/<config>.json``: the configuration's sizes, its
  ``driver`` (``bench/drivers/<driver>.py``), its ``generator``
  (``bench/generators/<generator>.py``) and its ``reference``
  (``bench/reference/<reference>.py``);
* ``bench/traffic/<traffic>.json``: the traffic mix's parameters and
  the lane (backend) its requests ask for;
* ``bench/workloads/<cell>.json``: the arithmetic the cell's peak is
  taken in, and the limits its correctness checks hold;
* ``bench/metrics/<metric>.py``: one metric's reader, ``read(run)``,
  which returns a number or ``None`` where the run holds nothing for it.

Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import importlib.util
import json
import pathlib
import sys
import time

__all__ = ["ROOT", "BENCH", "Run", "load_benchmark", "find_cell",
           "load_json", "load_module", "metric_defs", "read_metrics",
           "result_line", "forbidden_modules"]

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names that may not be loaded in a measured process:
# JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what a run may take after its window: reading the trace, the reference
AFTER_WINDOW_S = 240.0


@dataclasses.dataclass
class Run:
    """What one run measured: filled by the cell's driver, read by the
    metrics."""

    workload: str
    seed: int
    seconds: float
    trace_on: bool
    config: dict
    traffic: dict
    cell_file: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    samples: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    shapes: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    memory_peak_bytes: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)
    sample: list = dataclasses.field(default_factory=list)

    def open_window(self, t_start: float) -> None:
        """Set-up is over: record its seconds, and from here on give the
        process the window plus ``AFTER_WINDOW_S`` to finish, or dump
        every thread's stack to standard error and exit."""
        self.setup_s = time.perf_counter() - t_start
        faulthandler.dump_traceback_later(self.seconds + AFTER_WINDOW_S,
                                          exit=True, file=sys.__stderr__)

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit: correct while value <=
        limit."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    key = f"bench._{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_defs(bench: dict, workload: str, trace_on: bool) -> list[dict]:
    """The cell's metrics: end to end without tracing, per layer with.
    A metric with a ``workloads`` key belongs to those cells only."""
    group = bench["per_layer"] if trace_on else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(run: Run, defs: list[dict]) -> dict:
    """``{name: {"value", "unit"}}`` for each metric whose reader found
    something to read."""
    out = {}
    for m in defs:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def result_line(run: Run, metrics: dict, device: dict) -> dict:
    """The last line of a run, with the compared numbers last."""
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = run.checks
    return out
