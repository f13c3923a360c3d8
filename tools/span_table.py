"""One traced run of a CNN cell of the benchmark, laid out by the
program's spans (``repro_torch.core.spans``): every per-layer metric,
the split of the requests' device-idle time (read, launch, other), a
table by ``codr.layer`` (host self ms, reads, device ms launched inside
the layer, of it the int8 feature path's), one by ``codr.branch``, and
what one span costs with no profiler running and under one.

    PYTHONPATH=src python3 tools/span_table.py --workload vgg16.b64 \\
        --seed 2147495001 [--seconds 30] [--out spans.json]

on the card (``--device cpu`` runs the benchmark's tiny CPU sizes for a
try).  Every number is a request's mean over the traced window; the
spans and the trace are joined by host time only, as the benchmark's
readers join them.  For a cell of branch modules (``googlenet.b256``) a
second table by ``codr.branch``: device ms, of it pooling, launches.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench import run as bench_run  # noqa: E402

TINY = {"config": {"conv_layers": [[4, 3, 3, 3, 1], [8, 4, 3, 3, 1]],
                   "input_hw": 12, "blocks": [1, 1]},
        "traffic": {"images_per_request": 4, "distinct_batches": 2,
                    "warmup_requests": 1}}


def span_cost(n: int = 20000) -> dict:
    """µs for one enter and exit of a span, without and under a
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans

    def loop() -> float:
        t = time.perf_counter()
        for i in range(n):
            with spans.span("codr.layer", name="conv0", index=i,
                            kind="conv"):
                pass
        return (time.perf_counter() - t) / n * 1e6
    off = loop()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        on = loop()
    spans.clear()
    return {"off_us": off, "on_us": on}


def layer_table(run) -> list[dict]:
    """One row a ``codr.layer`` name, in order of first appearance."""
    sp = harness.load_module("metrics", "cnn_host_reads")
    items, n = sp.in_requests(run, sp.window_spans(run) or [])
    by_id = {s.id: s for _, _, s in items}

    def layer_of(s):
        while s is not None and s.name != "codr.layer":
            s = by_id.get(s.parent)
        return s

    rows: dict = {}

    def row(layer):
        return rows.setdefault(layer.attrs["name"], {
            "layer": layer.attrs["name"], "host_self_ms": 0.0,
            "reads": 0.0, "device_ms": 0.0, "features_ms": 0.0})
    for s0, e0, s in items:
        if s.name == "codr.layer":
            row(s)["host_self_ms"] += e0 - s0
        elif s.name == "codr.host_read" and layer_of(s) is not None:
            r = row(layer_of(s))
            r["host_self_ms"] -= e0 - s0
            r["reads"] += 1
    layers = sp.named(items, "codr.layer")
    feats = sp.named(items, "codr.features")
    layer_starts = [s for s, _, _ in layers]
    feat_starts = [s for s, _, _ in feats]
    reqs = set(run.trace.in_groups("request"))
    for o in run.trace.ops:
        t = run.trace.launch_ts.get(o.corr)
        if o.group not in reqs or t is None:
            continue
        i = bisect.bisect_right(layer_starts, t) - 1
        if i < 0 or t > layers[i][1]:
            continue
        r = row(layers[i][2])
        r["device_ms"] += o.end - o.start
        j = bisect.bisect_right(feat_starts, t) - 1
        if j >= 0 and t <= feats[j][1]:
            r["features_ms"] += o.end - o.start
    for r in rows.values():
        r["reads"] /= n
        for k in ("host_self_ms", "device_ms", "features_ms"):
            r[k] /= 1e3 * n
    return list(rows.values())


def branch_table(run) -> list[dict]:
    """One row a module's branch (``codr.branch``: module, index, kind),
    in order of first appearance, and one for the operations launched
    outside every branch (the poolings between modules): the device ms
    launched inside it, of it the pooling's (``codr.pool``), and its
    launches, a request's mean."""
    sp = harness.load_module("metrics", "cnn_host_reads")
    items, n = sp.in_requests(run, sp.window_spans(run) or [])
    groups = {name: sp.named(items, name)
              for name in ("codr.branch", "codr.pool")}
    if not groups["codr.branch"]:
        return []
    starts = {k: [s for s, _, _ in v] for k, v in groups.items()}

    def inside(name, t):
        i = bisect.bisect_right(starts[name], t) - 1
        return groups[name][i][2] if i >= 0 and \
            t <= groups[name][i][1] else None
    rows: dict = {}
    reqs = set(run.trace.in_groups("request"))
    for o in run.trace.ops:
        t = run.trace.launch_ts.get(o.corr)
        if o.group not in reqs or t is None:
            continue
        br = inside("codr.branch", t)
        key = ("outside branches" if br is None else
               f"{br.attrs['module']}/{br.attrs['index']} "
               f"{br.attrs['kind']}")
        r = rows.setdefault(key, {"branch": key, "device_ms": 0.0,
                                  "pool_ms": 0.0, "launches": 0.0})
        r["device_ms"] += o.end - o.start
        r["launches"] += 1
        if inside("codr.pool", t) is not None:
            r["pool_ms"] += o.end - o.start
    for r in rows.values():
        r["device_ms"] /= 1e3 * n
        r["pool_ms"] /= 1e3 * n
        r["launches"] /= n
    return list(rows.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/span_table.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    err = bench_run.setup_env()
    if err:
        print(err, file=sys.stderr)
        return 2
    bench, _, run = bench_run.prepare(
        args.workload, args.seed, args.seconds, True,
        None if args.device.startswith("cuda") else TINY)
    try:
        harness.load_module("drivers", run.config["driver"]).drive(
            run, device=args.device, t_start=T_START)
    finally:
        faulthandler.cancel_dump_traceback_later()
    split = harness.load_module("metrics", "cnn_idle_read_ms").idle_split(run)
    n = split["requests"] if split else 1
    out = {"workload": args.workload, "seed": args.seed,
           "correct": run.correct,
           "metrics": {k: v["value"] for k, v in harness.read_metrics(
               run, bench["per_layer"]).items()},
           "idle_ms": ({k: split[k] / 1e3 / n for k in
                        ("read", "launch", "other", "idle")}
                       if split else None),
           "layers": layer_table(run), "branches": branch_table(run),
           "span_cost": span_cost()}
    print("| layer | host self ms | reads | device ms | features ms |")
    print("| --- | --- | --- | --- | --- |")
    for r in out["layers"]:
        print(f"| {r['layer']} | {r['host_self_ms']:.4f} | {r['reads']:.2f} "
              f"| {r['device_ms']:.4f} | {r['features_ms']:.4f} |")
    if out["branches"]:
        print("| branch | device ms | of it pooling | launches |")
        print("| --- | --- | --- | --- |")
        for r in out["branches"]:
            print(f"| {r['branch']} | {r['device_ms']:.4f} | "
                  f"{r['pool_ms']:.4f} | {r['launches']:.2f} |")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
