"""The port's span recorder (``repro_torch.core.spans``): nothing is kept
without a profiler, spans nest and name their request, the buffer stays
bounded, and the stamps share the clock of the profiler's host events,
which is what lets the benchmark lay them over a trace.  CPU only."""
import collections
import faulthandler
import json
import pathlib
import sys
import time
import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.api as codr
from repro_torch.core import spans

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:        # the benchmark's trace reader
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return spans.spans()


def _model(backend: str):
    rng = np.random.default_rng(0)
    spec = codr.ModelSpec([
        codr.LayerSpec.conv(rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
                            activation="relu", name="c0"),
        codr.LayerSpec.conv(rng.normal(size=(6, 4, 3, 3)).astype(np.float32),
                            activation="relu", name="c1")])
    return codr.compile(spec, codr.EncodeConfig(n_unique=16),
                        backend=backend, device="cpu")


def _images():
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, 256, (2, 9, 9, 3), generator=g).float()


def test_nothing_is_recorded_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first = spans.span("codr.run", backend="x")
    with first, spans.span("codr.layer", name="c0"):
        pass
    assert spans.span("codr.features") is first     # one shared null
    _model("smm_kernel").run(_images())
    assert spans.spans() == []


def test_spans_are_recorded_under_the_profiler():
    def body():
        with spans.span("codr.run", backend="tiled", batch=2):
            pass
    (s,) = _profiled(body)
    assert s.name == "codr.run" and s.attrs == {"backend": "tiled",
                                                "batch": 2}
    assert 0 < s.start_ns <= s.end_ns and s.thread


def test_parent_and_request_ids_follow_nesting():
    def body():
        with spans.span("codr.run"):
            with spans.span("codr.layer", name="c0", index=0, kind="conv"):
                with spans.span("codr.features"):
                    with spans.span("codr.host_read", what="scale"):
                        pass
            with spans.span("codr.layer", name="c1", index=1, kind="conv"):
                pass
        with spans.span("codr.layer"):
            pass
    by = {}
    for s in _profiled(body):
        by.setdefault(s.name, []).append(s)
    (run,), (feat,), (read,) = (by["codr.run"], by["codr.features"],
                                by["codr.host_read"])
    l0, l1, alone = by["codr.layer"]
    assert run.parent == 0 and run.request == run.id
    assert l0.parent == l1.parent == run.id
    assert feat.parent == l0.id and read.parent == feat.id
    assert {l0.request, l1.request, feat.request, read.request} == {run.id}
    assert alone.parent == 0 and alone.request == 0
    assert l0.attrs == {"name": "c0", "index": 0, "kind": "conv"}
    assert run.start_ns <= l0.start_ns <= read.start_ns <= read.end_ns \
        <= l0.end_ns <= l1.start_ns <= l1.end_ns <= run.end_ns


def test_the_buffer_stays_bounded(monkeypatch):
    monkeypatch.setattr(spans, "_buffer", collections.deque(maxlen=5))

    def body():
        for i in range(12):
            with spans.span("codr.layer", index=i):
                pass
    kept = _profiled(body)
    assert [s.attrs["index"] for s in kept] == list(range(7, 12))
    assert spans.MAX_SPANS == 1_000_000


def test_a_tiny_smm_model_records_its_features_and_reads():
    """The ``smm`` lane's host path reads two scalars a layer."""
    model, x = _model("smm"), _images()
    got = _profiled(lambda: model.run(x))
    names = [s.name for s in got]
    assert names.count("codr.run") == 1 and names.count("codr.layer") == 2
    assert names.count("codr.features") == 2
    reads = [s for s in got if s.name == "codr.host_read"]
    # 0-255 pixels fail the integer test (> 127), the ReLU output is not
    # whole: both layers read the test and the scale
    assert [s.attrs["what"] for s in reads] == ["integer_test", "scale"] * 2
    layers = {s.id: s for s in got if s.name == "codr.layer"}
    feats = {s.id: s for s in got if s.name == "codr.features"}
    assert all(s.parent in layers for s in feats.values())
    assert all(s.parent in feats for s in reads)
    assert [layers[f.parent].attrs["name"] for f in feats.values()] == \
        ["c0", "c1"]


def test_a_tiled_model_records_no_features_and_no_reads():
    model = _model("tiled")
    got = _profiled(lambda: model.run(_images()))
    assert sorted(s.name for s in got) == ["codr.layer"] * 2 + ["codr.run"]


def test_a_host_read_span_holds_the_profilers_event_for_its_read():
    """The shared clock: under the benchmark's own recorder, each
    ``codr.host_read`` span holds the profiler's host event of its read
    (on ``smm``, the lane that reads)."""
    from bench import trace as tr
    model, x = _model("smm"), _images()
    _, trace = tr.record(lambda: model.run(x), sync=lambda: None)
    reads = [s for s in spans.spans() if s.name == "codr.host_read"]
    assert len(reads) == 4
    events = [h for h in trace.host
              if h[0] in ("aten::item", "aten::_local_scalar_dense")]
    for s in reads:
        lo, hi = s.start_ns / 1e3, s.end_ns / 1e3
        assert any(lo <= h[1] and h[2] <= hi for h in events), s
    assert not any(h[0].startswith("codr.") for h in trace.host)


# -- the benchmark's five span readers (bench/metrics/) ----------------------

_Rec = collections.namedtuple(
    "_Rec", "name start_ns end_ns id parent request thread attrs")
READERS = ("cnn_host_reads", "cnn_host_self_ms", "cnn_idle_read_ms",
           "cnn_idle_launch_ms", "cnn_features_ms")


def _hand_run():
    """A hand-built window (µs) of two requests.  Request 1 (mark
    100-600): one layer, its features span holding one read (200-260);
    device ops K1-K5 with gaps 25 (launch: K2 launched inside the
    features span, no read ended between the launches), 50 (read: the
    read ended at 260, between K2's launch 210 and K3's 265), 30 (launch)
    and 200 (other: K5 launched at 550, outside every span).  Request 2
    (mark 700-900): two reads; gaps 40 (read) and 18 (other: K8 has no
    launch record).  Spans outside a request mark or the window count
    nowhere."""
    from bench import harness
    from bench import trace as tr
    ev = [("user_annotation", "bench.window", 0, 1000, (1,)),
          ("user_annotation", "bench.request", 100, 600, (2,)),
          ("user_annotation", "bench.request", 700, 900, (3,))]
    ops = [  # name, cat, launch host time (None: no record), device start, end
        ("K1", "kernel", 140, 150, 190), ("K2", "gpu_memcpy", 210, 215, 220),
        ("K3", "kernel", 265, 270, 300), ("K4", "kernel", 325, 330, 360),
        ("K5", "kernel", 550, 560, 580), ("K6", "kernel", 735, 745, 750),
        ("K7", "kernel", 785, 790, 802), ("K8", "kernel", None, 820, 830)]
    for corr, (name, cat, launch, start, end) in enumerate(ops, 11):
        ev.append((cat, name, start, end, (corr,)))
        if launch is not None:
            ev.append(("cuda_runtime", "cudaLaunchKernel", launch,
                       launch + 2, (corr,)))
    run = harness.Run("vgg16.b64", 1, 1.0, True, {}, {}, {})
    run.trace = tr.parse(ev)
    table = (  # name, start, end, id, parent, request
        ("codr.run", 110, 500, 1, 0, 1), ("codr.layer", 120, 400, 2, 1, 1),
        ("codr.features", 130, 300, 3, 2, 1),
        ("codr.host_read", 200, 260, 4, 3, 1),
        ("codr.run", 710, 850, 5, 0, 5), ("codr.layer", 720, 840, 6, 5, 5),
        ("codr.features", 730, 790, 7, 6, 5),
        ("codr.host_read", 740, 760, 8, 7, 5),
        ("codr.host_read", 770, 780, 9, 7, 5),
        ("codr.host_read", 650, 660, 10, 0, 0),     # between the marks
        ("codr.host_read", 1100, 1200, 11, 0, 0))   # after the window
    recs = [_Rec(n, s * 1000, e * 1000, i, p, r, 1, {})
            for n, s, e, i, p, r in table]
    return run, types.SimpleNamespace(spans=lambda: list(recs))


def _read(name, run):
    from bench import harness
    return harness.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name,want", [
    ("cnn_host_reads", (1 + 2) / 2),
    ("cnn_host_self_ms", ((390 - 60) + (140 - 20 - 10)) / 2 / 1e3),
    ("cnn_idle_read_ms", (50 + 40) / 2 / 1e3),
    ("cnn_idle_launch_ms", (25 + 30) / 2 / 1e3),
    ("cnn_features_ms", ((40 + 5 + 30) + (5 + 12)) / 2 / 1e3)])
def test_span_readers_read_hand_worked_values(name, want):
    run, mod = _hand_run()
    with mock.patch.dict(sys.modules, {spans.__name__: mod}):
        assert _read(name, run) == pytest.approx(want)


def test_the_idle_split_adds_up_to_the_requests_idle_time():
    from bench import harness
    run, mod = _hand_run()
    with mock.patch.dict(sys.modules, {spans.__name__: mod}):
        split = harness.load_module("metrics",
                                    "cnn_idle_read_ms").idle_split(run)
    assert (split["read"], split["launch"], split["other"]) == \
        pytest.approx((90, 55, 200 + 18))
    # each request's idle time: its first op's start to its last op's end,
    # less the time an op ran
    groups = run.trace.by_group()
    idle = sum(max(o.end for o in g) - min(o.start for o in g)
               - sum(o.end - o.start for o in g) for g in groups.values())
    assert split["idle"] == pytest.approx(idle) == pytest.approx(
        split["read"] + split["launch"] + split["other"])
    assert split["requests"] == 2


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_the_span_module(name):
    run, _ = _hand_run()
    with mock.patch.dict(sys.modules):
        sys.modules.pop(spans.__name__, None)
        assert _read(name, run) is None


def _traced_tiny_run(cell):
    """One traced run of ``cell`` on the CPU at a tiny size, its
    ``Run``."""
    from bench import harness
    from bench import run as bench_run
    tiny = {"config": {"conv_layers": [[4, 3, 3, 3, 1], [8, 4, 3, 3, 1]],
                       "input_hw": 12, "blocks": [1, 1]},
            "traffic": {"images_per_request": 4, "distinct_batches": 2,
                        "warmup_requests": 1}}
    _, _, run = bench_run.prepare(cell, 3000000019, 0.3, True, tiny)
    try:
        harness.load_module("drivers", run.config["driver"]).drive(
            run, device="cpu", t_start=time.perf_counter())
    finally:
        faulthandler.cancel_dump_traceback_later()
    return run


def _first_request_host_ops(trace):
    _, lo, hi = trace.groups[trace.in_groups("request")[0]]
    return [h[0] for h in sorted(trace.host, key=lambda h: h[1])
            if lo <= h[1] <= hi]


@pytest.mark.parametrize("cell", ["vgg16.b64", "vgg16.tiled.b64"])
def test_spans_leave_the_trace_and_the_other_readers_as_they_were(
        cell, monkeypatch):
    from bench import harness
    bm = harness.load_benchmark()
    old = [m for m in harness.metric_defs(bm, cell, True)
           if m["name"] not in READERS]
    run = _traced_tiny_run(cell)
    names = [o.name for o in run.trace.ops] + [h[0] for h in run.trace.host]
    assert not any(n.startswith("codr.") for n in names)
    assert any(s.name == "codr.run" for s in spans.spans())
    with_spans = harness.read_metrics(run, old)
    with mock.patch.dict(sys.modules):
        sys.modules.pop(spans.__name__)
        assert harness.read_metrics(run, old) == with_spans
    # the same run with the recorder switched off launches the same host
    # operations in a request: the spans add no profiler event
    monkeypatch.setattr(spans, "_enabled", lambda: False)
    spans.clear()
    off = _traced_tiny_run(cell)
    assert spans.spans() == []
    assert _first_request_host_ops(off.trace) == \
        _first_request_host_ops(run.trace)
    assert set(harness.read_metrics(off, old)) == set(with_spans)


def test_the_span_table_tool_lays_a_tiny_run_out_by_layer(capsys):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import span_table
    finally:
        sys.path.remove(str(ROOT / "tools"))
    assert span_table.main(["--workload", "vgg16.b64", "--seed", "7",
                            "--seconds", "0.3", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the tiny chain, two blocks of one layer each, on the wrappers'
    # plain versions: no read to the host, as on the card
    assert out["correct"] and out["metrics"]["cnn_host_reads"] == 0.0
    assert [(r["layer"], r["reads"]) for r in out["layers"]] == \
        [("conv0", 0.0), ("conv1", 0.0)]
    assert all(r["host_self_ms"] > 0 for r in out["layers"])
    assert set(out["span_cost"]) == {"off_us", "on_us"}
