"""CPU tests of the inception cell's pieces (``googlenet.b256``): found by
name, the draws, the geometry the readers take, the benchmark's reference
against the port's plain one, the two span readers and the padded
quantize's roofline on hand-built traces, a tiny run, and the imports of
the new files."""
from __future__ import annotations

import ast
import collections
import sys
import types
from unittest import mock

import pytest
import torch

from bench import harness
from bench import run as bench_run
from bench import trace as tr
from bench.generators import inception as gen

CELL = "googlenet.b256"
CONFIG = harness.load_json(harness.BENCH / "configs" / "googlenet.json")
# the cell at a tiny size: every width cut to a few channels, 10² inputs
TINY = {"config": {"input_hw": 10, "input_channels": 24, "modules": [
            ["3a", 8, 8, 16, 4, 8, 8], ["3b", 8, 8, 16, 4, 8, 8],
            ["4a", 8, 8, 16, 4, 8, 8], ["4b", 8, 4, 8, 4, 8, 8]]},
        "traffic": {"images_per_request": 3, "distinct_batches": 2,
                    "warmup_requests": 1}}
NEW_FILES = [harness.BENCH / p for p in (
    "drivers/inception.py", "generators/inception.py",
    "reference/inception.py", "metrics/cnn_pool_ms.py",
    "metrics/cnn_branch_launches.py", "metrics/quantize_pad_roofline.py",
    "metrics/max_pool_roofline.py")]


def _tiny_config():
    return {**CONFIG, **TINY["config"]}


def test_config_traffic_and_cell_are_found_by_name():
    bm = harness.load_benchmark()
    cell = harness.find_cell(bm, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("googlenet", "b256.smm_kernel", 1)
    _, _, run = bench_run.prepare(CELL, 1, 1.0, False)
    assert run.config["name"] == "googlenet"
    assert run.traffic["lane"] == "smm_kernel"
    assert run.traffic["images_per_request"] == 256
    assert run.cell_file == {"arithmetic": "int8",
                             "limits": {"out_rel_gap": 0.1}}
    for kind in ("drivers", "generators"):
        assert callable(harness.load_module(kind, "inception").__dict__[
            "drive" if kind == "drivers" else "draw_layer"])
    names = {m["name"] for m in harness.metric_defs(bm, CELL, True)}
    assert {"cnn_pool_ms", "cnn_branch_launches", "quantize_pad_roofline",
            "max_pool_roofline", "smm_conv_roofline", "cnn_mfu",
            "cnn_features_ms"} <= names
    assert {m["name"] for m in harness.metric_defs(bm, CELL, False)} == \
        {"cnn_images_per_s", "cnn_request_p95_ms", "setup_s"}


def test_config_keeps_table_1s_widths():
    rows = {r[0]: r[1:] for r in CONFIG["modules"]}
    assert rows == {"3a": [64, 96, 128, 16, 32, 32],
                    "3b": [128, 128, 192, 32, 96, 64],
                    "4a": [192, 96, 208, 16, 48, 64],
                    "4b": [160, 112, 224, 24, 64, 64]}
    assert (CONFIG["input_hw"], CONFIG["input_channels"]) == (28, 192)
    assert CONFIG["reduced"] == ["stem", "depth", "head"]
    for key in CONFIG["reduced"]:
        assert key in CONFIG["published"]


@pytest.mark.parametrize("index", [0, 2, 4, 23])
def test_draws_repeat_per_seed_and_layer(index):
    seed = 2 ** 31 + 7
    w = gen.draw_layer(CONFIG, seed, index, "cpu")
    assert torch.equal(w, gen.draw_layer(CONFIG, seed, index, "cpu"))
    assert not torch.equal(w, gen.draw_layer(CONFIG, seed + 1, index, "cpu"))
    b = gen.draw_bias(CONFIG, seed, index, "cpu")
    assert torch.equal(b, gen.draw_bias(CONFIG, seed, index, "cpu"))
    c = gen.conv_layers(CONFIG)[index]
    assert w.shape == (c["m"], c["n"], c["k"], c["k"]) and b.shape == (c["m"],)
    assert 0.3 < float((w != 0).float().mean()) < 0.5
    x = gen.draw_images(CONFIG, {"images_per_request": 2,
                                 "distinct_batches": 2}, seed, "cpu")
    assert x[0].shape == (2, 28, 28, 192) and bool((x[0] >= 0).all())
    assert not torch.equal(x[0], x[1])


def test_shapes_list_24_convolutions_on_their_padded_planes():
    shapes = gen.layer_shapes(CONFIG)
    assert len(shapes) == 24
    got = [(s["m"], s["n"], s["rk"], s["ri"]) for s in shapes]
    assert got[:6] == [(64, 192, 1, 28), (96, 192, 1, 28), (128, 96, 3, 30),
                       (16, 192, 1, 28), (32, 16, 5, 32), (32, 192, 1, 28)]
    assert got[6:12] == [(128, 256, 1, 28), (128, 256, 1, 28),
                         (192, 128, 3, 30), (32, 256, 1, 28),
                         (96, 32, 5, 32), (64, 256, 1, 28)]
    # the 3x3/2 pool (ceil) takes 28 to 14; 4a's input is 3b's 480
    assert got[12] == (192, 480, 1, 14) and got[14] == (208, 96, 3, 16)
    assert got[-2] == (64, 24, 5, 18)
    assert all(s["ri"] == s["ci"] and s["stride"] == 1 for s in shapes)
    assert sum(s["pad"] > 0 for s in shapes) == 8
    # one pooling a step: each module's pool branch, the 3x3/2 between
    assert [(p["c"], p["hw"], p["out_hw"]) for p in
            gen.pool_shapes(CONFIG)] == [(192, 28, 28), (256, 28, 28),
                                         (480, 28, 14), (480, 14, 14),
                                         (512, 14, 14)]


@pytest.mark.parametrize("lane", ["smm_kernel", "tiled"])
def test_the_benchmarks_reference_is_the_ports_plain_one(lane):
    from repro_torch.models import inception_ref as R

    from bench.reference import inception as ref
    cfg, seed = _tiny_config(), 11
    x = gen.draw_images(cfg, TINY["traffic"], seed, "cpu")[0]
    k = iter(range(24))

    def pair():
        i = next(k)
        return gen.draw_layer(cfg, seed, i, "cpu"), \
            gen.draw_bias(cfg, seed, i, "cpu")
    steps = []
    for s in gen.plan(cfg):
        steps.append(R.Pool(**s[1]) if s[0] == "pool" else
                     R.inception_module(*[pair() for _ in range(6)]))
    want = R.forward(steps, x, lane=lane, n_unique=cfg["n_unique"])
    assert torch.equal(ref.forward(cfg, lane, seed, x), want)


def test_a_tiny_run_is_correct_and_its_int4_control_is_not(capsys):
    before, check = set(sys.modules), harness.forbidden_modules
    with mock.patch.object(harness, "forbidden_modules", lambda: [
            m for m in check() if m not in before]):
        rc = bench_run.main(["--workload", CELL, "--seed", "3000000019",
                             "--seconds", "0.3", "--trace", "0"],
                            device="cpu", overrides=TINY)
    assert rc == 0
    import json
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["checks"]["out_rel_gap"]["value"] == 0.0
    _, _, run = bench_run.prepare(CELL, 5, 1.0, False, TINY)
    driver = harness.load_module("drivers", "inception")
    assert driver.control(run, "cpu")["out_rel_gap"] > 0.1


def test_a_program_without_modules_fails_at_once(monkeypatch):
    import repro_torch.api as codr
    monkeypatch.delattr(codr, "ModuleSpec")
    _, _, run = bench_run.prepare(CELL, 5, 1.0, False, TINY)
    with pytest.raises(RuntimeError, match="no branch modules"):
        harness.load_module("drivers", "inception").drive(
            run, device="cpu", t_start=0.0)


# -- the new readers on hand-built traces -----------------------------------

_Rec = collections.namedtuple(
    "_Rec", "name start_ns end_ns id parent request thread attrs")


def _hand_run():
    """Two requests (marks 100-500, 600-900, µs).  Request 1: a module
    whose two branches (110-300, 300-450) launch K1, K2 and K3, K4; K2
    inside a pool span (150-200); K5 launched after the module.  Request
    2: one branch (610-800) launching K6 and K7, K7 inside a pool span
    (700-750); K8 has no launch record.  A branch span between the marks
    counts nowhere."""
    ev = [("user_annotation", "bench.window", 0, 1000, (1,)),
          ("user_annotation", "bench.request", 100, 500, (2,)),
          ("user_annotation", "bench.request", 600, 900, (3,))]
    ops = [("K1", 120, 130, 140), ("K2", 160, 165, 205),
           ("K3", 310, 315, 330), ("K4", 400, 405, 425),
           ("K5", 460, 470, 480), ("K6", 620, 625, 640),
           ("K7", 720, 725, 785), ("K8", None, 790, 800)]
    for corr, (name, launch, start, end) in enumerate(ops, 11):
        ev.append(("kernel", name, start, end, (corr,)))
        if launch is not None:
            ev.append(("cuda_runtime", "cudaLaunchKernel", launch,
                       launch + 2, (corr,)))
    run = harness.Run(CELL, 1, 1.0, True, {}, {}, {})
    run.trace = tr.parse(ev)
    table = (("codr.run", 105, 490, 1, 0, 1),
             ("codr.module", 108, 455, 2, 1, 1),
             ("codr.branch", 110, 300, 3, 2, 1),
             ("codr.pool", 150, 200, 4, 3, 1),
             ("codr.branch", 300, 450, 5, 2, 1),
             ("codr.run", 605, 880, 6, 0, 6),
             ("codr.branch", 610, 800, 7, 6, 6),
             ("codr.pool", 700, 750, 8, 7, 6),
             ("codr.branch", 520, 580, 9, 0, 0))
    recs = [_Rec(n, s * 1000, e * 1000, i, p, r, 1, {})
            for n, s, e, i, p, r in table]
    return run, types.SimpleNamespace(spans=lambda: list(recs))


@pytest.mark.parametrize("name, want", [
    ("cnn_pool_ms", ((205 - 165) + (785 - 725)) / 2 / 1e3),
    ("cnn_branch_launches", (4 + 2) / 2)])
def test_span_readers_read_hand_worked_values(name, want):
    run, mod = _hand_run()
    reader = harness.load_module("metrics", name)
    with mock.patch.dict(sys.modules, {"repro_torch.core.spans": mod}):
        assert reader.read(run) == pytest.approx(want)
    with mock.patch.dict(sys.modules):
        sys.modules.pop("repro_torch.core.spans", None)
        assert reader.read(run) is None


def test_quantize_pad_roofline_by_hand():
    """Two padded layers a request, batch 2: 4 · 2 · N · (plane² +
    (plane + 2 pad)²) bytes each over 3.35 TB/s; a request that lost a
    launch drops out."""
    from bench.roofline import HBM_BYTES_S
    layers = [{"m": 8, "n": 4, "rk": 1, "ck": 1, "stride": 1, "ri": 6,
               "ci": 6, "pad": 0},
              {"m": 8, "n": 4, "rk": 3, "ck": 3, "stride": 1, "ri": 8,
               "ci": 8, "pad": 1},
              {"m": 8, "n": 2, "rk": 5, "ck": 5, "stride": 1, "ri": 10,
               "ci": 10, "pad": 2}]
    name = "void (anonymous namespace)::int8_features_quantize_pad_kernel"
    ev = [("user_annotation", "bench.window", 0, 1000, (1,)),
          ("user_annotation", "bench.request", 100, 400, (2,)),
          ("user_annotation", "bench.request", 500, 800, (3,)),
          ("kernel", name, 150, 151, (11,)), ("kernel", name, 200, 203, (12,)),
          ("kernel", "smm_conv_sm90_kernel", 250, 260, (13,)),
          ("kernel", name, 550, 560, (14,))]       # request 2 lost one
    run = harness.Run(CELL, 1, 1.0, True, {}, {}, {})
    run.trace = tr.parse(ev)
    run.shapes = {"batch": 2, "layers": layers}
    bytes_ = 4 * 2 * (4 * (36 + 64) + 2 * (36 + 100))
    want = 100 * bytes_ / HBM_BYTES_S / 4e-6
    got = harness.load_module("metrics", "quantize_pad_roofline").read(run)
    assert got == pytest.approx(want)
    run.shapes = {"batch": 2, "layers": layers[:1]}
    assert harness.load_module("metrics",
                               "quantize_pad_roofline").read(run) is None


def test_max_pool_roofline_by_hand():
    """Two poolings a request, batch 3: 4 · 3 · c · (hw² + out_hw²) bytes
    each over 3.35 TB/s; a request that lost a launch drops out."""
    from bench.roofline import HBM_BYTES_S
    name = "(anonymous namespace)::int8_features_max_pool_kernel(float"
    ev = [("user_annotation", "bench.window", 0, 1000, (1,)),
          ("user_annotation", "bench.request", 100, 400, (2,)),
          ("user_annotation", "bench.request", 500, 800, (3,)),
          ("kernel", name, 150, 152, (11,)), ("kernel", name, 200, 205, (12,)),
          ("kernel", "max_pool_forward_nchw", 250, 290, (13,)),
          ("kernel", name, 550, 560, (14,))]       # request 2 lost one
    run = harness.Run(CELL, 1, 1.0, True, {}, {}, {})
    run.trace = tr.parse(ev)
    run.shapes = {"batch": 3, "pools": [{"c": 8, "hw": 6, "out_hw": 6},
                                        {"c": 5, "hw": 7, "out_hw": 3}]}
    bytes_ = 4 * 3 * (8 * (36 + 36) + 5 * (49 + 9))
    reader = harness.load_module("metrics", "max_pool_roofline")
    assert reader.read(run) == pytest.approx(
        100 * bytes_ / HBM_BYTES_S / 7e-6)
    run.shapes = {"batch": 3, "pools": []}
    assert reader.read(run) is None


# -- what the new files import ------------------------------------------------

def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", NEW_FILES, ids=lambda p: p.name)
def test_the_new_files_import_nothing_of_the_program(path):
    """No JAX, no JAX package; the program only where the driver runs it,
    through its public API inside ``drive``."""
    names = _imports(path)
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    program = {n for n in names if n.split(".")[0] == "repro_torch"}
    assert program == ({"repro_torch.api"} if "drivers" in path.parts
                       else set())
