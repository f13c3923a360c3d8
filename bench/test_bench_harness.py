"""CPU tests of the benchmark harness: the pieces are found by name, the
result line keeps the contract, the arithmetic holds on hand-worked
cases, the reference agrees with the port at tiny sizes on the CPU
lanes, planted faults come out not correct, and nothing under ``bench/``
imports JAX or the JAX package.  Card tests carry the ``cuda`` marker
and skip without a card."""
from __future__ import annotations

import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from bench import harness, roofline, stats
from bench import run as bench_run
from bench import trace as tr

BENCH = harness.BENCH
BM = harness.load_benchmark()
CELLS = [w["name"] for w in BM["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TINY_CNN = {"config": {"conv_layers": [[4, 3, 3, 3, 1], [8, 4, 3, 3, 1]],
                       "input_hw": 12, "blocks": [1, 1]},
            "traffic": {"images_per_request": 4, "distinct_batches": 2,
                        "warmup_requests": 1}}
TINY_LM = {"config": {"hidden_size": 64, "num_attention_heads": 4,
                      "num_key_value_heads": 4, "qk_nope_head_dim": 16,
                      "qk_rope_head_dim": 8, "v_head_dim": 16,
                      "q_lora_rank": 32, "kv_lora_rank": 16,
                      "n_routed_experts": 8, "num_experts_per_tok": 2,
                      "moe_intermediate_size": 16, "intermediate_size": 64,
                      "vocab_size": 256},
           "traffic": {"clients": 3, "n_slots": 3, "cycle": 3,
                       "prompt_len": [4, 12], "output_len": [3, 8],
                       "sampled_requests": 3},
           # limits for the tiny model, whose logits are ~10x narrower
           # than at the published widths: over seeds 1-6 its sound runs
           # served no token more than 0.05 below the reference's best
           # (the widest 0.024), a token chosen at random lies ~0.2-0.5
           "cell": {"off_gap": 0.05,
                    "limits": {"served_logit_gap": 1.0,
                               "served_tokens_off": 0.2}}}


# an LM cell of the benchmark's LM lane (drivers/lm.py and its generator,
# reference and metrics), written into a copy of the checkout by the
# ``lm_bench`` fixture: the benchmark holds no LM cell yet
LM_CELL = "deepseek-v2.tiny"
LM_TRAFFIC = {"generator": "lm", "lane": "codr_matmul",
              "arrivals": "closed loop", "eos": None, **TINY_LM["traffic"]}
LM_ENTRIES = {
    "configs": [{"name": "deepseek-v2-236b", "source": "https://huggingface"
                 ".co/deepseek-ai/DeepSeek-V2/blob/main/config.json",
                 "file": "bench/configs/deepseek-v2-236b.json",
                 "reduced": ["num_hidden_layers"], "why": "x"}],
    "workloads": [{"name": LM_CELL, "config": "deepseek-v2-236b",
                   "traffic": "tiny", "chips": 1, "why": "x"}],
    "end_to_end": [
        {"name": n, "unit": u, "better": b, "bound": 0.25,
         "source": "host_clock", "workloads": [LM_CELL]}
        for n, u, b in (("lm_tokens_per_s", "tokens/s", "higher"),
                        ("lm_itl_p95_ms", "ms", "lower"))],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": "device_trace",
         "layer": "x", "moves": mv, "workloads": [LM_CELL]}
        for n, u, b, mv in (
            ("lm_ttft_p50_ms", "ms", "lower", "lm_itl_p95_ms"),
            ("lm_slot_occupancy", "%", "higher", "lm_tokens_per_s"),
            ("lm_step_device_ms", "ms", "lower", "lm_tokens_per_s"),
            ("codr_matmul_roofline", "%", "higher", "lm_tokens_per_s"),
            ("lm_mfu", "%", "higher", "lm_tokens_per_s"),
            ("device_idle_share.lm", "%", "lower", "lm_tokens_per_s"))]}


@pytest.fixture
def lm_bench(tmp_path, monkeypatch):
    """A copy of the checkout whose BENCHMARK.json adds ``LM_CELL``: new
    files and entries only, the harness's own files linked."""
    root = tmp_path / "checkout"
    (root / "bench").mkdir(parents=True)
    (root / "src").symlink_to(harness.ROOT / "src")
    for sub in ("drivers", "generators", "metrics", "reference"):
        (root / "bench" / sub).symlink_to(BENCH / sub)
    for sub in ("configs", "traffic", "workloads"):
        (root / "bench" / sub).mkdir()
    cfg = "deepseek-v2-236b.json"
    (root / "bench" / "configs" / cfg).write_text(
        (BENCH / "configs" / cfg).read_text())
    (root / "bench" / "traffic" / "tiny.json").write_text(
        json.dumps(LM_TRAFFIC))
    (root / "bench" / "workloads" / f"{LM_CELL}.json").write_text(
        json.dumps({"arithmetic": "bf16", **TINY_LM["cell"]}))
    bm = {k: v + LM_ENTRIES.get(k, []) if isinstance(v, list) else v
          for k, v in BM.items()}
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "bench")
    for var in bench_run.CACHE_DIRS:
        monkeypatch.delenv(var, raising=False)
    return bm


def tiny(workload: str) -> dict:
    return TINY_LM if workload.startswith("deepseek") else TINY_CNN


def run_line(capsys, workload, *, trace=0, seconds=None, build=None,
             overrides=None):
    """One run on the CPU at a tiny size; its last stdout line.  The test
    process may already hold JAX (other test files load it): the check on
    loaded modules counts only what the run itself loads."""
    lm = workload.startswith("deepseek")
    seconds = seconds or (1.5 if lm else 0.3)
    before, check = set(sys.modules), harness.forbidden_modules
    with mock.patch.object(harness, "forbidden_modules", lambda: [
            m for m in check() if m not in before]):
        rc = bench_run.main(
            ["--workload", workload, "--seed", "3000000019",
             "--seconds", str(seconds), "--trace", str(trace)],
            device="cpu", overrides=overrides or tiny(workload), build=build)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- found by name ----------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS + [LM_CELL])
def test_cell_pieces_found_by_name(cell, request):
    bm = request.getfixturevalue("lm_bench") if cell == LM_CELL else BM
    w = harness.find_cell(bm, cell)
    _, _, run = bench_run.prepare(cell, 1, 1.0, False)
    assert run.config["name"] == w["config"]
    for kind in ("driver", "generator", "reference"):
        assert (BENCH / f"{kind}s" if kind != "reference" else
                BENCH / "reference").joinpath(
                    f"{run.config[kind]}.py").is_file()
    driver = harness.load_module("drivers", run.config["driver"])
    assert callable(driver.drive) and callable(driver.control)
    assert run.cell_file["limits"]
    for trace_on in (False, True):
        defs = harness.metric_defs(bm, cell, trace_on)
        assert defs
        for m in defs:
            assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_new_cell_is_found_from_new_files_only(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    (root / "bench").mkdir(parents=True)
    for sub in ("configs", "traffic", "workloads"):
        (root / "bench" / sub).mkdir()
    bm = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bm["workloads"].append({"name": "vgg16.b4", "config": "vgg16",
                            "traffic": "b4", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    (root / "bench" / "configs" / "vgg16.json").write_text(
        (BENCH / "configs" / "vgg16.json").read_text())
    (root / "bench" / "traffic" / "b4.json").write_text(json.dumps(
        {**harness.load_json(BENCH / "traffic" / "b64.smm_kernel.json"),
         "images_per_request": 4}))
    (root / "bench" / "workloads" / "vgg16.b4.json").write_text(
        (BENCH / "workloads" / "vgg16.b64.json").read_text())
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "bench")
    _, cell, run = bench_run.prepare("vgg16.b4", 1, 1.0, False)
    assert cell["traffic"] == "b4"
    assert run.traffic["images_per_request"] == 4
    assert run.cell_file["arithmetic"] == "int8"


# -- BENCHMARK.json ---------------------------------------------------------

def test_benchmark_json_keeps_the_contract():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"] and 1 <= BM["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BM["command"])
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BM[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BM["configs"]:
        assert pathlib.Path(harness.ROOT / c["file"]).is_file()
        assert c["reduced"] == harness.load_json(
            harness.ROOT / c["file"])["reduced"]
    for w in BM["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e_here = [m for m in harness.metric_defs(BM, w["name"], False)]
        assert "setup_s" in {m["name"] for m in e2e_here}
        assert len(e2e_here) >= 2
        assert harness.metric_defs(BM, w["name"], True)
    for m in BM["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_deepseek_config_names_each_cut():
    cfg = harness.load_json(BENCH / "configs" / "deepseek-v2-236b.json")
    published = cfg["published"]
    assert published["num_hidden_layers"] == 60
    for key in cfg["reduced"]:
        assert key in published and cfg[key] != published[key]
    widths = ("hidden_size", "intermediate_size", "moe_intermediate_size",
              "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok",
              "n_routed_experts", "vocab_size", "num_attention_heads")
    assert not set(widths) & set(cfg["reduced"])
    assert (cfg["hidden_size"], cfg["n_routed_experts"],
            cfg["num_experts_per_tok"], cfg["vocab_size"]) == \
        (5120, 160, 6, 102400)


def test_vgg16_blocks_drive_the_published_planes():
    from bench.generators import cnn as gen
    cfg = harness.load_json(BENCH / "configs" / "vgg16.json")
    blocks = gen.blocks(cfg)
    assert [(b["plane"], b["border"], b["pool"]) for b in blocks] == \
        [(224, 2, 2), (112, 2, 2), (56, 3, 0)]
    ri = [s["ri"] for s in gen.layer_shapes(cfg)]
    assert ri == [228, 226, 116, 114, 62, 60, 58]
    # each block gives back its published plane, VALID on its border
    assert [ri[1] - 2, ri[3] - 2, ri[6] - 2] == [224, 112, 56]


# -- the result line ----------------------------------------------------------

@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS + [LM_CELL])
def test_result_line_has_the_contract_keys(capsys, request, cell, trace):
    bm = request.getfixturevalue("lm_bench") if cell == LM_CELL else BM
    line = run_line(capsys, cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    want = {m["name"] for m in harness.metric_defs(bm, cell, bool(trace))}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_no_card_means_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


def test_no_program_means_no_result(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "program is missing" in out.err


# -- arithmetic ---------------------------------------------------------------

def test_percentile_rate_and_union_match_hand_values():
    xs = [float(x) for x in range(1, 101)]
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.median([3, 1, 2]) == 2.0
    assert stats.rate(160, 2.0) == 80.0
    assert stats.union_s([(0, 2), (1, 3), (5, 6), (-1, 0.5)], 0, 5.5) == 3.5


def _cnn_run(request_ms):
    run = harness.Run("vgg16.b64", 1, 1.0, False, {}, {}, {})
    run.samples = {"request_ms": request_ms, "enqueue_ms": request_ms}
    run.window_s = sum(request_ms) / 1e3
    run.work = {"images": 16 * len(request_ms)}
    return run


def test_a_stall_in_the_window_moves_the_tail_and_the_rate():
    read = {n: harness.load_module("metrics", n).read
            for n in ("cnn_images_per_s", "cnn_request_p95_ms")}
    steady = _cnn_run([30.0] * 100)
    stalled = _cnn_run([30.0] * 90 + [130.0] * 10)
    assert read["cnn_images_per_s"](steady) == pytest.approx(16 / 0.03)
    assert read["cnn_images_per_s"](stalled) == pytest.approx(
        1600 / 4.0)
    assert read["cnn_request_p95_ms"](steady) == pytest.approx(30.0)
    assert read["cnn_request_p95_ms"](stalled) == pytest.approx(130.0)


def test_lm_rates_and_shares_from_the_clients_stamps():
    run = harness.Run(LM_CELL, 1, 2.0, False, {}, {}, {})
    run.window_s = 2.0
    run.work = {"tokens_out": 400, "first_tokens": 8, "prompt_tokens": 800}
    run.samples = {"itl_ms": [50.0] * 95 + [300.0] * 5, "ttft_ms": [80.0]}
    run.counters = {"steps_run": 25, "n_slots": 16}
    run.shapes = {"params_per_token": 1e9}
    rd = lambda n: harness.load_module("metrics", n).read(run)  # noqa: E731
    assert rd("lm_tokens_per_s") == 200.0
    assert rd("lm_itl_p95_ms") == pytest.approx(50.0 + 0.05 * 250.0)
    assert rd("lm_ttft_p50_ms") == 80.0
    assert rd("lm_slot_occupancy") == pytest.approx(100 * 392 / 400)
    assert rd("lm_mfu") == pytest.approx(
        100 * 2e9 * (800 + 392) / 2.0 / 989e12)


def test_roofline_counts_on_a_toy_shape_by_hand():
    ops, n_bytes = roofline.smm_conv_counts(
        batch=2, n_in=3, ri=5, ci=5, m=4, rk=3, ck=3, stride=1, nonzero=10,
        n_unique=16)
    assert ops == 2 * 10 * 9 * 2
    assert n_bytes == 2 * 25 * 3 + 4 * 3 * 9 * 4 / 8 + 2 * 9 * 4 * 4
    ops, n_bytes = roofline.codr_matmul_counts(m=2, k=8, n=4, bits=4)
    assert ops == 128 and n_bytes == 32 + 16 + 64 + 4 + 16
    assert roofline.bound_s(3.35e12, 1.0, "int8") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 989e12, "bf16") == pytest.approx(1.0)


def test_lm_counts_on_a_toy_config_by_hand():
    c = {"hidden_size": 8, "q_lora_rank": 4, "kv_lora_rank": 2,
         "qk_rope_head_dim": 2, "qk_nope_head_dim": 2, "v_head_dim": 2,
         "num_attention_heads": 2, "intermediate_size": 16,
         "moe_intermediate_size": 4, "n_shared_experts": 2,
         "n_routed_experts": 6, "num_experts_per_tok": 2,
         "first_k_dense_replace": 1, "num_hidden_layers": 3,
         "vocab_size": 10}
    mla = 8 * 4 + 4 * 8 + 8 * 4 + 2 * 8 + 4 * 8
    dense, moe = 3 * 8 * 16, 8 * 6 + 2 * 3 * 8 * 4 + 3 * 8 * 8
    assert roofline.mla_moe_params_per_token(c) == \
        (mla + dense) + 2 * (mla + moe) + 10 * 8
    mm = roofline.mla_moe_step_matmuls(c)
    assert len(mm) == 21 and mm[:7] == [(8, 4), (4, 8), (8, 4), (4, 8),
                                        (8, 16), (8, 16), (16, 8)]
    assert mm[7 + 4:7 + 7] == [(8, 8), (8, 8), (8, 8)]


def test_cnn_mfu_and_smm_roofline_by_hand():
    run = harness.Run("vgg16.b64", 1, 1.0, True, {}, {}, {})
    run.shapes = {"batch": 2, "n_unique": 16, "arithmetic": "int8",
                  "nonzero": [10],
                  "layers": [{"m": 4, "n": 3, "rk": 3, "ck": 3,
                              "stride": 1, "ri": 5, "ci": 5}]}
    run.work = {"images": 2000}
    run.window_s = 2.0
    mfu = harness.load_module("metrics", "cnn_mfu").read(run)
    assert mfu == pytest.approx(100 * 2 * 10 * 9 * 2000 / 2.0 / 1979e12)
    bound = max(492 / 3.35e12, 360 / 1979e12)
    events = [("user_annotation", "bench.window", 0, 100, (1,))]
    for i in range(3):                   # request 1 lost its kernel record
        events.append(("user_annotation", "bench.request", 30 * i,
                       30 * i + 20, (2,)))
        if i != 1:
            events.append(("kernel", "smm_conv_sm90_kernel<2>", 30 * i + 5,
                           30 * i + 9, (10 + i,)))
            events.append(("cuda_runtime", "cudaLaunchKernel", 30 * i + 1,
                           30 * i + 2, (10 + i,)))
    run.trace = tr.parse(events)
    share = harness.load_module("metrics", "smm_conv_roofline").read(run)
    assert share == pytest.approx(100 * 2 * bound / 8e-6)


def test_trace_parse_groups_replays_and_busy_time():
    ev = [("user_annotation", "bench.window", 0, 1000, (1,))]
    for r in range(4):                   # four replays, the last lost one
        ev.append(("cuda_runtime", "cudaGraphLaunch", 200 * r, 200 * r + 5,
                   (100 + r,)))
        for k in range(3 if r < 3 else 2):
            start = 200 * r + 10 + 20 * k
            ev.append(("kernel", f"codr_matmul_splitk_kernel<{k}>", start,
                       start + 10, (0, 100 + r)))
    t = tr.parse(ev)
    assert len(t.replays()) == 4 and t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(110e-6)
    run = harness.Run("x", 1, 1.0, True, {}, {}, {})
    run.trace = t
    step = harness.load_module("metrics", "lm_step_device_ms").read(run)
    assert step == pytest.approx(0.030)
    run.shapes = {"n_slots": 2, "bits": 4, "step_matmuls": [(8, 4)] * 3}
    ops, n_bytes = roofline.codr_matmul_counts(m=2, k=8, n=4, bits=4)
    one = roofline.bound_s(n_bytes, ops, "bf16")
    share = harness.load_module("metrics", "codr_matmul_roofline").read(run)
    assert share == pytest.approx(100 * 3 * 3 * one / (9 * 10e-6))
    idle = harness.load_module("metrics", "device_idle_share.lm").read(run)
    assert idle == pytest.approx(100 * (1 - 0.110))
    assert t.idle_gaps()[0][0] in ("launch cudaGraphLaunch", "window end")


class _Event:
    """A profiler event as older torch gives it: no activity_type."""

    def __init__(self, name, dev, start, dur, corr, linked=0):
        self._v = (name, dev, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_profiler_events_without_a_category_are_classified():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ev = [_Event("bench.window", cpu, 0, 100_000, 1),
          _Event("bench.request", cpu, 1_000, 50_000, 2),
          _Event("aten::add", cpu, 2_000, 1_000, 3),
          _Event("cudaLaunchKernel", cpu, 2_500, 100, 40),
          _Event("add_kernel", gpu, 10_000, 5_000, 0, 40),
          _Event("bench.request", gpu, 9_000, 8_000, 0)]
    t = tr.parse(tr.rows(ev))
    assert t.window == (0.0, 100.0) and t.groups[0][0] == "request"
    (op,) = t.ops
    assert (op.name, op.group, op.launch, op.corr) == \
        ("add_kernel", 0, "cudaLaunchKernel", 40)
    assert [h[0] for h in t.host] == ["aten::add"]
    assert t.busy_s() == pytest.approx(5e-6)


# -- the reference against the port, tiny, on the CPU ---------------------

def test_cnn_reference_quantizes_as_the_port():
    from repro_torch.core import ucr

    from bench.reference import cnn as ref
    w = torch.randn(8, 4, 3, 3) * 0.5
    w[torch.rand(w.shape) > 0.4] = 0
    q, scale = ref.quantize_weights(w, 16)
    qp, sp = ucr.quantize_int8(w.numpy())
    qp = ucr.restrict_unique(qp, 16)
    assert np.array_equal(q.numpy().astype(np.int8), qp)
    assert scale == float(sp)


def test_cnn_reference_scale_is_amax_over_127_correctly_rounded():
    from bench.reference.cnn import _int_features
    g = torch.Generator().manual_seed(7)
    for _ in range(20):
        x = torch.rand((3, 5, 5, 4), generator=g) * 37.3
        _, scale = _int_features(x, 8)
        amax = np.float32(x.abs().max().item())
        assert scale == float(np.float32(amax) / np.float32(127))


def test_lm_reference_dequantizes_as_the_port_packs():
    from repro_torch.core.codr_linear import pack_projection

    from bench.reference.mla_moe import dequantize_
    w = torch.randn(2, 3, 16, 24)
    want = pack_projection(w, n_unique=16).dense(torch.float32)
    assert torch.equal(dequantize_(w.clone(), 16), want)


@pytest.mark.parametrize("cell", CELLS + [LM_CELL])
def test_reference_agrees_with_the_port_at_a_tiny_size(capsys, request,
                                                        cell):
    if cell == LM_CELL:
        request.getfixturevalue("lm_bench")
    line = run_line(capsys, cell)
    assert line["correct"] is True
    for c in line["checks"].values():
        assert c["value"] <= c["limit"] / 10
    if cell == "vgg16.b64":               # the integer lane: bit for bit
        assert line["checks"]["out_rel_gap"]["value"] == 0.0


# -- planted faults and the controls ----------------------------------------

class _Broken:
    """The program's model with a fault under ``run``."""

    def __init__(self, model, fault):
        self.model, self.fault = model, fault

    def run(self, x):
        if self.fault == "half_batch":
            half = x.shape[0] // 2
            y = self.model.run(x[:half])
            return torch.cat([y, y[: x.shape[0] - half]])
        y = self.model.run(x).clone(memory_format=torch.contiguous_format)
        # off by half the largest output: the smm_kernel limit (0.1) lets
        # through the ~1e-2 that a one-ulp int8 scale cascades to
        y.view(-1)[7] += 0.5 * float(y.abs().max())
        return y


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["vgg16.b64", "vgg16.tiled.b64"])
def test_cnn_faults_come_out_not_correct(capsys, cell, fault):
    line = run_line(capsys, cell, build=lambda m: _Broken(m, fault))
    assert line["correct"] is False


def _alter_token(batcher):
    """Every third emitted token is replaced by the next id, where the
    pooled step produces it."""
    step = batcher._step_fn

    def broken(params, pool, toks, poss):
        logits, pool = step(params, pool, toks, poss)
        bad = logits.clone()
        bad[:, 0] = bad.max() + 1.0          # id 0 wins every row
        return bad, pool
    batcher._step_fn = broken
    return batcher


def _half_batch(batcher):
    """The pooled step computes the first half of the slots and copies
    those rows over the rest."""
    step = batcher._step_fn

    def broken(params, pool, toks, poss):
        logits, pool = step(params, pool, toks, poss)
        half = (logits.shape[0] + 1) // 2
        bad = logits.clone()
        bad[half:] = logits[: logits.shape[0] - half]
        return bad, pool
    batcher._step_fn = broken
    return batcher


@pytest.mark.parametrize("fault", [_alter_token, _half_batch])
def test_lm_faults_come_out_not_correct(capsys, lm_bench, fault):
    # four slots, and every request the window finished in the sample
    over = {**TINY_LM, "traffic": {**TINY_LM["traffic"], "clients": 4,
                                   "n_slots": 4, "cycle": 4,
                                   "sampled_requests": 1000}}
    line = run_line(capsys, LM_CELL, build=fault, overrides=over)
    assert line["correct"] is False


def test_int4_features_fail_the_smm_lane_limit():
    _, _, run = bench_run.prepare("vgg16.b64", 5, 1.0, False, TINY_CNN)
    driver = harness.load_module("drivers", "cnn")
    got = driver.control(run, "cpu")["out_rel_gap"]
    assert got > 0.1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_tf32_fails_the_tiled_lane_limit_on_the_card(card):
    _, _, run = bench_run.prepare("vgg16.tiled.b64", 5, 1.0, False,
                                  {"traffic": {"images_per_request": 2}})
    driver = harness.load_module("drivers", "cnn")
    got = driver.control(run, "cuda")["out_rel_gap"]
    assert got > run.cell_file["limits"]["out_rel_gap"]


# -- what the benchmark may import -------------------------------------------

def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if "reference" in path.parts or path.name in ("roofline.py",
                                                  "stats.py"):
        assert "repro_torch" not in tops


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        {"repro_torch": 1, "repro_torch.api": 1, "reprox": 1}) == []
    assert harness.forbidden_modules(
        {"repro": 1, "jax.numpy": 1, "flax": 1, "os": 1}) == \
        ["flax", "jax.numpy", "repro"]


def test_a_run_in_a_fresh_process_loads_no_jax():
    """``main`` returns non-zero where JAX or the JAX package got loaded;
    a run of a fresh interpreter on the CPU returns zero."""
    code = ("import sys; from bench import run; sys.exit(run.main(["
            "'--workload', 'vgg16.b64', '--seed', '1', '--seconds', '0.2'],"
            f" device='cpu', overrides={TINY_CNN!r}))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(harness.ROOT), str(harness.ROOT / "src")])}
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("value", [math.inf, 1.0])
def test_a_failed_check_makes_the_run_not_correct(value):
    run = harness.Run("x", 1, 1.0, False, {}, {}, {})
    run.check("a", 0.0, 0.5)
    assert run.correct
    run.check("b", value, 0.5)
    assert not run.correct
