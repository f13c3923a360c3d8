"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: cells of
smoke variants at both production meshes (records ``OK`` or ``SKIP`` as
the reference's ``applicable_shapes`` says, on the meta device); on a
small cell, its FLOPs equal ``FlopCounterMode`` over the same step on
real CPU tensors with the configuration's own attention chunks (the run
collapses them to one block); its argument bytes a device equal the sum
of each leaf's block; and the CLI at published widths allocates nothing
(the child's peak resident memory stays far below the decode cell's
bytes, which would not fit this host)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 smoke_variant)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import leaves, leaves_with_path, map_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import CellOptions, build_cell
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import rules

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _smoke_overrides(arch, **extra):
    full, smoke = get_config(arch), smoke_variant(get_config(arch))
    a, b = dataclasses.asdict(full), dataclasses.asdict(smoke)
    return {k: v for k, v in b.items() if v != a[k]} | extra


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch,extra", [
    ("qwen2.5-3b", {}), ("qwen2.5-3b", {"decode_attn": "dist"}),
    ("granite-moe-1b-a400m", {}),
    ("granite-moe-1b-a400m", {"moe_decode_2d": True}),
    ("deepseek-v2-236b", {}), ("seamless-m4t-medium", {})],
    ids=["qwen", "qwen-dist", "granite", "granite-2d", "deepseek",
         "seamless"])
def test_smoke_cells_run_on_meta(arch, extra, mesh_name):
    over = _smoke_overrides(arch, **extra)
    want = jconfigs.applicable_shapes(dataclasses.replace(
        jconfigs.get_config(arch), **over))
    for shape_name in SHAPES:
        rec = dryrun.run_cell(arch, shape_name, mesh_name,
                              cfg_overrides=over)
        assert rec["status"] == ("OK" if want[shape_name] == "run"
                                 else "SKIP"), rec
        if rec["status"] == "SKIP":
            assert rec["reason"] == want[shape_name]
            continue
        assert rec["n_devices"] == (256 if mesh_name == "pod" else 512)
        assert rec["cost"]["flops_global"] > 0
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["memory"]["arguments_fit_h100_80gb"] is True
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(coll["by_op_bytes"].values())
        # smoke MoE stacks have 8 experts: no expert lane on model = 16
        dist = (extra.get("decode_attn") == "dist"
                and SHAPES[shape_name].kind == "decode")
        assert (coll["by_op_count"]["all-reduce"] > 0) == dist, coll


def _tiny(kind):
    return ShapeConfig(f"tiny_{kind}", 32, 4, kind)


@pytest.mark.parametrize("arch,extra,kind", [
    ("qwen2.5-3b", {}, "train"), ("qwen2.5-3b", {}, "prefill"),
    ("qwen2.5-3b", {"decode_attn": "dist"}, "decode"),
    ("granite-moe-1b-a400m", {}, "train"),
    ("granite-moe-1b-a400m", {}, "prefill"),
    ("granite-moe-1b-a400m", {"moe_decode_2d": True}, "decode"),
    ("deepseek-v2-236b", {}, "prefill"),
    ("seamless-m4t-medium", {}, "train")])
def test_meta_flops_equal_a_real_cpu_run(arch, extra, kind):
    """The meta measurement on a (2, 2) meta mesh — attention in one
    block — against FlopCounterMode over the same step run for real on
    (cpu,) * 4 with the configuration's own chunks (16), random weights
    and inputs; the lanes' collectives too."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **extra)
    shape = _tiny(kind)
    rec = dryrun.measure(cfg, shape, rules.Mesh.meta((2, 2),
                                                     ("data", "model")))
    step, args, _, _ = build_cell(cfg, shape,
                                  make_host_mesh(2, 2, device="cpu"))
    gen = torch.Generator().manual_seed(0)

    def real(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(t.dtype) * 0.1
        return torch.randint(0, 7, t.shape, generator=gen).to(t.dtype)

    real_args = [map_leaves(real, a) if isinstance(a, dict) else real(a)
                 for a in args]
    if kind == "train":
        real_args[1] = adamw_init(real_args[0], AdamWConfig())
    if kind == "decode":
        real_args[3] = 5
    with FlopCounterMode(display=False) as fc, \
            rules.count_collectives() as coll:
        out = step(*real_args)
    assert all(t.device.type == "cpu" for t in leaves(out)
               if isinstance(t, torch.Tensor))
    assert rec["cost"]["flops_global"] == fc.get_total_flops() > 0
    assert rec["collectives"] == coll
    assert rec["attn_chunks"] == [shape.seq_len, shape.seq_len]


def test_argument_bytes_are_the_blocks_a_device_holds():
    """Per device: each leaf's block under its spec; int4 weights at
    half a byte (the ≥2-D params of a serving cell)."""
    cfg = smoke_variant(get_config("granite-moe-1b-a400m"))
    mesh = rules.Mesh.meta((2, 4), ("data", "model"))
    shape = ShapeConfig("d", 64, 8, "decode")
    for dtype, per in (("bf16", 2.0), ("int4", 0.5)):
        opts = CellOptions(serve_weight_dtype=dtype)
        _, args, sh, _ = build_cell(cfg, shape, mesh, options=opts)
        want = 0.0
        for i, (a, s) in enumerate(zip(args, sh)):
            pairs = zip(leaves_with_path(a) if isinstance(a, dict)
                        else [("", a)],
                        leaves(s) if isinstance(s, dict) else [s])
            for (_, leaf), ns in pairs:
                n = np.prod(rules.block_shape(leaf.shape, ns.spec, mesh))
                b = per if i == 0 and leaf.dim() >= 2 else \
                    leaf.element_size()
                want += float(n) * b
        got = dryrun.argument_bytes(args, sh, int4_params=dtype == "int4")
        assert got == want
    # serving weights this small are not FSDP-sharded: vocab over model
    emb = dict(leaves_with_path(args[0]))["embed"]
    assert tuple(rules.block_shape(emb.shape, dict(leaves_with_path(
        sh[0]))["embed"].spec, mesh)) == (512 // 4, 64)


_PEAK = r"""
import resource, runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    code = e.code
print("MAXRSS_KB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
sys.exit(code)
"""


def _cli(*argv, tmp):
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", _PEAK, *argv, "--out",
                           str(tmp)], capture_output=True, text=True,
                          timeout=300, env=env)


def test_cli_at_published_widths_allocates_nothing(tmp_path):
    child = _cli("--arch", "qwen2.5-3b", "--mesh", "both", tmp=tmp_path)
    assert child.returncode == 0, child.stderr[-2000:]
    lines = [ln for ln in child.stdout.splitlines() if ln.startswith("[")]
    assert [ln.split()[0] for ln in lines] == ["[OK]"] * 6 + ["[SKIP]"] * 2
    rec = json.loads((tmp_path /
                      "qwen2.5-3b__decode_32k__pod.json").read_text())
    cfg = get_config("qwen2.5-3b")
    cache_bytes = (2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads
                   * cfg.head_dim * 2)
    assert rec["status"] == "OK" and rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] < cache_bytes
    peak = int(child.stdout.split("MAXRSS_KB")[-1].split()[0]) * 1024
    assert peak < 2e9 < cache_bytes, peak
    skip = json.loads((tmp_path /
                       "qwen2.5-3b__long_500k__multipod.json").read_text())
    assert skip["reason"] == applicable_shapes(cfg)["long_500k"]


def test_cli_exits_1_when_a_cell_fails(tmp_path):
    child = _cli("--arch", "qwen2.5-3b", "--shape", "decode_32k",
                 "--cfg-opt", "n_kv_heads=3", "--cfg-opt", "n_layers=1",
                 tmp=tmp_path)
    assert child.returncode == 1
    assert child.stdout.startswith("[FAIL] qwen2.5-3b__decode_32k__pod")
    rec = json.loads((tmp_path /
                      "qwen2.5-3b__decode_32k__pod.json").read_text())
    assert rec["status"] == "FAIL" and "Error" in rec["error"]
