"""Dry-run of every (arch × shape × mesh) cell on the meta device — the
port's ``repro.launch.dryrun``: a shape, memory and cost check at the
published widths that needs no card and allocates nothing.

The reference lowers and compiles each cell for a 512-device TPU mesh
and reads XLA's analyses of the optimized HLO.  A torch program has no
HLO, so the port runs the cell's step itself: :func:`build_cell` over a
production meta mesh (:func:`make_production_mesh`: (16, 16), or
(2, 16, 16) with ``pod``), its arguments meta tensors, the step executed
layer by layer under ``FlopCounterMode`` and
:func:`~repro_torch.sharding.rules.count_collectives`.  Per cell:

* ``memory.argument_bytes`` — bytes one device holds of the step's
  arguments (params, optimizer state, batch, cache), summed from each
  leaf's block under its spec (``int4`` weights at 0.5 bytes), and
  ``memory.arguments_fit_h100_80gb``: whether those arguments alone fit
  one H100 80GB HBM3.  Gradients, activations and temporaries are not
  counted, so this does not say that the cell fits a card;
* ``cost.flops_global`` — ``torch.utils.flop_counter.FlopCounterMode``
  over the whole step: the FLOPs of all devices together (one
  controller runs every device's share), not per device as the
  reference's ``cost.flops`` and the two keys around it are;
* ``collectives`` — ``{total_bytes, by_op_bytes, by_op_count}``, per
  device, as the lanes' combines count them while they run (the dist
  attention's max and sums, the MoE lanes' sum and row gather).  GSPMD's
  own collectives (FSDP weight gathers, gradient reductions) have no
  eager counterpart and are not in it.

The step executes every layer, so no loop trip count is multiplied in
(the reference's ``hlo_analysis``/``reanalyze`` have no port module).
The attention chunk loop runs as one block on meta
(``attn_q_chunk`` / ``attn_kv_chunk`` set to the sequence length for
the run): every chunk pair is computed either way, so the FLOPs are the
same, and a meta op costs host time per chunk.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --mesh both
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.core.tree import leaves, leaves_with_path
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import WEIGHT_BYTES, CellOptions, build_cell
from repro_torch.sharding.rules import count_collectives, per_device_bytes

__all__ = ["OUT_DIR", "H100_HBM_BYTES", "argument_bytes", "measure",
           "run_cell", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
H100_HBM_BYTES = 80e9          # one H100 80GB HBM3


def argument_bytes(arg_shapes, in_shardings, *, int4_params: bool) -> float:
    """Bytes one device holds of the arguments: each leaf's block under
    its spec (the first argument's ≥2-D leaves at 0.5 bytes with
    ``int4_params``)."""
    total = 0.0
    for i, (args, shs) in enumerate(zip(arg_shapes, in_shardings)):
        arg_leaves = leaves_with_path(args) if isinstance(
            args, (dict, list, tuple)) else [("", args)]
        sh_leaves = leaves(shs) if isinstance(shs, (dict, list, tuple)) \
            else [shs]
        for (_, leaf), sh in zip(arg_leaves, sh_leaves):
            per = leaf.element_size()
            if int4_params and i == 0 and leaf.dim() >= 2:
                per = WEIGHT_BYTES["int4"]
            total += per_device_bytes(leaf.shape, sh.spec, sh.mesh, per)
    return total


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             options: CellOptions | None = None,
             cfg_overrides: dict | None = None, tag: str = "") -> dict:
    """One cell's record (written to disk by :func:`main`)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    skip_reason = applicable_shapes(cfg)[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "options": dataclasses.asdict(options) if options else None,
              "cfg_overrides": cfg_overrides or None, "tag": tag}
    if skip_reason != "run":
        record["status"] = "SKIP"
        record["reason"] = skip_reason
        return record

    mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
    record.update({"status": "OK", **measure(cfg, shape, mesh, options)})
    return record


def measure(cfg, shape, mesh, options: CellOptions | None = None) -> dict:
    """One cell's step on the meta mesh ``mesh``: its argument bytes a
    device, FLOPs and the lanes' collectives (the record's keys)."""
    # one attention block a sequence: the same FLOPs as the chunk loop
    cfg = dataclasses.replace(cfg, attn_q_chunk=shape.seq_len,
                              attn_kv_chunk=shape.seq_len)
    t0 = time.monotonic()
    fn, arg_shapes, in_sh, _ = build_cell(cfg, shape, mesh, options=options)
    t_build = time.monotonic() - t0
    int4 = bool(options and options.serve_weight_dtype == "int4"
                and shape.kind != "train")
    arg_bytes = argument_bytes(arg_shapes, in_sh, int4_params=int4)
    t0 = time.monotonic()
    with FlopCounterMode(display=False) as fc, count_collectives() as coll:
        out = fn(*arg_shapes)
    t_run = time.monotonic() - t0
    devices = {str(t.device) for t in leaves(out)
               if isinstance(t, torch.Tensor)}
    if devices != {"meta"}:
        raise RuntimeError(f"the meta run produced tensors on {devices}")
    return {
        "build_s": round(t_build, 1),
        "run_s": round(t_run, 1),
        "n_devices": mesh.size,
        "attn_chunks": [cfg.attn_q_chunk, cfg.attn_kv_chunk],
        "memory": {
            "argument_bytes": arg_bytes,
            "arguments_fit_h100_80gb": arg_bytes <= H100_HBM_BYTES,
        },
        "cost": {"flops_global": fc.get_total_flops()},
        "collectives": coll,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--opt", action="append", default=[],
                    help="CellOptions k=v (serve_weight_dtype, cache_dtype)")
    ap.add_argument("--cfg-opt", action="append", default=[],
                    help="ModelConfig override k=v (decode_attn=dist, "
                         "moe_decode_2d=true, block_causal=true, ...)")
    ap.add_argument("--tag", default="",
                    help="suffix for output files (perf iteration name)")
    args = ap.parse_args(argv)

    opt_kv = dict(kv.split("=", 1) for kv in args.opt)
    options = CellOptions(**opt_kv) if opt_kv else None

    def conv(v: str):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        for t in (int, float):
            try:
                return t(v)
            except ValueError:
                pass
        return v

    cfg_overrides = {k: conv(v) for k, v in
                     (kv.split("=", 1) for kv in args.cfg_opt)} or None

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                tag = f"{arch}__{shape_name}__{mesh_name}" \
                    + (f"__{args.tag}" if args.tag else "")
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_cell(arch, shape_name, mesh_name,
                                   options=options,
                                   cfg_overrides=cfg_overrides,
                                   tag=args.tag)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "OK":
                    gb = rec["memory"]["argument_bytes"] / 1e9
                    extra = (f" flops_global="
                             f"{rec['cost']['flops_global']:.3e}"
                             f" args={gb:.2f}GB/device"
                             f" arguments_fit_h100_80gb="
                             f"{rec['memory']['arguments_fit_h100_80gb']}"
                             f" coll={rec['collectives']['total_bytes']:.3e}B"
                             f" run={rec['run_s']}s")
                elif status == "FAIL":
                    extra = " " + rec["error"][:200]
                print(f"[{status}] {tag}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
