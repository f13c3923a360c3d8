#!/usr/bin/env python3
"""The CNN engine's float lanes on one NVIDIA GPU under several
output-channel group counts.

    python3 sharded_probe.py [--groups 1 4 8 16] [--seed 0] [--phase]

For each group count (``repro_torch.core.engine.CHANNEL_GROUPS``; 1 is
one call a layer, the structure of ``tiled`` before the groups) it runs
the VGG16 model of ``chip_smoke.py``'s first path (conv1_1..conv3_3,
density 0.4, U = 16, batch-4 requests of 226×226×3 images from the seed)
on ``tiled`` and, for more than one group, on ``sharded`` at D = 2 and 4
over cuda:0 repeated: 3 requests a lane, the last two timed on the host
clock after a synchronize, each D's outputs against ``tiled``'s
(max-abs; 0 is bit for bit), and one request under ``torch.profiler``
with the number of FFT kernels in it.  Then each layer of ``tiled``
alone: CUDA events over 5 calls after one warm-up.  ``--phase`` then
runs ``chip_smoke.sharded_phase`` on the model at the engine's own group
count.

Prints one line per lane and layer and writes
``build/probe/sharded_probe.json``.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def _reset(model) -> None:
    """Drop the layers' cached groups and placements."""
    for layer in model.layers:
        layer._groups_dev = None
        layer._shard_state = None
    model._run_sharded = None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sharded_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.api as codr
    from repro_torch.configs.paper_cnns import VGG16
    from repro_torch.core import backends, engine
    from repro_torch.core.backends import ShardedBackend
    from repro_torch.sharding import rules

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cs.SMI = smi
    print(smi, flush=True)
    spec = codr.ModelSpec.from_shapes(VGG16[:7], None, density=0.4,
                                      rng=np.random.default_rng(args.seed))
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel", device="cuda")
    img_rng = np.random.default_rng(args.seed + 9)
    images = [img_rng.integers(0, 256, size=(4, 226, 226, 3)).astype(
        np.float32) for _ in range(3)]
    fft = re.compile(r"fft", re.IGNORECASE)
    conv = re.compile(r"conv|cudnn|implicit|gemm|xmma|winograd|fft")
    default, rows = engine.CHANNEL_GROUPS, []
    for g in args.groups:
        engine.CHANNEL_GROUPS = g
        _reset(compiled.model)
        lanes = {"tiled": backends.get_backend("tiled")}
        if g > 1:
            lanes.update({d: ShardedBackend(rules.tile_mesh(["cuda:0"] * d))
                          for d in (2, 4)})
        tiled = None
        for d, lane in lanes.items():
            ms, ys = [], []
            for x in images:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ys.append(compiled.run(x, backend=lane))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            tiled = ys if d == "tiled" else tiled
            err = max(float((y - t).abs().max()) for y, t in zip(ys, tiled))
            prof = cs._profile(lambda: compiled.run(images[1], backend=lane),
                               "conv", conv, extra=("fft", fft))
            row = {"groups": g, "lane": d, "first_ms": ms[0],
                   "steady_ms": ms[1:], "max_abs_vs_tiled": err,
                   "fft_launches": prof["fft_launches"],
                   "conv_launches": prof["conv_launches"],
                   "device_busy_ms": prof["device_busy_ms"],
                   "top": prof["top"]}
            rows.append(row)
            print(f"groups {g} lane {d}: steady "
                  f"{[round(t, 3) for t in ms[1:]]} ms (first "
                  f"{ms[0]:.3f}), vs tiled max-abs {err!r}, conv kernels "
                  f"{prof['conv_launches']}, FFT {prof['fft_launches']}, "
                  f"device busy {prof['device_busy_ms']:.3f} ms; top "
                  f"{prof['top'][:3]} [{smi}]", flush=True)
        del ys, tiled
        x = compiled.model.as_input(images[0])
        for layer in compiled.model.layers:
            y = layer(x)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(5):
                layer(x)
            end.record()
            torch.cuda.synchronize()
            t = start.elapsed_time(end) / 5
            rows.append({"groups": g, "layer": layer.name, "ms": t})
            print(f"groups {g} {layer.name}: {t:.4f} ms a call "
                  f"({len(layer.groups_device)} groups) [{smi}]", flush=True)
            x = y
        del x, y
    engine.CHANNEL_GROUPS = default
    _reset(compiled.model)
    out = ROOT / "build/probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "sharded_probe.json").write_text(json.dumps(
        {"device": smi, "rows": rows}, indent=1))
    if args.phase:
        t0 = time.perf_counter()
        cs.sharded_phase(argparse.Namespace(seed=args.seed), compiled)
        print(f"sharded phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
