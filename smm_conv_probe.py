#!/usr/bin/env python3
"""Where the time of the ``smm_conv`` tensor-core instance goes, on one
NVIDIA GPU.

    python3 smm_conv_probe.py [--seed 0]

Builds copies of ``smm_conv_sm90.cu`` with one part cut out each (under
``build/probe/``, one ``nvcc`` per copy, all started together) and times
every copy with CUDA events, 20 launches back to back after one warm-up,
at three VGG16 shapes (batch 4, random int8 weights at density 0.4,
U = 16): conv1_1 and conv3_2 at the main path's sizes (226² and 216²)
and conv3_2 at its published size (58²).  A cut-down copy computes
nothing useful; the full one is held to the plain version (max-abs-diff
0).  The copies:

* ``full``: the kernel as it is;
* ``empty``: returns at once (the launch, host time included);
* ``phase1``: returns after the grid barrier (decode + conversion);
* ``noconvert``: phase 1 without converting x;
* ``nostore``: without the epilogue's stores (the raw sums: the copies
  run without the layer's epilogue operands);
* ``nomma``: without the ``wgmma``s;
* ``noload``: without the copies of every item after the first two;
* ``wm1``: 64 x 512 tiles at every M (the kernel takes 128 x 256 above
  M = 64).

Beside ``full`` (the raw sums) it times ``full_fused``: the same source
launched with the layer's epilogue in its store (a scale, ReLU), held to
the plain epilogue of the plain version bit for bit.

Prints one line per shape and writes ``build/probe/smm_conv_probe.json``.
Without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
SOURCE = ROOT / "src/repro_torch/kernels/smm_conv/csrc/smm_conv_sm90.cu"
# (text to find, text to put in its place) per copy; each text occurs once
CUTS = {
    "full": [],
    "empty": [("  uint8_t* xs = scratch + g.xs_off;\n",
               "  uint8_t* xs = scratch + g.xs_off;\n  if (g.kh > 0) return;\n")],
    "phase1": [("  grid_barrier(reinterpret_cast<unsigned*>(scratch));\n",
                "  grid_barrier(reinterpret_cast<unsigned*>(scratch));\n"
                "  if (g.kh > 0) return;\n")],
    "noconvert": [("    convert_x<4>(g, batch, x, xs);\n", "    ;\n"),
                  ("    convert_x<1>(g, batch, x, xs);\n", "    ;\n")],
    "nostore": [("      store(k, k % kStages);\n",
                 "      if (g.kh < 0) store(k, k % kStages);\n")],
    "nomma": [("    mma(k % kStages, ch == 0);\n", "")],
    "noload": [("    if (k + kStages - 1 < items)\n      load(",
                "    if (k + kStages - 1 < items && g.kh < 0)\n      load(")],
    "wm1": [("  const int wm = g.m_out > 64 && ",
             "  const int wm = false && ")],
}
# (M, N, input side, batch) of the probed layers, 3x3, stride 1
SHAPES = {"conv1_1": (64, 3, 226, 4), "conv3_2": (256, 256, 216, 4),
          "conv3_2 published": (256, 256, 58, 4)}


def build(name: str):
    """Compile the copy ``name``; returns its launch function."""
    from repro_torch.kernels import _build
    text = SOURCE.read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    path = _build.BUILD_DIR / "probe" / f"smm_conv_sm90_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    fn = _build.load_library(path).smm_conv_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 10
                   + [ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and inputs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("smm_conv_probe: no CUDA device; this script runs only on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import ucr
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_features.ref import epilogue_plain
    from repro_torch.kernels.smm_conv import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(CUTS)) as pool:
        fns = dict(zip(CUTS, pool.map(build, CUTS)))

    def ms(call, reps: int = 20) -> float:
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for label, (m, n, hw, b) in SHAPES.items():
        w = rng.normal(size=(m, n, 3, 3)).astype(np.float32)
        w[rng.random(w.shape) > 0.4] = 0
        code = ucr.encode_conv_layer(w, t_m=4, t_n=4, n_unique=16)
        deltas, entries, meta = ops.smm_operands_on(code, n, "cuda")
        x = torch.from_numpy(rng.integers(-127, 128, size=(b, n, hw, hw))
                             .astype(np.float32)).cuda()
        ro = co = hw - 2
        plan = ops.sm90_plan(tuple(x.shape), tuple(deltas.shape), t_m=4,
                             ro=ro, co=co)
        scratch = torch.zeros(plan["scratch_bytes"], dtype=torch.uint8,
                              device="cuda")
        out = torch.empty(b, m, ro, co, device="cuda")
        x_scale = torch.tensor([0.0173], device="cuda")
        row = {}
        for name, fn in fns.items():
            def call(fn=fn, epi=(None, 0.0, None, 0, 0, 0)):
                err = fn(x.data_ptr(), deltas.data_ptr(), entries.data_ptr(),
                         out.data_ptr(), scratch.data_ptr(), scratch.numel(),
                         b, n, hw, hw, deltas.shape[0], deltas.shape[2],
                         entries.shape[2], 4, ro, co, *epi, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            row[name] = ms(call)
            if name == "full":
                want = ref.smm_conv_plain(x, deltas, entries, t_m=4, ro=ro,
                                          co=co)
                row["full_max_abs_diff"] = float((out - want).abs().max())
                fused = functools.partial(call, epi=(
                    x_scale.data_ptr(), 0.0421, None, 1, m, m))
                row["full_fused"] = ms(fused)
                same = torch.equal(out, epilogue_plain(
                    want, x_scale, 0.0421, None, True).permute(0, 3, 1, 2))
                if row["full_max_abs_diff"] != 0.0 or not same:
                    print(f"smm_conv_probe: {label}: full copy vs plain "
                          f"max-abs-diff {row['full_max_abs_diff']}, fused "
                          f"equal to the plain epilogue: {same}",
                          file=sys.stderr)
                    return 1
        result[label] = row
        print(f"{label} [{m}, {n}, 3, 3, {hw}, {hw}, batch {b}] ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    (_build.BUILD_DIR / "probe" / "smm_conv_probe.json").write_text(
        json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
