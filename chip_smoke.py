#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernel from the sources in this checkout, drives
the port's main path (CNN inference from compressed weights: spec →
``compile`` → ``CompiledModel.run`` on the ``smm_kernel`` backend) at the
published widths of VGG16, holds the kernel against its plain PyTorch
version on the card, times it, and prints one JSON line per the smoke
contract: a ``kernels`` line, then ``{"ok": true, "device": {...}}`` as the
last line.  Any failed phase exits non-zero before the result lines;
without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

INT8_TOPS = 1979e12      # H100 SXM dense int8 tensor-core peak, op/s
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3 bandwidth, bytes/s
# end-to-end smm_kernel vs tiled: both run the same decoded weights, but
# smm_kernel re-quantizes every layer's input activations to int8
# (round-to-nearest, step amax/127), which the float tiled lane does
# not; over 7 layers that error stays within 5% of the output's range
E2E_REL_TOL = 0.05
KERNEL = {"name": "smm_conv", "route": "cuda",
          "source": "src/repro_torch/kernels/smm_conv/csrc/smm_conv.cu",
          "replaces": "src/repro/kernels/smm_conv/kernel.py:88"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the images")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import numpy as np
    import torch.nn.functional as F

    import repro_torch.api as codr
    from repro_torch.configs.paper_cnns import ALEXNET, GOOGLENET, VGG16
    from repro_torch.core import ucr
    from repro_torch.core.backends import _int_activations
    from repro_torch.core.engine import full_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels.smm_conv import ops, ref

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    ops.load_kernel()
    say(f"build: smm_conv.cu -> {_build.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
    for log in sorted(_build.BUILD_DIR.glob("libsmm_conv-*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")

    # -- 3. main path, published VGG16 widths ------------------------------
    shapes = VGG16[:7]              # conv1_1 .. conv3_3, 226x226x3 input
    batch, n_requests = 4, 3
    say("cuts: depth 13 -> 7 conv layers (conv1_1..conv3_3; the offline "
        "encoder's time grows with the vector count, ~48k vectors vs "
        "~409k for all 13); no linear head (from_shapes' head at "
        "212*212*256 features would be 115M weights to encode)")
    spec = codr.ModelSpec.from_shapes(shapes, None, density=0.4,
                                      rng=np.random.default_rng(args.seed))
    t0 = time.perf_counter()
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel", device="cuda")
    encode_s = time.perf_counter() - t0
    say(f"encode: {len(spec)} conv layers, {compiled.total_bits()} bits, "
        f"{compiled.bits_per_weight():.3f} bits/weight, {encode_s:.2f} s")
    img_rng = np.random.default_rng(args.seed + 1)
    images = [img_rng.integers(0, 256, size=(batch, 226, 226, 3)).astype(
        np.float32) for _ in range(n_requests)]

    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    outs, req_ms = [], []
    for x in images:
        t0 = time.perf_counter()
        y = compiled.run(x)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(y)
    launches = ops.launches
    peak = torch.cuda.max_memory_allocated()
    for i, ms in enumerate(req_ms):
        say(f"request {i}: batch {batch}, {ms:.3f} ms"
            f"{' (first: decodes the bitstreams, packs operands)' if i == 0 else ''}")
    steady = req_ms[1:]
    say(f"images/s (requests 1..{n_requests - 1}): "
        f"{batch * len(steady) / (sum(steady) / 1e3):.3f}; peak device "
        f"memory {peak} bytes; smm_conv launches {launches}")
    if launches != len(spec) * n_requests:
        fail(f"main path launched smm_conv {launches} times, expected "
             f"{len(spec) * n_requests}")
    out_shape = (batch, 212, 212, 256)
    for y in outs:
        if tuple(y.shape) != out_shape or not bool(torch.isfinite(y).all()):
            fail(f"output {tuple(y.shape)} not finite {out_shape}")

    # -- 4. kernel checks, 5. timing ---------------------------------------
    rows, max_err = [], 0.0
    x = compiled.model.as_input(images[0])
    ri = ci = 226
    for layer in compiled.model.layers:
        xi, _ = _int_activations(x)
        xin = xi.permute(0, 3, 1, 2).contiguous()
        deltas, entries, meta = layer.smm_operands()
        ro, co = layer.out_hw(ri, ci)
        kw = dict(t_m=meta["t_m"], ro=ro, co=co, stride=layer.stride)
        yk = ops.smm_conv_cuda(xin, deltas, entries, **kw)
        yp = ref.smm_conv_plain(xin, deltas, entries, **kw)
        err = float((yk - yp).abs().max())
        max_err = max(max_err, err)
        if err != 0.0:
            fail(f"{layer.name}: kernel vs plain max-abs-diff {err}")
        w = torch.from_numpy(layer.decoded_weights().astype(np.float32)
                             * layer.scale).cuda()

        def library(xin=xin, w=w, s=layer.stride):
            with full_fp32():
                return F.conv2d(xin, w, stride=s)

        st = layer.stats()
        m, n, rk, ck = layer.code.shape
        n_bytes = 4 * (xin.numel() + deltas.numel() + entries.numel()
                       + yk.numel())
        n_ops = 2 * batch * st.n_nonzero * ro * co
        row = {"layer": layer.name, "shape": [m, n, rk, ck, ri, ci,
                                              layer.stride],
               "max_abs_err": err,
               "ms": cuda_ms(lambda: ops.smm_conv_cuda(xin, deltas, entries,
                                                       **kw), 5),
               "plain_ms": cuda_ms(lambda: ref.smm_conv_plain(
                   xin, deltas, entries, **kw), 2),
               "library_ms": cuda_ms(library, 5),
               "ops": n_ops, "bytes": n_bytes,
               "bound_ms": max(n_ops / INT8_TOPS, n_bytes / HBM_BYTES_S) * 1e3,
               "bound_by": "operations" if n_ops / INT8_TOPS
               > n_bytes / HBM_BYTES_S else "bytes"}
        rows.append(row)
        say(f"{layer.name} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, F.conv2d {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"max-abs-diff {err}")
        x = compiled.backend.conv(layer, x)
        ri, ci = ro, co
    if not torch.equal(x, outs[0]):
        fail("layer-by-layer replay of request 0 differs from the main path")

    for net, s in (("alexnet conv1", ALEXNET[0]),
                   ("googlenet conv1", GOOGLENET[0])):
        rng = np.random.default_rng(args.seed + 2)
        wt = rng.normal(size=(s.m, s.n, s.rk, s.ck)).astype(np.float32)
        wt[rng.random(wt.shape) > 0.4] = 0
        code = ucr.encode_conv_layer(wt, n_unique=16)
        xs = torch.from_numpy(rng.integers(-127, 128, size=(
            batch, s.n, s.ri, s.ci)).astype(np.float32)).cuda()
        deltas, entries, meta = ops.smm_operands_on(code, s.n, "cuda")
        kw = dict(t_m=meta["t_m"], ro=s.ro, co=s.co, stride=s.stride)
        err = float((ops.smm_conv_cuda(xs, deltas, entries, **kw)
                     - ref.smm_conv_plain(xs, deltas, entries, **kw))
                    .abs().max())
        max_err = max(max_err, err)
        say(f"{net} ({s.rk}x{s.rk}, stride {s.stride}, {s.ri}^2): kernel vs "
            f"plain max-abs-diff {err}")
        if err != 0.0:
            fail(f"{net}: kernel vs plain max-abs-diff {err}")

    y_tiled = compiled.run(images[0], backend="tiled")
    y_qref = compiled.quantized_reference(images[0])
    scale = float(y_tiled.abs().max())
    rel_q = float((y_tiled - y_qref).abs().max()) / scale
    rel = float((outs[0] - y_tiled).abs().max()) / scale
    say(f"end to end: smm_kernel vs tiled rel max-abs err {rel:.6f} "
        f"(tolerance {E2E_REL_TOL}, int8 activation quantization); tiled "
        f"vs quantized_reference {rel_q:.3e} (tolerance 1e-4)")
    if not rel <= E2E_REL_TOL:
        fail(f"smm_kernel vs tiled rel err {rel} > {E2E_REL_TOL}")
    if not rel_q <= 1e-4:
        fail(f"tiled vs quantized_reference rel err {rel_q} > 1e-4")

    # -- 6. result lines ---------------------------------------------------
    kernel = dict(KERNEL, launches=launches, max_abs_err=max_err,
                  ms=sum(r["ms"] for r in rows),
                  plain_ms=sum(r["plain_ms"] for r in rows),
                  bound_ms=sum(r["bound_ms"] for r in rows),
                  bound_by=("operations" if sum(r["ops"] for r in rows)
                            / INT8_TOPS > sum(r["bytes"] for r in rows)
                            / HBM_BYTES_S else "bytes"),
                  library_ms=sum(r["library_ms"] for r in rows),
                  per_request="sums over the 7 main-path launches of one "
                              "request (batch 4)",
                  per_shape=rows,
                  main_path={"request_ms": req_ms, "encode_s": encode_s,
                             "peak_memory_bytes": peak})
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
