#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all started together) and drives the port's two
main paths, each through the entry points a user calls:

* CNN inference from compressed weights (spec → ``compile`` →
  ``CompiledModel.run`` on the ``smm_kernel`` backend) at the published
  widths of VGG16, on the ``smm_conv`` kernel;
* transformer serving from packed weights (``init_params`` →
  ``compile_params`` → ``prefill`` → greedy ``decode_step`` loop, as
  ``run_serve`` does) at the published widths of qwen2.5-3b, every
  projection on the ``codr_matmul`` kernel.

Each kernel's launch count is set to 0 just before its path runs and
read just after.  Each kernel is held against its plain PyTorch version
on the card at the shapes its path gives it, and timed.  The script
prints one JSON line per the smoke contract: a ``kernels`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed check
exits non-zero before the result lines; without a CUDA device it exits
2 at once.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

INT8_TOPS = 1979e12      # H100 SXM dense int8 tensor-core peak, op/s
BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak, FLOP/s
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3 bandwidth, bytes/s
# end-to-end smm_kernel vs tiled: both run the same decoded weights, but
# smm_kernel re-quantizes every layer's input activations to int8
# (round-to-nearest, step amax/127), which the float tiled lane does
# not; over 7 layers that error stays within 5% of the output's range
E2E_REL_TOL = 0.05
# codr_matmul vs its plain version: the reference's own tolerances
# (tests/test_kernels.py) — the two sum over K in another order (f32),
# and bf16 output rounds once
MM_F32 = (2e-3, 2e-4)
MM_BF16 = (2e-2, 2e-2)
# codr_matmul lane vs tiled lane logits: the bound of
# tests/test_transformer_executor.py (f32 accumulation vs bf16 products)
LANE_REL_TOL = 0.02
SMM_KERNEL = {"name": "smm_conv", "route": "cuda",
              "source": "src/repro_torch/kernels/smm_conv/csrc/smm_conv.cu",
              "replaces": "src/repro/kernels/smm_conv/kernel.py:88"}
MM_KERNEL = {"name": "codr_matmul", "route": "cuda",
             "source": "src/repro_torch/kernels/codr_matmul/csrc/"
                       "codr_matmul.cu",
             "replaces": "src/repro/kernels/codr_matmul/kernel.py:70"}


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


def cold_ms(fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each
    call (``flush`` writes a buffer larger than L2), as a projection
    finds it in a decode step: 1.5 GB of other weights pass between two
    uses of one."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> tuple:
    """(bound ms, what sets it): the larger of bytes over the memory rate
    and operations over the peak rate for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# path 1: CNN inference on smm_conv (VGG16 conv1_1 .. conv3_3)
# ---------------------------------------------------------------------------

def cnn_path(args) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import repro_torch.api as codr
    from repro_torch.configs.paper_cnns import ALEXNET, GOOGLENET, VGG16
    from repro_torch.core import ucr
    from repro_torch.core.backends import _int_activations
    from repro_torch.core.engine import full_fp32
    from repro_torch.kernels.smm_conv import ops, ref

    shapes = VGG16[:7]              # conv1_1 .. conv3_3, 226x226x3 input
    batch, n_requests = 4, 3
    say("cnn: cuts: depth 13 -> 7 conv layers (conv1_1..conv3_3; the "
        "offline encoder's time grows with the vector count, ~48k vectors "
        "vs ~409k for all 13); no linear head (from_shapes' head at "
        "212*212*256 features would be 115M weights to encode)")
    spec = codr.ModelSpec.from_shapes(shapes, None, density=0.4,
                                      rng=np.random.default_rng(args.seed))
    t0 = time.perf_counter()
    compiled = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                            backend="smm_kernel", device="cuda")
    encode_s = time.perf_counter() - t0
    say(f"cnn encode: {len(spec)} conv layers, {compiled.total_bits()} bits, "
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
        say(f"cnn request {i}: batch {batch}, {ms:.3f} ms"
            f"{' (first: decodes the bitstreams, packs operands)' if i == 0 else ''}")
    steady = req_ms[1:]
    say(f"cnn images/s (requests 1..{n_requests - 1}): "
        f"{batch * len(steady) / (sum(steady) / 1e3):.3f}; peak device "
        f"memory {peak} bytes; smm_conv launches {launches}")
    if launches != len(spec) * n_requests:
        fail(f"main path launched smm_conv {launches} times, expected "
             f"{len(spec) * n_requests}")
    out_shape = (batch, 212, 212, 256)
    for y in outs:
        if tuple(y.shape) != out_shape or not bool(torch.isfinite(y).all()):
            fail(f"output {tuple(y.shape)} not finite {out_shape}")

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
        b_ms, b_by = bound(n_bytes, n_ops, INT8_TOPS)
        row = {"layer": layer.name, "shape": [m, n, rk, ck, ri, ci,
                                              layer.stride],
               "max_abs_err": err,
               "ms": cuda_ms(lambda: ops.smm_conv_cuda(xin, deltas, entries,
                                                       **kw), 5),
               "plain_ms": cuda_ms(lambda: ref.smm_conv_plain(
                   xin, deltas, entries, **kw), 2),
               "library_ms": cuda_ms(library, 5),
               "ops": n_ops, "bytes": n_bytes,
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        say(f"cnn {layer.name} {row['shape']}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, F.conv2d "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), max-abs-diff {err}")
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
        say(f"cnn {net} ({s.rk}x{s.rk}, stride {s.stride}, {s.ri}^2): "
            f"kernel vs plain max-abs-diff {err}")
        if err != 0.0:
            fail(f"{net}: kernel vs plain max-abs-diff {err}")

    y_tiled = compiled.run(images[0], backend="tiled")
    y_qref = compiled.quantized_reference(images[0])
    scale = float(y_tiled.abs().max())
    rel_q = float((y_tiled - y_qref).abs().max()) / scale
    rel = float((outs[0] - y_tiled).abs().max()) / scale
    say(f"cnn end to end: smm_kernel vs tiled rel max-abs err {rel:.6f} "
        f"(tolerance {E2E_REL_TOL}, int8 activation quantization); tiled "
        f"vs quantized_reference {rel_q:.3e} (tolerance 1e-4)")
    if not rel <= E2E_REL_TOL:
        fail(f"smm_kernel vs tiled rel err {rel} > {E2E_REL_TOL}")
    if not rel_q <= 1e-4:
        fail(f"tiled vs quantized_reference rel err {rel_q} > 1e-4")

    b_ms, b_by = bound(sum(r["bytes"] for r in rows),
                       sum(r["ops"] for r in rows), INT8_TOPS)
    return dict(SMM_KERNEL, launches=launches, max_abs_err=max_err,
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=sum(r["library_ms"] for r in rows),
                per_request="sums over the 7 main-path launches of one "
                            "request (batch 4)",
                per_shape=rows,
                main_path={"request_ms": req_ms, "encode_s": encode_s,
                           "peak_memory_bytes": peak})


# ---------------------------------------------------------------------------
# path 2: qwen2.5-3b serving on codr_matmul
# ---------------------------------------------------------------------------

# the seven projections of one layer → the sub-tree holding each
PROJ = {"q_proj": "mixer", "k_proj": "mixer", "v_proj": "mixer",
        "o_proj": "mixer", "up_proj": "mlp", "gate_proj": "mlp",
        "down_proj": "mlp"}


def _rebind(params, backend: str):
    """The same packs, executed by another backend (no re-encode)."""
    from repro_torch.core.codr_linear import PackedEmbedding, PackedLinear
    from repro_torch.core.tree import map_leaves
    return map_leaves(
        lambda leaf: dataclasses.replace(leaf, backend=backend)
        if isinstance(leaf, (PackedLinear, PackedEmbedding)) else leaf,
        params)


def _lane_check(a, b, what: str) -> float:
    """codr_matmul lane ``a`` vs tiled lane ``b``: within ``0.02 ·
    max(|b|max, 1)``, argmax equal where b's top-2 margin exceeds it."""
    import torch
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    if not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
        fail(f"{what}: non-finite logits")
    lim = LANE_REL_TOL * max(float(b.abs().max()), 1.0)
    err = float((a - b).abs().max())
    top2 = torch.topk(b, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > lim
    agree = bool((a.argmax(-1)[clear] == b.argmax(-1)[clear]).all())
    say(f"serve {what}: codr_matmul vs tiled max-abs err {err:.5f} "
        f"(bound {lim:.5f}); argmax agrees on {int(clear.sum())} clear "
        f"rows: {agree}")
    if not err <= lim:
        fail(f"{what}: codr_matmul vs tiled logits err {err} > {lim}")
    if not agree:
        fail(f"{what}: argmax differs where the tiled margin exceeds {lim}")
    return err


def _teacher_forced(api, params, cfg, tokens, dtype, steps: int = 4):
    """Prefill + ``steps`` decode steps fed the prompt's own tokens, with
    activations in ``dtype`` (the model's ``DEFAULT_DTYPE`` swapped for
    the call, as the reference's tests do for a float32 comparison)."""
    import torch

    from repro_torch.models import lm
    saved, lm.DEFAULT_DTYPE = lm.DEFAULT_DTYPE, dtype
    try:
        out = [api.prefill(params, {"tokens": tokens}, cfg)[0]]
        cache = api.init_cache(cfg, tokens.shape[0], steps, dtype=dtype,
                               device=tokens.device)
        for i in range(steps):
            lg, cache = api.decode_step(params, cache, tokens[:, i], i, cfg)
            out.append(lg)
        torch.cuda.synchronize()
    finally:
        lm.DEFAULT_DTYPE = saved
    return out


def _profile_step(api, params, cfg, tokens) -> dict:
    """One decode step (after two warm ones) under ``torch.profiler``:
    wall time, device-busy time, the codr_matmul kernel's share and the
    host's op time.  The profiler adds host time of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cache = api.init_cache(cfg, tokens.shape[0], 8, device=tokens.device)
    for i in range(2):
        _, cache = api.decode_step(params, cache, tokens[:, i], i, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.decode_step(params, cache, tokens[:, 2], 2, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    # device kernels only: an op's row repeats its kernels' time
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(dev_us(e) for e in kernels) / 1e3
    mm = [e for e in kernels if "codr_matmul_kernel" in e.key]
    out = {"wall_ms": wall, "device_busy_ms": device,
           "codr_matmul_ms": sum(dev_us(e) for e in mm) / 1e3,
           "codr_matmul_launches": sum(e.count for e in mm),
           "device_kernels": sum(e.count for e in kernels),
           "host_op_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
           "top": sorted(([e.key[:60], dev_us(e) / 1e3, e.count]
                          for e in kernels), key=lambda r: -r[1])[:6]}
    idle = ("not measured (no device events)" if device == 0 else
            f"{max(0.0, 1 - device / wall):.3f}")
    say(f"serve profile, one decode step: wall {wall:.3f} ms, device busy "
        f"{device:.3f} ms (idle share {idle}), codr_matmul "
        f"{out['codr_matmul_ms']:.3f} ms over {out['codr_matmul_launches']} "
        f"launches, {out['device_kernels']} kernels in all, host op time "
        f"{out['host_op_ms']:.3f} ms; top kernels [name, ms, count]: "
        f"{out['top']}")
    return out


def serve_path(args) -> dict:
    import torch

    import repro_torch.api as codr
    from repro_torch.configs import get_config
    from repro_torch.core.engine import full_fp32
    from repro_torch.kernels.codr_matmul import ops, ref
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import get_model

    cfg = get_config("qwen2.5-3b")            # published widths, 36 layers
    batch, prompt_len, gen_len = 4, 32, 32    # run_serve's defaults
    api = get_model(cfg)
    say(f"serve: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; batch {batch}, prompt {prompt_len}, gen "
        f"{gen_len}; random weights (seed {args.seed}); no cuts")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = codr.compile_params(params, codr.EncodeConfig(n_unique=16),
                                   backend="codr_matmul", accounting=False,
                                   device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del params                        # the f32 master leaves, as run_serve
    params = compiled.params
    torch.cuda.empty_cache()
    say(f"serve encode: init {init_s:.2f} s, compile_params {encode_s:.2f} "
        f"s; {len(compiled.packed_paths)} packed projections + "
        f"{len(compiled.embed_paths)} embedding; packed {compiled.hbm_bytes()} "
        f"bytes vs dense bf16 {compiled.dense_bf16_bytes()} bytes, "
        f"{compiled.bits_per_weight():.4f} bits/weight")

    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    t0 = time.perf_counter()
    logits, _ = api.prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = ops.launches
    t0 = time.perf_counter()
    out, _, n_steps = greedy_decode(api, params, tokens, cfg, gen_len)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = ops.launches
    peak = torch.cuda.max_memory_allocated()
    per_forward = 7 * cfg.n_layers
    ms_step = decode_s / n_steps * 1e3
    tok_s = batch * gen_len / decode_s
    say(f"serve main path: prefill {prefill_ms:.3f} ms; {n_steps} decode "
        f"steps {decode_s * 1e3:.3f} ms ({ms_step:.3f} ms/step); generated "
        f"tokens/s {tok_s:.3f} (batch {batch} x {gen_len} over the decode "
        f"loop, prompt replay included); peak device memory {peak} bytes; "
        f"codr_matmul launches {prefill_launches} in prefill, {launches} in "
        f"all")
    if prefill_launches != per_forward or n_steps != prompt_len + gen_len - 1 \
            or launches != per_forward * (n_steps + 1):
        fail(f"codr_matmul launched {prefill_launches} / {launches} times "
             f"over prefill + {n_steps} steps, expected {per_forward} per "
             f"forward")
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"prefill logits {tuple(logits.shape)} not finite")
    if tuple(out.shape) != (batch, gen_len) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"generated tokens {tuple(out.shape)} out of range")
    say(f"serve sample generation (first row): {out[0, :16].tolist()}")

    # -- the kernel at every projection shape, against its plain version
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    layer0 = {name: params["stack"]["b0"][part][name][0]
              for name, part in PROJ.items()}
    shapes: dict[tuple, list[str]] = {}
    for name, pl in layer0.items():
        shapes.setdefault((pl.weight.shape[0], pl.out_features), []).append(
            name)
    rows, max_err, ms_by = [], 0.0, {}
    xgen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    for (k, n), names in shapes.items():
        w = layer0[names[0]].weight
        wd = layer0[names[0]].dense().to(torch.bfloat16)
        args_w = (w.packed, w.table, w.scale.reshape(-1))
        for m in (4, batch * prompt_len):
            x = torch.randn(m, k, generator=xgen, device="cuda")
            xb = x.to(torch.bfloat16)
            yk = ops.codr_matmul_cuda(x, *args_w, bits=w.bits, n=n)
            with full_fp32():
                yp = ref.codr_matmul_ref(x, *args_w, bits=w.bits, n=n)
            err = float((yk - yp).abs().max())
            rtol, atol = MM_F32
            if not bool(((yk - yp).abs() <= atol + rtol * yp.abs()).all()):
                fail(f"codr_matmul {k}x{n} M={m}: kernel vs plain max-abs "
                     f"{err} beyond rtol {rtol} / atol {atol}")
            max_err = max(max_err, err)
            n_bytes = x.numel() * 4 + w.packed.numel() * 4 \
                + w.table.numel() * 4 + 4 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2 * m * k * n, BF16_FLOPS)
            with full_fp32():
                row = {"proj": "/".join(names), "m": m, "k": k, "n": n,
                       "bits": w.bits, "max_abs_err": err,
                       "ms": cold_ms(lambda: ops.codr_matmul_cuda(
                           x, *args_w, bits=w.bits, n=n), 20, flush),
                       "plain_ms": cold_ms(lambda: ref.codr_matmul_ref(
                           x, *args_w, bits=w.bits, n=n), 5, flush),
                       "library_ms": cold_ms(lambda: torch.matmul(xb, wd),
                                             20, flush),
                       "bytes": n_bytes, "ops": 2 * m * k * n,
                       "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            ms_by[(k, n, m)] = row
            say(f"serve codr_matmul {row['proj']} {k}x{n} M={m} "
                f"({w.bits}-bit): kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, torch.matmul bf16 "
                f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"max-abs-diff {err:.3e}")
    # one bfloat16 case (activations and table), held at 2e-2
    w = layer0["q_proj"].weight
    xb = torch.randn(4, w.shape[0], generator=xgen, device="cuda").to(
        torch.bfloat16)
    tb = w.table.to(torch.bfloat16)
    yk = ops.codr_matmul_cuda(xb, w.packed, tb, w.scale.reshape(-1),
                              bits=w.bits, n=w.shape[1]).float()
    yp = ref.codr_matmul_ref(xb, w.packed, tb, w.scale.reshape(-1),
                             bits=w.bits, n=w.shape[1]).float()
    rtol, atol = MM_BF16
    err_bf16 = float((yk - yp).abs().max())
    say(f"serve codr_matmul bf16 {w.shape[0]}x{w.shape[1]} M=4: kernel vs "
        f"plain max-abs-diff {err_bf16:.3e} (rtol {rtol} / atol {atol})")
    if not bool(((yk - yp).abs() <= atol + rtol * yp.abs()).all()):
        fail(f"codr_matmul bf16: kernel vs plain max-abs {err_bf16}")

    # -- the same packs on the tiled lane, teacher-forced: the lanes are
    # compared in float32 activations, where they differ only by the
    # kernel's summation order; in bfloat16 both lanes' rounding is
    # amplified by 36 random layers past the bound (printed, see PERF.md)
    tiled = _rebind(params, "tiled")
    with full_fp32():
        f32 = {lane: _teacher_forced(api, p, cfg, tokens, torch.float32)
               for lane, p in (("codr_matmul", params), ("tiled", tiled))}
    bf16 = {lane: _teacher_forced(api, p, cfg, tokens, torch.bfloat16)
            for lane, p in (("codr_matmul", params), ("tiled", tiled))}
    lane_err, bf16_err = 0.0, []
    for i, (a, b) in enumerate(zip(f32["codr_matmul"], f32["tiled"])):
        what = "prefill" if i == 0 else f"decode step {i - 1}"
        lane_err = max(lane_err, _lane_check(a, b, what + " (float32)"))
        ab, bb = bf16["codr_matmul"][i].float(), bf16["tiled"][i].float()
        row = {"step": what, "bound": LANE_REL_TOL * max(
                   float(bb.abs().max()), 1.0),
               "codr_vs_tiled": float((ab - bb).abs().max()),
               "codr_vs_f32": float((ab - b.float()).abs().max()),
               "tiled_vs_f32": float((bb - b.float()).abs().max())}
        bf16_err.append(row)
        say(f"serve {what} (bfloat16, not a check): codr_matmul vs tiled "
            f"{row['codr_vs_tiled']:.5f}, codr_matmul vs float32 lane "
            f"{row['codr_vs_f32']:.5f}, tiled vs float32 lane "
            f"{row['tiled_vs_f32']:.5f} (bound {row['bound']:.5f})")
    if not torch.equal(bf16["codr_matmul"][0], logits):
        fail("the codr_matmul lane's prefill differs from the main path's")

    # -- where one decode step's time goes (torch.profiler)
    prof = _profile_step(api, params, cfg, tokens)

    # per decode step: every projection of every layer at M = 4
    fwd = {key: sum(ms_by[(k, n, 4)][key] * len(names) * cfg.n_layers
                    for (k, n), names in shapes.items())
           for key in ("ms", "plain_ms", "library_ms", "bytes", "ops")}
    b_ms, b_by = bound(fwd["bytes"], fwd["ops"], BF16_FLOPS)
    return dict(MM_KERNEL, launches=launches, max_abs_err=max_err,
                ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=b_ms,
                bound_by=b_by, library_ms=fwd["library_ms"],
                per_forward=f"sums over the {per_forward} launches of one "
                            f"decode step (M = {batch}), L2 flushed before "
                            f"each launch",
                per_shape=rows,
                main_path={"prefill_ms": prefill_ms, "decode_s": decode_s,
                           "ms_per_step": ms_step, "generated_tok_s": tok_s,
                           "encode_s": encode_s, "init_s": init_s,
                           "packed_bytes": compiled.hbm_bytes(),
                           "dense_bf16_bytes": compiled.dense_bf16_bytes(),
                           "bits_per_weight": compiled.bits_per_weight(),
                           "peak_memory_bytes": peak,
                           "max_abs_err_bf16": err_bf16,
                           "lane_vs_tiled_max_abs_err_f32": lane_err,
                           "bf16_lanes": bf16_err, "profile": prof})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, images and prompts")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.codr_matmul import ops as mm_ops
    from repro_torch.kernels.smm_conv import ops as smm_ops

    # -- device ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- build: one nvcc per source, started together ----------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(smm_ops.load_kernel),
                    pool.submit(mm_ops.load_kernel)]:
            fut.result()
    say(f"build: smm_conv.cu + codr_matmul.cu -> {_build.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
    for log in sorted(_build.BUILD_DIR.glob("lib*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {log.name.split('-')[0]}: {line.strip()}")

    t0 = time.perf_counter()
    kernels = [cnn_path(args)]
    say(f"cnn path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels.append(serve_path(args))
    say(f"serve path: {time.perf_counter() - t0:.1f} s")

    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
