#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from the sources in this checkout
(``smm_conv.cu``; ``codr_matmul.cu``, ``codr_matmul_splitk.cu`` and
``codr_matmul_sm90.cu``, the three instances of the compressed matmul;
``flash_attention.cu`` and ``flash_attention_sm90.cu``, the two of flash
attention: one ``nvcc`` per source, all six started together) and drives
the port's three paths, each through the entry points a user calls:

* CNN inference from compressed weights (spec → ``compile`` →
  ``CompiledModel.run`` on the ``smm_kernel`` backend) at the published
  widths of VGG16, on the ``smm_conv`` kernel;
* transformer serving from packed weights (``init_params`` →
  ``compile_params`` → ``prefill`` → greedy ``decode_step`` loop, as
  ``run_serve`` does) at the published widths of qwen2.5-3b, every
  projection on the ``codr_matmul`` kernel: the prefill (M = 128) on
  its tensor-core instance (``sm90``), the decode steps (M = 4) on its
  split-K instance (``splitk``), as the routing rule names them.  Every
  instance is held to the plain version and timed at each projection
  shape, at M = 4 and 128 and over M = 4 .. 128 for the routing
  threshold, and at bits = 16 over M = 17 .. 128 for its own; each
  one's distance from the float64 product is printed;
* attention through its own entry point, ``flash_attention_kernel``, on
  the ``flash_attention`` kernel (no model calls it, in the port as in
  the reference): the reference's test shapes, ragged and odd ones, and
  qwen2.5-3b's attention (16 / 2 heads, head dim 128, causal) in f32 at
  1024 tokens and in bf16 at the serve path's layer-0 prefill q / k / v
  and at prompts of 4096 (batch 1) and 2048 (batch 4) tokens.  bf16
  with D = Dv in {64, 128} runs the tensor-core instance (``sm90``),
  everything else the CUDA-core one (``simt``); the per-instance launch
  counts are held to what the routing rule predicts.  In bf16 the kernel
  is held to one bf16 ulp of the plain version, and two controls that
  round P to bf16 (SDPA, and the plain version so changed) must fail
  that bound.  At the long prompts both instances are timed.

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
import re
import subprocess
import sys
import time

INT8_TOPS = 1979e12      # H100 SXM dense int8 tensor-core peak, op/s
BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak, FLOP/s
F32_FLOPS = 67e12        # H100 SXM float32 peak (CUDA cores), FLOP/s
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
# flash_attention vs its plain version: in f32 the reference's own
# tolerance (tests/test_kernels.py), since the online softmax sums in
# another order; in bf16 one bf16 ulp of the plain output (2^-7 of its
# magnitude), since both compute in f32 and round the output once — a
# kernel that rounds P to bf16 before P·V (SDPA does) falls outside it,
# which attention_path checks on two such controls
FA_F32 = (1e-4, 1e-5)
FA_BF16 = (2 ** -7, 1e-6)
SMM_KERNEL = {"name": "smm_conv", "route": "cuda",
              "source": "src/repro_torch/kernels/smm_conv/csrc/smm_conv.cu",
              "replaces": "src/repro/kernels/smm_conv/kernel.py:88"}
MM_KERNEL = {"name": "codr_matmul", "route": "cuda",
             "source": "src/repro_torch/kernels/codr_matmul/csrc/"
                       "codr_matmul_splitk.cu",
             "sources": {i: f"src/repro_torch/kernels/codr_matmul/csrc/{f}"
                         for i, f in (("simt", "codr_matmul.cu"),
                                      ("splitk", "codr_matmul_splitk.cu"),
                                      ("sm90", "codr_matmul_sm90.cu"))},
             "replaces": "src/repro/kernels/codr_matmul/kernel.py:70"}
# the device kernels of the three codr_matmul instances, by name
MM_KERNEL_NAMES = re.compile(r"codr_matmul(_splitk|_sm90)?_kernel")
# the rows of x the routing threshold is measured at
MM_SWEEP_M = (4, 8, 16, 32, 64, 128)
# the rows of x at which bits = 16 (which sm90 does not take) is timed
# above the threshold, on splitk and on the first kernel
MM_BITS16_M = (17, 32, 64, 96, 128)
FA_KERNEL = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_sm90.cu",
             "simt_source": "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:67"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def clocks() -> str:
    """The card's SM clock, its maximum, temperature and power draw now
    (latency-bound kernels move with the clock)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()


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
    uses of one.  A device-side sleep after the flush (~1 ms) keeps the
    stream busy while the host issues ``fn``, so no launch time on the
    host is counted as device time."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)
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
    mm = [e for e in kernels if MM_KERNEL_NAMES.search(e.key)]
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


def _layer0_qkv(params, cfg, tokens, cache) -> tuple:
    """q, k, v of layer 0's attention in the prefill of ``tokens``,
    computed as ``models.lm.forward`` computes them; k and v are held to
    the prefill's own cache."""
    import torch

    from repro_torch.models import attention as tattn
    from repro_torch.models import lm
    from repro_torch.models.common import embedding_lookup, norm_apply
    lp = lm._layer(params["stack"], 0)["b0"]
    x = embedding_lookup(params["embed"], tokens, lm.DEFAULT_DTYPE)
    h = norm_apply(x, lp["norm1"], cfg.norm_type, f32=cfg.norm_f32)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    q, k, v = tattn._qkv(lp["mixer"], h, cfg, positions)
    k0, v0 = cache["stack"]["b0"]
    if not (torch.equal(k, k0[0]) and torch.equal(v, v0[0])):
        fail("layer 0's k / v differ from the prefill's cache")
    return q, k, v


def serve_path(args) -> tuple:
    """The serving path; returns the ``codr_matmul`` row and the q, k, v
    of layer 0's attention in the main path's prefill."""
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
    bits = params["stack"]["b0"]["mixer"]["q_proj"][0].weight.bits
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
    t0 = time.perf_counter()
    logits, prefill_cache = api.prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = ops.launches
    prefill_by_impl = dict(ops.launches_by_impl)
    t0 = time.perf_counter()
    out, _, n_steps = greedy_decode(api, params, tokens, cfg, gen_len)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = ops.launches
    by_impl = dict(ops.launches_by_impl)
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
    # the routing rule's prediction: prefill at M = batch * prompt, every
    # decode step at M = batch
    want_prefill = dict.fromkeys(ops.IMPLS, 0)
    want_prefill[ops.pick_impl(batch * prompt_len, bits)] += per_forward
    want = dict(want_prefill)
    want[ops.pick_impl(batch, bits)] += per_forward * n_steps
    say(f"serve codr_matmul launches by instance: prefill {prefill_by_impl}, "
        f"in all {by_impl} (routing predicts {want_prefill} / {want})")
    if prefill_by_impl != want_prefill or by_impl != want:
        fail(f"codr_matmul launches by instance {prefill_by_impl} / "
             f"{by_impl}, the routing rule predicts {want_prefill} / {want}")
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"prefill logits {tuple(logits.shape)} not finite")
    if tuple(out.shape) != (batch, gen_len) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"generated tokens {tuple(out.shape)} out of range")
    say(f"serve sample generation (first row): {out[0, :16].tolist()}")
    qkv = _layer0_qkv(params, cfg, tokens, prefill_cache)
    del prefill_cache

    # -- the kernel at every projection shape, against its plain version
    say(f"serve clocks before the per-shape rows (sm, max sm, temperature, "
        f"power): {clocks()}")
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    # the floor under every row: one launch of a kernel that writes one
    # float, timed the same way
    one = torch.zeros(1, device="cuda")
    launch_floor = cold_ms(one.zero_, 20, flush)
    say(f"serve launch floor (one-element fill, L2 flushed): "
        f"{launch_floor:.4f} ms")

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
            with full_fp32():
                yp = ref.codr_matmul_ref(x, *args_w, bits=w.bits, n=n)
            # the exact (float64) product, and the size of one f32
            # rounding of each output's terms (2^-24 sum |x w| |scale|):
            # every instance's and the plain version's distance from the
            # exact product, in those units
            wx = ref.decode_ref(w.packed, w.table, bits=w.bits, n=n).double()
            s64 = w.scale.reshape(-1).double()
            exact = (x.double() @ wx) * s64
            unit = (2.0 ** -24 * (x.double().abs() @ wx.abs()) * s64.abs()
                    ).clamp_min(1e-300)
            del wx

            def units(y, exact=exact, unit=unit):
                return float(((y.double() - exact).abs() / unit).max())
            routed = ops.pick_impl(m, w.bits)
            inst = {}
            for impl in ops.IMPLS:
                def call(impl=impl, x=x, args_w=args_w, n=n, bits=w.bits):
                    return ops.codr_matmul_cuda(x, *args_w, bits=bits, n=n,
                                                impl=impl)
                yk = call()
                err = float((yk - yp).abs().max())
                rtol, atol = MM_F32
                if not bool(((yk - yp).abs() <= atol + rtol * yp.abs()).all()):
                    fail(f"codr_matmul [{impl}] {k}x{n} M={m}: kernel vs "
                         f"plain max-abs {err} beyond rtol {rtol} / atol "
                         f"{atol}")
                if impl != "simt" and not torch.equal(yk, call()):
                    fail(f"codr_matmul [{impl}] {k}x{n} M={m}: two calls "
                         f"differ (the split-K sum must be in a fixed order)")
                max_err = max(max_err, err)
                inst[impl] = {"ms": cold_ms(call, 20, flush),
                              "max_abs_err": err, "f64_units": units(yk)}
            n_bytes = x.numel() * 4 + w.packed.numel() * 4 \
                + w.table.numel() * 4 + 4 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2 * m * k * n, BF16_FLOPS)
            with full_fp32():
                row = {"proj": "/".join(names), "m": m, "k": k, "n": n,
                       "bits": w.bits, "impl": routed,
                       "max_abs_err": inst[routed]["max_abs_err"],
                       "ms": inst[routed]["ms"],
                       "simt_ms": inst["simt"]["ms"], "instances": inst,
                       "plain_ms": cold_ms(lambda: ref.codr_matmul_ref(
                           x, *args_w, bits=w.bits, n=n), 5, flush),
                       "library_ms": cold_ms(lambda: torch.matmul(xb, wd),
                                             20, flush),
                       "plain_f64_units": units(yp),
                       "bytes": n_bytes, "ops": 2 * m * k * n,
                       "bound_ms": b_ms, "bound_by": b_by}
            del exact, unit
            rows.append(row)
            ms_by[(k, n, m)] = row
            say(f"serve codr_matmul {row['proj']} {k}x{n} M={m} "
                f"({w.bits}-bit): routed [{routed}] {row['ms']:.4f} ms; "
                + ", ".join(f"{i} {v['ms']:.4f}" for i, v in inst.items())
                + f" ms; plain {row['plain_ms']:.4f} ms, torch.matmul bf16 "
                f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"max-abs-diff {row['max_abs_err']:.3e}; from the float64 "
                f"product, in f32 roundings of the terms: "
                + ", ".join(f"{i} {v['f64_units']:.3f}"
                            for i, v in inst.items())
                + f", plain {row['plain_f64_units']:.3f}")

    say(f"serve clocks after the per-shape rows: {clocks()}")

    # -- the routing threshold: splitk and sm90 over M, per decode-step mix
    # of projections (q/o, k/v, up/gate twice each, down once)
    sweep = []
    for m in MM_SWEEP_M:
        step = {"m": m, "splitk": 0.0, "sm90": 0.0}
        for (k, n), names in shapes.items():
            w = layer0[names[0]].weight
            args_w = (w.packed, w.table, w.scale.reshape(-1))
            x = torch.randn(m, k, generator=xgen, device="cuda")
            for impl in ("splitk", "sm90"):
                t = cold_ms(lambda: ops.codr_matmul_cuda(
                    x, *args_w, bits=w.bits, n=n, impl=impl), 10, flush)
                step[f"{impl} {k}x{n}"] = t
                step[impl] += t * len(names)
        step["faster"] = min(("splitk", "sm90"), key=lambda i: step[i])
        step["routed"] = ops.pick_impl(m, bits)
        sweep.append(step)
        say(f"serve codr_matmul threshold M={m}: one layer's 7 projections "
            f"splitk {step['splitk']:.4f} ms, sm90 {step['sm90']:.4f} ms "
            f"(faster: {step['faster']}, routed: {step['routed']})")

    # -- bits = 16 above the threshold: the routed instance (splitk) and
    # the first kernel on random 16-bit packs of the projection shapes,
    # their table at the model init's weight scale (1 / sqrt(K)), both
    # held to the plain version, timed per layer's 7 projections
    bits16 = []
    for m in MM_BITS16_M:
        step = {"m": m, "routed": ops.pick_impl(m, 16), "splitk": 0.0,
                "simt": 0.0}
        for (k, n), names in shapes.items():
            packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k, n // 2),
                                   generator=xgen, device="cuda",
                                   dtype=torch.int32)
            table = torch.randn(1 << 16, generator=xgen,
                                device="cuda") / k ** 0.5
            one_s = torch.ones(1, device="cuda")
            x = torch.randn(m, k, generator=xgen, device="cuda")
            with full_fp32():
                yp = ref.codr_matmul_ref(x, packed, table, one_s, bits=16,
                                         n=n)
            for impl in ("splitk", "simt"):
                def call(impl=impl, x=x, packed=packed, table=table, n=n):
                    return ops.codr_matmul_cuda(x, packed, table, one_s,
                                                bits=16, n=n, impl=impl)
                yk = call()
                rtol, atol = MM_F32
                if not bool(((yk - yp).abs() <= atol + rtol * yp.abs()
                             ).all()):
                    fail(f"codr_matmul [{impl}] bits=16 {k}x{n} M={m}: "
                         f"kernel vs plain max-abs "
                         f"{float((yk - yp).abs().max())}")
                t = cold_ms(call, 10, flush)
                step[f"{impl} {k}x{n}"] = t
                step[impl] += t * len(names)
            del packed, table
        step["faster"] = min(("splitk", "simt"), key=lambda i: step[i])
        bits16.append(step)
        say(f"serve codr_matmul bits=16 M={m}: one layer's 7 projections "
            f"splitk {step['splitk']:.4f} ms, simt {step['simt']:.4f} ms "
            f"(faster: {step['faster']}, routed: {step['routed']}); per "
            f"shape "
            + ", ".join(f"{key} {v:.4f}" for key, v in step.items()
                        if " " in key))

    # one bfloat16 case (activations and table), held at 2e-2
    w = layer0["q_proj"].weight
    tb = w.table.to(torch.bfloat16)
    rtol, atol = MM_BF16
    err_bf16 = 0.0
    for m in (4, batch * prompt_len):
        xm = torch.randn(m, w.shape[0], generator=xgen, device="cuda").to(
            torch.bfloat16)
        yk = ops.codr_matmul_cuda(xm, w.packed, tb, w.scale.reshape(-1),
                                  bits=w.bits, n=w.shape[1]).float()
        yp = ref.codr_matmul_ref(xm, w.packed, tb, w.scale.reshape(-1),
                                 bits=w.bits, n=w.shape[1]).float()
        err = float((yk - yp).abs().max())
        err_bf16 = max(err_bf16, err)
        say(f"serve codr_matmul bf16 {w.shape[0]}x{w.shape[1]} M={m} "
            f"[{ops.pick_impl(m, w.bits)}]: kernel vs plain max-abs-diff "
            f"{err:.3e} (rtol {rtol} / atol {atol})")
        if not bool(((yk - yp).abs() <= atol + rtol * yp.abs()).all()):
            fail(f"codr_matmul bf16 M={m}: kernel vs plain max-abs {err}")

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
    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bytes", "ops")
    fwd, pre = ({key: sum(ms_by[(k, n, m)][key] * len(names) * cfg.n_layers
                          for (k, n), names in shapes.items())
                 for key in keys} for m in (batch, batch * prompt_len))
    b_ms, b_by = bound(fwd["bytes"], fwd["ops"], BF16_FLOPS)
    say(f"serve codr_matmul one decode step (M={batch}, {per_forward} "
        f"launches, sums of the per-shape rows): routed "
        f"[{ops.pick_impl(batch, bits)}] {fwd['ms']:.4f} ms, simt "
        f"{fwd['simt_ms']:.4f} ms ({fwd['simt_ms'] / fwd['ms']:.1f}x), "
        f"plain {fwd['plain_ms']:.4f} ms, torch.matmul bf16 "
        f"{fwd['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); prefill "
        f"(M={batch * prompt_len}): routed "
        f"[{ops.pick_impl(batch * prompt_len, bits)}] {pre['ms']:.4f} ms, "
        f"simt {pre['simt_ms']:.4f} ms, plain {pre['plain_ms']:.4f} ms, "
        f"torch.matmul bf16 {pre['library_ms']:.4f} ms")
    return dict(MM_KERNEL, launches=launches, launches_by_impl=by_impl,
                max_abs_err=max_err,
                ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=b_ms,
                bound_by=b_by, library_ms=fwd["library_ms"],
                simt_ms=fwd["simt_ms"],
                per_forward=f"sums over the {per_forward} launches of one "
                            f"decode step (M = {batch}), L2 flushed before "
                            f"each launch: ms on the routed instance "
                            f"({ops.pick_impl(batch, bits)}), simt_ms on "
                            f"the first kernel; max_abs_err over every "
                            f"instance and shape",
                prefill={key: pre[key] for key in keys},
                launch_floor_ms=launch_floor,
                threshold_sweep=sweep, bits16_sweep=bits16,
                per_shape=rows,
                main_path={"prefill_ms": prefill_ms, "decode_s": decode_s,
                           "ms_per_step": ms_step, "generated_tok_s": tok_s,
                           "encode_s": encode_s, "init_s": init_s,
                           "packed_bytes": compiled.hbm_bytes(),
                           "dense_bf16_bytes": compiled.dense_bf16_bytes(),
                           "bits_per_weight": compiled.bits_per_weight(),
                           "peak_memory_bytes": peak,
                           "prefill_launches_by_impl": prefill_by_impl,
                           "max_abs_err_bf16": err_bf16,
                           "lane_vs_tiled_max_abs_err_f32": lane_err,
                           "bf16_lanes": bf16_err, "profile": prof}), qkv


# ---------------------------------------------------------------------------
# path 3: attention through flash_attention_kernel
# ---------------------------------------------------------------------------

def _visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(q, k) pairs the function scores: all, or those under the top-left
    causal mask (row i sees min(i + 1, Sk) keys)."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


def _fa_close(y, yp) -> tuple:
    """(within tolerance, max-abs-diff, share of elements beyond it) of
    an attention output against the plain version's."""
    import torch
    rtol, atol = FA_F32 if yp.dtype == torch.float32 else FA_BF16
    diff = (y.float() - yp.float()).abs()
    over = diff > atol + rtol * yp.float().abs()
    return not bool(over.any()), float(diff.max()), float(over.float().mean())


def _plain_with_bf16_probabilities(q, k, v, *, causal):
    """The plain version with P rounded to bf16 before P·V: what a kernel
    that feeds P to bf16 tensor cores computes (a control for FA_BF16)."""
    import torch
    b, s, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / d ** 0.5
    if causal:
        mask = torch.tril(torch.ones(s, sk, dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, hq, dv).to(q.dtype)


def attention_path(args, prefill_qkv) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.engine import full_fp32
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import attention as tattn

    cfg = get_config("qwen2.5-3b")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)

    def rand(b, sq, sk, nq, nkv, d, dv, dtype):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((b, sq, nq, d), (b, sk, nkv, d),
                                   (b, sk, nkv, dv)))

    # (label, (q, k, v), causal): the reference's test shapes both ways;
    # ragged and odd ones; qwen2.5-3b's attention at the serve path's
    # layer-0 prefill and at long prompts
    cases = []
    for b, s, nq, nkv, d in ((2, 128, 4, 2, 32), (1, 256, 8, 8, 16),
                             (2, 96, 4, 1, 64)):
        for causal in (True, False):
            cases.append((f"reference {(b, s, nq, nkv, d)} "
                          f"{'causal' if causal else 'full'}",
                          rand(b, s, s, nq, nkv, d, d, f32), causal))
    cases += [(f"S={s}", rand(1, s, s, 4, 2, 64, 64, f32), True)
              for s in (1, 63, 65, 97, 1000)]
    cases += [("Sq=64 Sk=128", rand(2, 64, 128, 4, 2, 64, 64, f32), True),
              ("Sq=128 Sk=64", rand(2, 128, 64, 4, 2, 64, 64, f32), True),
              ("D=32 Dv=16", rand(2, 96, 96, 4, 2, 32, 16, f32), True),
              ("D=256", rand(1, 130, 130, 4, 2, 256, 256, f32), True),
              ("qwen2.5-3b f32 B=1 S=1024",
               rand(1, 1024, 1024, hq, hkv, hd, hd, f32), True),
              ("qwen2.5-3b layer 0 prefill B=4 S=32", prefill_qkv, True)]
    cases += [(f"qwen2.5-3b B={b} S={s}", rand(b, s, s, hq, hkv, hd, hd,
                                                 bf16), True)
              for b, s in ((1, 4096), (4, 2048))]
    # bf16 with D = Dv in {64, 128} (the sm90 instance): ragged S against
    # its 128-row q and 64-row kv tiles, both masks, Sq != Sk both ways,
    # GQA groups 1 and 2; bf16 at other head dims (the simt instance)
    cases += [(f"bf16 S={s} D={d} {'causal' if causal else 'full'}",
               rand(1, s, s, 4, 2, d, d, bf16), causal)
              for s, d, causal in ((1, 128, True), (63, 64, True),
                                   (65, 128, False), (1000, 64, True),
                                   (1000, 128, False))]
    cases += [("bf16 Sq=64 Sk=300 D=128", rand(2, 64, 300, 4, 2, 128, 128,
                                               bf16), True),
              ("bf16 Sq=300 Sk=64 D=64 full", rand(2, 300, 64, 4, 2, 64, 64,
                                                   bf16), False),
              ("bf16 GQA group 1 D=128", rand(1, 300, 300, 4, 4, 128, 128,
                                              bf16), True),
              ("qwen2.5-3b bf16 B=1 S=4096 full",
               rand(1, 4096, 4096, hq, hkv, hd, hd, bf16), False),
              ("bf16 D=256", rand(1, 130, 130, 4, 2, 256, 256, bf16), True),
              ("bf16 D=128 Dv=64", rand(2, 96, 96, 4, 2, 128, 64, bf16),
               True)]
    predicted = dict.fromkeys(ops.IMPLS, 0)
    for _, (q, _, v), _ in cases:
        predicted[ops.pick_impl(q.dtype, q.shape[-1], v.shape[-1])] += 1
    say(f"attention: {len(cases)} calls of flash_attention_kernel; "
        f"qwen2.5-3b widths {hq} / {hkv} heads, head dim {hd}, bf16, causal; "
        f"routing predicts {predicted}")

    ops.launches = 0
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
    rows, outs = [], {}
    for label, (q, k, v), causal in cases:
        y = ops.flash_attention_kernel(q, k, v, causal=causal)
        torch.cuda.synchronize()
        with full_fp32():
            yp = ref.flash_attention_ref(q, k, v, causal=causal)
        rtol, atol = FA_F32 if q.dtype == f32 else FA_BF16
        ok, err, _ = _fa_close(y, yp)
        impl = ops.pick_impl(q.dtype, q.shape[-1], v.shape[-1])
        say(f"attention {label} q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} {str(q.dtype)[6:]} "
            f"{'causal' if causal else 'full'} [{impl}]: kernel vs plain "
            f"max-abs-diff {err:.3e} (rtol {rtol} / atol {atol})")
        if y.shape != yp.shape or y.dtype != q.dtype \
                or not bool(torch.isfinite(y.float()).all()):
            fail(f"attention {label}: output {tuple(y.shape)} {y.dtype} "
                 f"not finite or not {tuple(yp.shape)} {q.dtype}")
        if not ok:
            fail(f"attention {label}: kernel vs plain max-abs {err} beyond "
                 f"rtol {rtol} / atol {atol}")
        rows.append({"case": label, "q": list(q.shape), "k": list(k.shape),
                     "v": list(v.shape), "dtype": str(q.dtype)[6:],
                     "causal": causal, "impl": impl, "max_abs_err": err})
        outs[label] = y
    launches, by_impl = ops.launches, dict(ops.launches_by_impl)
    say(f"attention launches {launches} in {len(cases)} calls, by instance "
        f"{by_impl}")
    if launches != len(cases) or by_impl != predicted:
        fail(f"flash_attention launched {launches} times ({by_impl}) in "
             f"{len(cases)} calls; the routing rule predicts {predicted}")

    # layer 0 of the prefill against the model's own chunked attention
    label = "qwen2.5-3b layer 0 prefill B=4 S=32"
    q, k, v = prefill_qkv
    with full_fp32():
        yc = tattn.flash_attention(q, k, v, causal=True,
                                   q_chunk=cfg.attn_q_chunk,
                                   kv_chunk=cfg.attn_kv_chunk,
                                   acc_dtype=f32 if cfg.attn_f32 else bf16)
    rtol, atol = FA_BF16
    ok, err_chunked, _ = _fa_close(outs[label], yc)
    say(f"attention {label}: kernel vs the model's chunked attention "
        f"max-abs-diff {err_chunked:.3e} (rtol {rtol} / atol {atol})")
    if not ok:
        fail(f"attention {label}: kernel vs chunked attention max-abs "
             f"{err_chunked}")

    # times at the long prompts and one of the reference's shapes: kernel,
    # plain version (TF32 off), SDPA in bf16 (library column only; both
    # top-left causal since Sq = Sk)
    head_label = "qwen2.5-3b B=1 S=4096"
    timed = [c for c in cases if c[0].startswith("qwen2.5-3b B=")
             or c[0] == "reference (2, 128, 4, 2, 32) causal"]
    per_shape = []
    for label, (q, k, v), causal in timed:
        b, sq, nq, d = q.shape
        _, sk, nkv, dv = v.shape
        qt, kt, vt = (t.to(bf16).transpose(1, 2).contiguous()
                      for t in (q, k, v))

        def library(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)

        def plain(q=q, k=k, v=v, causal=causal):
            with full_fp32():
                return ref.flash_attention_ref(q, k, v, causal=causal)

        yp = plain()
        y_lib = library().transpose(1, 2)
        lib_err = float((y_lib.float() - yp.float()).abs().max())
        controls = {}
        if q.dtype == bf16:
            # controls: SDPA and the plain version with bf16 P must come
            # out as not correct under FA_BF16, or the gate cannot tell a
            # bf16-P kernel from this one
            with full_fp32():
                y_p16 = _plain_with_bf16_probabilities(q, k, v,
                                                       causal=causal)
            for name, yc in (("sdpa", y_lib), ("bf16_p", y_p16)):
                ok, c_err, c_over = _fa_close(yc, yp)
                controls[name] = {"max_abs_err": c_err, "share_beyond": c_over}
                say(f"attention {label} control {name} vs plain: max-abs-"
                    f"diff {c_err:.3e}, {c_over:.4f} of elements beyond rtol "
                    f"{FA_BF16[0]} / atol {FA_BF16[1]} (must be > 0)")
                if ok:
                    fail(f"attention {label}: control {name} passes the bf16 "
                         f"tolerance; it cannot tell a bf16-P kernel apart")
        n_bytes = (q.numel() + k.numel() + v.numel() + b * sq * nq * dv) \
            * q.element_size()
        n_ops = 2 * b * nq * _visible_pairs(sq, sk, causal) * (d + dv)
        b_ms, b_by = bound(n_bytes, n_ops,
                           BF16_FLOPS if q.dtype == bf16 else F32_FLOPS)
        impl = ops.pick_impl(q.dtype, d, dv)

        def instance(name, q=q, k=k, v=v, causal=causal):
            return ops.flash_attention_cuda(q, k, v, causal=causal,
                                            impl=name)

        row = {"case": label, "shape": [b, sq, sk, nq, nkv, d, dv],
               "dtype": str(q.dtype)[6:], "causal": causal, "impl": impl,
               "ms": cuda_ms(lambda: ops.flash_attention_kernel(
                   q, k, v, causal=causal), 10),
               "simt_ms": (cuda_ms(lambda: instance("simt"), 5)
                           if impl != "simt" else None),
               "plain_ms": cuda_ms(plain, 3),
               "library_ms": cuda_ms(library, 20),
               "library_vs_plain_max_abs": lib_err, "controls": controls,
               "bytes": n_bytes, "ops": n_ops,
               "bound_ms": b_ms, "bound_by": b_by}
        per_shape.append(row)
        simt = (f", simt instance {row['simt_ms']:.4f} ms "
                f"({row['simt_ms'] / row['ms']:.1f}x)"
                if row["simt_ms"] is not None else "")
        say(f"attention {label} {row['dtype']}: kernel [{impl}] "
            f"{row['ms']:.4f} ms{simt}, plain {row['plain_ms']:.4f} ms, "
            f"SDPA bf16 "
            f"{row['library_ms']:.4f} ms (vs plain {lib_err:.3e}), bound "
            f"{b_ms:.4f} ms ({b_by}; {n_ops} flops, {n_bytes} bytes)")

    head = next(r for r in per_shape if r["case"] == head_label)
    return dict(FA_KERNEL, launches=launches, launches_by_impl=by_impl,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=head["ms"], simt_ms=head["simt_ms"],
                plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"],
                per_call="one causal attention at the qwen2.5-3b widths, "
                         "B = 1, S = 4096 (one layer of a 4096-token "
                         "prefill): ms on the sm90 instance it is routed "
                         "to, simt_ms on the CUDA-core instance; "
                         "max_abs_err over every case",
                sm90_info={d: ops.sm90_info(d) for d in ops.SM90_HEAD_DIMS},
                per_shape=per_shape, cases=rows,
                chunked_max_abs_err=err_chunked)


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
    from repro_torch.kernels.flash_attention import ops as fa_ops
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
    sources = [smm_ops.SOURCE, *mm_ops.SOURCES.values(),
               *fa_ops.SOURCES.values()]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(smm_ops.load_kernel),
                    *(pool.submit(mm_ops.load_kernel, i)
                      for i in mm_ops.IMPLS),
                    pool.submit(fa_ops.load_kernel, "simt"),
                    pool.submit(fa_ops.load_kernel, "sm90")]:
            fut.result()
    say(f"build: {' + '.join(p.name for p in sources)} -> "
        f"{_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        text = _build.log_path(src).read_text()
        if src in (mm_ops.SOURCES["splitk"], mm_ops.SOURCES["sm90"]):
            # many template instances: one summary line a source
            regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                                text)]
            smem = [int(b) for b in re.findall(r"(\d+) bytes smem", text)]
            spill = [(int(a), int(b)) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
            say(f"  ptxas {src.name}: {len(regs)} kernels, registers "
                f"{min(regs)}..{max(regs)}, static smem up to "
                f"{max(smem, default=0)} bytes (dynamic smem set at launch), "
                f"spills in {sum(1 for a, b in spill if a or b)} kernels, "
                f"at most {max((a for a, _ in spill), default=0)} bytes")
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {src.stem}: {line.strip()}")
    sm90_log = _build.log_path(fa_ops.SOURCES["sm90"]).read_text()
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        sm90_log)
    if not spills or any(int(a) or int(b) for a, b in spills):
        fail(f"flash_attention_sm90: ptxas reports spills {spills}")
    say(f"  flash_attention_sm90 per D: " + ", ".join(
        f"D={d} {fa_ops.sm90_info(d)}" for d in fa_ops.SM90_HEAD_DIMS))

    t0 = time.perf_counter()
    kernels = [cnn_path(args)]
    say(f"cnn path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row, prefill_qkv = serve_path(args)
    kernels.append(row)
    say(f"serve path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(attention_path(args, prefill_qkv))
    say(f"attention path: {time.perf_counter() - t0:.1f} s")

    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
