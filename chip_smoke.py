#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from the sources in this checkout
(``smm_conv.cu`` and ``smm_conv_sm90.cu``, the two instances of the SMM
convolution; ``codr_matmul.cu``, ``codr_matmul_splitk.cu`` and
``codr_matmul_sm90.cu``, the three of the compressed matmul;
``flash_attention.cu`` and ``flash_attention_sm90.cu``, the two of flash
attention: one ``nvcc`` per source, all seven started together) and
drives the port's three paths, each through the entry points a user
calls:

* CNN inference from compressed weights (spec → ``compile`` →
  ``CompiledModel.run`` on the ``smm_kernel`` backend) at the published
  widths of VGG16, on the ``smm_conv`` kernel: every layer (stride 1,
  int8 weights) on its tensor-core instance (``sm90``), as the routing
  rule names it, and the launches by instance held to that rule.  Each
  layer's call is replayed on both instances and held to the plain
  version (max-abs-diff 0), at the main path's sizes and at VGG16's
  published input sizes, and timed beside ``F.conv2d`` in fp32 and in
  TF32; AlexNet conv1 and GoogLeNet conv1 (strided, ``simt`` only) are
  held to the plain version too;
* transformer serving from packed weights (``init_params`` →
  ``compile_params`` → ``prefill`` → ``greedy_decode``, ``run_serve``'s
  loop, which replays one decode step captured as a CUDA graph; the
  same loop run eagerly gives the same tokens and logits bits at every
  step) at the published widths of qwen2.5-3b, every
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

After the three paths, three serving phases drive the same compiled
models through the port's servers and its checkpoint:

* the CNN batch server (``CompiledModel.serve``, the VGG16 model of the
  first path): 12 single-image requests synchronously, the same 12
  asynchronously (load trigger, pinned staging on a side stream), and 3
  that take the latency trigger; async == sync == ``CompiledModel.run``
  on the stacked batch at max-abs-diff 0, every ``smm_conv`` launch on
  ``sm90``;
* the continuous batcher (``ContinuousBatcher``) on the qwen2.5-3b
  packs of the second path, its pooled step replayed from a CUDA graph:
  six prompts over four slots, two joining mid-stream, on the dense,
  bf16-paged and int8-paged pools, each run captured and eager with the
  same bits; every request equals its solo ``generate_reference``
  (tokens and logits bits), the bf16 paged pool equals the dense pool,
  an int8 paged pool stays within 0.10 of the dense logit spread under
  teacher forcing; ``run_serve_continuous(check=True)`` at its smoke
  size; then the dense run under a seeded fault plan (transient errors,
  a worker crash, latency) with retry and restart, equal to the clean
  run bit for bit;
* the packed checkpoint: the full-width packs through ``save_packed``
  and ``load_packed(mmap=True)`` onto the card, teacher-forced logits
  bit for bit, then ``run_serve_continuous`` with chaos and a packed
  checkpoint at its smoke
  size.

Then the per-layer encoding search (``repro_torch.tune``): VGG16's
spec searched by ``tune_spec`` (``max_rel_err`` 0.03, sampled grid) and
compiled on ``smm_kernel`` beside the best global config over the same
table (each tuned layer's ``smm_conv`` equal to plain, the request within
5% of ``tiled``'s range, the plan's predicted SRAM no worse than the
global config's); the CLI's ``--small --check`` on the card and its
defaults; and qwen2.5-3b at its published widths under a ``tune_params``
plan whose budget mixes bit widths, served by ``run_serve``'s loop
(replayed == eager, within the f32 lane bound of ``tiled``, launches
held by instance and by bits) and booted from its packed checkpoint with
the plan.

Last, with qwen's packs freed, deepseek-v2-236b at its published widths
(MLA, 160 routed experts top-6 + 2 shared, the dense prologue layer),
depth cut 60 -> 3 (the prologue and two MoE layers), ~9.3 B parameters
drawn on the card and packed to 4 bits: prefill on ``sm90``, 63 decode
steps replayed from one CUDA graph on ``splitk`` and held bit for bit
to the eager loop, the ``codr_matmul`` launches held to the counts the
code gives (24 a prefill, 21 a step), the lane against ``tiled`` in
float32, a profiled window of replays, every new projection shape at
M = 4 and 128, and four requests through the batcher on the dense,
bf16-paged and int8-paged pools (captured == eager, bf16 paged ==
dense, int8 within 0.10); peak device memory per step of the phase.

Then the rest of the reference's registry, each phase served the same
way by ``model_phase`` (init on the card, 4-bit packs, prefill, and
``run_serve``'s loop replayed from one CUDA graph: ``greedy_decode``, or
``pad_self_cache`` and ``encdec_decode`` for the encoder-decoder), the
launches held to the counts the code gives and the routing rule, the
graph's ``codr_matmul`` kernel nodes counted, the replayed loop held bit
for bit to the eager one at every step and the lane to ``tiled`` in
float32: jamba-v0.1-52b at its published widths, depth cut 32 -> 8
(one period: seven mamba layers and one attention layer, four MoE and
four dense MLPs; ~13.3 B parameters), with a profiled window of
replays, per-shape rows for its narrow projections (x_proj 8192 -> 288,
dt_proj 256 -> 8192, in_proj, the router 4096 -> 16) and four requests
through the batcher's dense pool (captured == eager; the paged pools
refuse an SSM mixer); xlstm-350m whole (24 layers; the batcher too;
the if_proj 2048 -> 8 row); seamless-m4t-medium whole (12 + 12 layers,
stub frames (4, 1024, 1024)); internvl2-26b at its published widths,
depth cut 48 -> 4, behind a stub vision prefix (4, 1024, 6144).

Then the sharded CNN lane (``sharded_phase``): the VGG16 model of the
first path on the ``sharded`` backend over meshes of D = 1 (the card), 2
and 4 (cuda:0 repeated: a mesh may name one device more than once), each
request held to ``tiled`` on the same model, bit for bit where that
holds and else within 1e-4 of the output's range, the distance printed;
then a ``CodrBatchServer`` under a ``ServingSupervisor`` over the D = 4
lane with two device losses at ``sharded.dispatch`` and one dispatch
error, every request served once and equal to a clean supervised run's,
the ladder walked down to ``tiled``.  Last, training (``train_phase``):
``python -m repro_torch.launch.train --steps 40`` as a child process
(the smoke variant, as the reference's CLI always trains; it must print
``improved``); qwen2.5-3b at its published widths with the depth cut to
4 (bf16 params, AdamW's float32 moments, batch 8 x seq 128, lr 3e-3):
40 steps uninterrupted, then the same 40 with checkpoints every 10, a
failure at step 25 and a resume from step 20 whose losses are held to
the uninterrupted run's; then the full depth, 36 layers, 10 timed
steps.  Neither phase launches a
hand-written kernel (the reference's sharded lane and training reach no
Pallas kernel): their launch counts are held to 0.
Then the model on a mesh (phase 10), each lane through ``build_cell``'s
step on a single-controller mesh of cuda:0 and held to its one-device
form: ``dist_phase`` (after the tune phase, on the serve path's packs
on the ``tiled`` lane: qwen2.5-3b at full depth with
``decode_attn="dist"``, batch 4, a 32,768-position cache, a 32-token
prompt and 16 steps on meshes (2, 2) and (1, 4), within 0.02 of the
spread of the standard lane, ms/step of both and the largest block's
bytes); ``ds_mesh_check`` (inside the deepseek phase, its packs on
``tiled``, float32: prefill on the expert-parallel branch, 8 decode
steps on the 2-D branch, (2, 2), within 1e-3 of the spread);
``train_mesh_check`` (after the train phase: qwen2.5-3b depth 4, batch
8 x 128, (2, 2), one step's loss within 2e-2 of that phase's first);
and, last, the dry-run CLI (``python -m repro_torch.launch.dryrun``)
for qwen2.5-3b and deepseek-v2-236b at each production mesh, four
host-only children at once after the card's phases, each record's
status, per-device bytes and FLOPs printed.  No mesh check launches a
hand-written kernel (the reference's mesh lanes are XLA): held to 0.
A host-only line gives the paper's cost-model ratios (a model estimate,
not a measurement).

Each kernel's launch count is set to 0 just before its path runs and
read just after.  A CUDA graph's replays launch its kernels with no
call of their wrappers, so ``codr_matmul``'s counts hold the calls
(prefill, the warm-up step, the capture) and its row adds the replayed
launches as captured × replays.  Each kernel is held against its plain PyTorch version
on the card at the shapes its path gives it, and timed.  The script
prints one JSON line per the smoke contract: a ``kernels`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed check
exits non-zero before the result lines; without a CUDA device it exits
2 at once.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
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
              "source": "src/repro_torch/kernels/smm_conv/csrc/"
                        "smm_conv_sm90.cu",
              "sources": {i: f"src/repro_torch/kernels/smm_conv/csrc/{f}"
                          for i, f in (("simt", "smm_conv.cu"),
                                       ("sm90", "smm_conv_sm90.cu"))},
              "replaces": "src/repro/kernels/smm_conv/kernel.py:88"}
# the device kernels of the two smm_conv instances, by name
SMM_KERNEL_NAMES = re.compile(r"smm_conv(_sm90)?_kernel")
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


# the card's name and power limit, beside every time printed
SMI = "card not read yet"


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


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's float32 convolutions in TF32 with its autotuner on: exact
    on integer-valued inputs and int8 weights while |sums| < 2^24."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


# ---------------------------------------------------------------------------
# path 1: CNN inference on smm_conv (VGG16 conv1_1 .. conv3_3)
# ---------------------------------------------------------------------------

def _profile(fn, name: str, names, warmup=None) -> dict:
    """One call of ``fn`` (ending in a synchronize) under
    ``torch.profiler``: wall time, device-busy time and idle share, the
    share of the kernels whose name matches ``names`` (as ``<name>_ms``
    and ``<name>_launches``), all kernels, and the host's op time.  The
    profiler adds host time of its own.  ``warmup`` runs first in the
    same trace and is not counted: the first moments of a trace's device
    activity can go unrecorded (on the H100, the first 7 to ~3,400
    kernels of a window of CUDA-graph replays, from its first replay).
    The warm-up makes the loss rarer but does not end it, so the kernel
    counts here are a measurement, not a gate: what a graph's replays
    launch is counted from the graph (``_graph_kernels``).

    The window starts on the device's clock: a marker kernel
    (``torch.cuda._sleep``, ATen's ``spin_kernel``) runs between the
    warm-up and ``fn``, with a synchronize on each side, so every
    warm-up kernel ends before it starts and every kernel of ``fn``
    starts after it ends; the device events counted are those that start
    after its end.  Host events are those inside the
    ``record_function`` mark.  ``window_start`` says which of the two
    bounded the device events: ``"device marker"``, or, where the
    profiler lost the marker's record, ``"host mark"`` (no warm-up: the
    trace holds no earlier kernels, so every device event is the
    window's) or ``"host mark less 1 ms"`` (the host clock's mark less
    1 ms, the warm-up ended 5 ms before it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    mark = "chip_smoke.window"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warmup is not None:
            warmup()
            torch.cuda.synchronize()
            time.sleep(0.005)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function(mark):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host_start = min(e.time_range.start for e in events if e.name == mark
                     and e.device_type == DeviceType.CPU)
    markers = [e for e in events if e.device_type == DeviceType.CUDA
               and "spin_kernel" in e.name]
    if markers:
        dev_start, window_start = (max(e.time_range.end for e in markers),
                                   "device marker")
    elif warmup is None:
        dev_start, window_start = float("-inf"), "host mark"
    else:
        dev_start, window_start = host_start - 1000, "host mark less 1 ms"
    # device events less the marker and the mark's own range, which the
    # profiler also records on the device's track
    device_events = [e for e in events if e.device_type == DeviceType.CUDA
                     and "spin_kernel" not in e.name and e.name != mark]
    kernels = [e for e in device_events if e.time_range.start >= dev_start]
    # what a window bounded by the host mark less 1 ms would have taken
    # in besides: kernels that ran before the marker
    early = sum(host_start - 1000 <= e.time_range.start < dev_start
                for e in device_events)
    events = [e for e in events if e.device_type == DeviceType.CPU
              and e.time_range.start >= host_start and e.name != mark]
    by_name: dict = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [e.name[:60], 0.0, 0])
        row[1] += e.time_range.elapsed_us() / 1e3
        row[2] += 1
    device = sum(r[1] for r in by_name.values())
    named = [r for key, r in by_name.items() if names.search(key)]
    out = {"wall_ms": wall, "device_busy_ms": device,
           f"{name}_ms": sum(r[1] for r in named),
           f"{name}_launches": sum(r[2] for r in named),
           "device_kernels": len(kernels), "window_start": window_start,
           "kernels_before_marker_after_host_mark": early,
           "host_op_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
           "top": sorted(by_name.values(), key=lambda r: -r[1])[:6]}
    out["idle"] = ("not measured (no device events)" if device == 0 else
                   f"{max(0.0, 1 - device / wall):.3f}")
    return out


@contextlib.contextmanager
def _kept_graphs():
    """CUDA graphs captured inside keep their ``cudaGraph_t`` (torch's
    ``keep_graph=True``: the first replay instantiates, where
    ``capture_end`` would have), so that ``_graph_kernels`` can list what
    a replay launches."""
    import torch
    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


def _graph_kernels(graph, names) -> int:
    """The kernel nodes of ``graph`` (captured under ``_kept_graphs``)
    whose function name matches ``names``: the kernels every replay
    launches.  Read from the graph itself (``libcuda``), since the
    profiler can lose the records of a few kernels of a window of
    replays (on the H100: 3 to 255 of 1,302 to 15,624)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def call(fn, *a) -> None:
        rc = getattr(cu, fn)(*a)
        if rc:
            fail(f"{fn} returned CUresult {rc}")
    g, n = vp(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    count = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(node), ctypes.byref(kind))
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (vp * 16)()                  # CUDA_KERNEL_NODE_PARAMS_v2
        call("cuGraphKernelNodeGetParams_v2", vp(node), params)
        if not params[0]:
            fail("a kernel node of the graph has no CUfunction")
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), vp(params[0]))
        count += bool(names.search(name.value.decode()))
    return count


def _say_profile(label: str, out: dict, name: str) -> None:
    say(f"{label}: wall {out['wall_ms']:.3f} ms, device busy "
        f"{out['device_busy_ms']:.3f} ms (idle share {out['idle']}), {name} "
        f"{out[name + '_ms']:.3f} ms over {out[name + '_launches']} "
        f"launches, {out['device_kernels']} kernels in all (window from the "
        f"{out['window_start']}), host op time "
        f"{out['host_op_ms']:.3f} ms; top kernels [name, ms, count]: "
        f"{out['top']}")


def _profile_request(compiled, x) -> dict:
    """One steady request under ``torch.profiler``."""
    out = _profile(lambda: compiled.run(x), "smm_conv", SMM_KERNEL_NAMES)
    _say_profile("cnn profile, one steady request", out, "smm_conv")
    return out


def _smm_rule(compiled, batch: int, hw) -> list:
    """The instance ``smm_conv.ops.pick_impl`` names for each layer's
    call in a request of ``batch`` images of ``hw``."""
    from repro_torch.kernels.smm_conv import ops
    rule, (ri, ci) = [], hw
    for layer in compiled.model.layers:
        deltas, _, meta = layer.smm_operands()
        ro, co = layer.out_hw(ri, ci)
        rule.append(ops.pick_impl(
            (batch, layer.code.shape[1], ri, ci), tuple(deltas.shape),
            t_m=meta["t_m"], ro=ro, co=co, stride=layer.stride,
            int8_weights=meta["int8_weights"]))
        ri, ci = ro, co
    return rule


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
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
    outs, req_ms, per_request = [], [], []
    for x in images:
        before = dict(ops.launches_by_impl)
        t0 = time.perf_counter()
        y = compiled.run(x)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        per_request.append({i: ops.launches_by_impl[i] - before[i]
                            for i in ops.IMPLS})
        outs.append(y)
    launches = ops.launches
    by_impl = dict(ops.launches_by_impl)
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

    # the routing rule at each layer's main-path call
    rule = _smm_rule(compiled, batch, (226, 226))
    want = {i: rule.count(i) for i in ops.IMPLS}
    say(f"cnn launches by instance: per request {per_request}, in all "
        f"{by_impl}; the rule names {rule} per request")
    if any(r != want for r in per_request) or \
            by_impl != {i: n * n_requests for i, n in want.items()}:
        fail(f"smm_conv launches by instance {per_request} / {by_impl} "
             f"differ from the routing rule's {want} per request")
    profile = _profile_request(compiled, images[1])

    def layer_row(label, layer, xin, ri, ci):
        """Every instance that takes the call against the plain version
        (max-abs-diff 0) and timed, beside cuDNN in fp32 and in TF32."""
        deltas, entries, meta = layer.smm_operands()
        ro, co = layer.out_hw(ri, ci)
        kw = dict(t_m=meta["t_m"], ro=ro, co=co, stride=layer.stride)
        flag = meta["int8_weights"]
        routed = ops.pick_impl(tuple(xin.shape), tuple(deltas.shape),
                               int8_weights=flag, **kw)
        yp = ref.smm_conv_plain(xin, deltas, entries, **kw)
        m, n, rk, ck = layer.code.shape
        errs, times = {}, {}
        for impl in ops.IMPLS:
            if impl == "sm90" and ops.sm90_refusal(
                    tuple(xin.shape), tuple(deltas.shape), int8_weights=flag,
                    **kw):
                continue

            def call(impl=impl):
                return ops.smm_conv_cuda(xin, deltas, entries, impl=impl,
                                         int8_weights=flag, **kw)
            errs[impl] = float((call() - yp).abs().max())
            if errs[impl] != 0.0:
                fail(f"{label} {layer.name}: {impl} vs plain max-abs-diff "
                     f"{errs[impl]}")
            times[impl] = cuda_ms(call, 5)
        w_int = torch.from_numpy(layer.decoded_weights().astype(
            np.float32)).cuda()
        w = torch.from_numpy(layer.decoded_weights().astype(np.float32)
                             * layer.scale).cuda()

        def fp32(xin=xin, w=w, s=layer.stride):
            with full_fp32():
                return F.conv2d(xin, w, stride=s)

        def tf32(xin=xin, w=w_int, s=layer.stride):
            with cudnn_tf32():
                return F.conv2d(xin, w, stride=s)
        tf32_err = float((tf32() - yp[:, :m]).abs().max())
        st = layer.stats()
        b = xin.shape[0]
        n_bytes = 4 * (xin.numel() + deltas.numel() + entries.numel()
                       + b * m * ro * co)
        n_ops = 2 * b * st.n_nonzero * ro * co
        b_ms, b_by = bound(n_bytes, n_ops, INT8_TOPS)
        row = {"layer": layer.name, "size": label,
               "shape": [m, n, rk, ck, ri, ci, layer.stride, b],
               "impl": routed, "max_abs_err": max(errs.values()),
               "ms": times[routed],
               **{f"{i}_ms": times.get(i) for i in ops.IMPLS},
               "plain_ms": cuda_ms(lambda: ref.smm_conv_plain(
                   xin, deltas, entries, **kw), 2),
               "library_ms": cuda_ms(fp32, 5),
               "library_tf32_ms": cuda_ms(tf32, 5),
               "library_tf32_max_abs_diff": tf32_err,
               "ops": n_ops, "bytes": n_bytes,
               "bound_ms": b_ms, "bound_by": b_by}
        inst = ", ".join(f"{i} {t:.4f} ms" for i, t in times.items())
        say(f"cnn {label} {layer.name} {row['shape']}: [{routed}] {inst}, "
            f"plain {row['plain_ms']:.4f} ms, F.conv2d fp32 "
            f"{row['library_ms']:.4f} ms, F.conv2d TF32 "
            f"{row['library_tf32_ms']:.4f} ms (vs plain {tf32_err}), bound "
            f"{b_ms:.4f} ms ({b_by}), max-abs-diff {row['max_abs_err']}")
        return row, ro, co

    rows = []
    x = compiled.model.as_input(images[0])
    ri = ci = 226
    for layer in compiled.model.layers:
        xi, _ = _int_activations(x)
        row, ro, co = layer_row("main", layer,
                                xi.permute(0, 3, 1, 2).contiguous(), ri, ci)
        rows.append(row)
        x = compiled.backend.conv(layer, x)
        ri, ci = ro, co
    if not torch.equal(x, outs[0]):
        fail("layer-by-layer replay of request 0 differs from the main path")
    # the same layers at VGG16's published input sizes (226 / 114 / 58):
    # the main path chains VALID convolutions without pooling
    pub_rng = np.random.default_rng(args.seed + 3)
    published = []
    for layer, s in zip(compiled.model.layers, shapes):
        xin = torch.from_numpy(pub_rng.integers(-127, 128, size=(
            batch, s.n, s.ri, s.ci)).astype(np.float32)).cuda()
        published.append(layer_row("published", layer, xin, s.ri, s.ci)[0])
    max_err = max(r["max_abs_err"] for r in rows + published)

    for net, s in (("alexnet conv1", ALEXNET[0]),
                   ("googlenet conv1", GOOGLENET[0])):
        rng = np.random.default_rng(args.seed + 2)
        wt = rng.normal(size=(s.m, s.n, s.rk, s.ck)).astype(np.float32)
        wt[rng.random(wt.shape) > 0.4] = 0
        code = ucr.encode_conv_layer(wt, n_unique=16)
        xs = torch.from_numpy(rng.integers(-127, 128, size=(
            batch, s.n, s.ri, s.ci)).astype(np.float32)).cuda()
        deltas, entries, meta = ops.smm_operands_on(code, s.n, "cuda")
        kw = dict(t_m=meta["t_m"], ro=s.ro, co=s.co, stride=s.stride,
                  int8_weights=meta["int8_weights"])
        routed = ops.pick_impl(tuple(xs.shape), tuple(deltas.shape), **kw)
        why = ops.sm90_refusal(tuple(xs.shape), tuple(deltas.shape), **kw)
        yp = ref.smm_conv_plain(xs, deltas, entries, t_m=meta["t_m"],
                                ro=s.ro, co=s.co, stride=s.stride)
        for impl in ops.IMPLS:
            if impl == "sm90" and why:
                say(f"cnn {net}: sm90 does not take it ({why})")
                continue
            err = float((ops.smm_conv_cuda(xs, deltas, entries, impl=impl,
                                           **kw) - yp).abs().max())
            max_err = max(max_err, err)
            say(f"cnn {net} ({s.rk}x{s.rk}, stride {s.stride}, {s.ri}^2): "
                f"{impl}{' (routed)' if impl == routed else ''} vs plain "
                f"max-abs-diff {err}")
            if err != 0.0:
                fail(f"{net}: {impl} vs plain max-abs-diff {err}")

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
    sums = {k: sum(r[k] for r in rows)
            for k in ("ms", "simt_ms", "plain_ms", "library_ms",
                      "library_tf32_ms")}
    say(f"cnn one request's 7 launches: routed {sums['ms']:.4f} ms, simt "
        f"{sums['simt_ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
        f"F.conv2d fp32 {sums['library_ms']:.4f} ms, TF32 "
        f"{sums['library_tf32_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return compiled, dict(SMM_KERNEL, launches=launches,
                          launches_by_impl=by_impl,
                launches_per_request=per_request, max_abs_err=max_err,
                **sums, bound_ms=b_ms, bound_by=b_by,
                per_request="sums over the 7 main-path launches of one "
                            "request (batch 4): ms on the routed instance, "
                            "simt_ms on the first kernel, library_ms "
                            "F.conv2d fp32 on the scaled weights, "
                            "library_tf32_ms F.conv2d TF32 (cudnn.benchmark) "
                            "on the integer weights",
                per_shape=rows, published=published,
                main_path={"request_ms": req_ms, "encode_s": encode_s,
                           "peak_memory_bytes": peak, "profile": profile})


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


def _teacher_forced(api, params, cfg, tokens, dtype, steps: int = 4,
                    prefix=None):
    """Prefill + ``steps`` decode steps fed the prompt's own tokens, with
    activations in ``dtype`` (``DEFAULT_DTYPE`` of both model modules
    swapped for the call, as the reference's tests do for a float32
    comparison): the decoder-only steps over a fresh cache, the
    encoder-decoder's over its prefill cache padded out.  ``prefix`` is
    the frontend stub's (the encoder's frames)."""
    import torch

    from repro_torch.launch.serve import pad_self_cache
    from repro_torch.models import encdec, lm
    saved = lm.DEFAULT_DTYPE, encdec.DEFAULT_DTYPE
    lm.DEFAULT_DTYPE = encdec.DEFAULT_DTYPE = dtype
    batch_in = {"tokens": tokens}
    if prefix is not None:
        batch_in["prefix"] = prefix
    try:
        logits, cache = api.prefill(params, batch_in, cfg)
        out = [logits]
        if cfg.family == "encdec":
            start = tokens.shape[1]
            cache = pad_self_cache(cache, start + steps)
        else:
            start = 0
            cache = api.init_cache(cfg, tokens.shape[0], steps, dtype=dtype,
                                   device=tokens.device)
        for i in range(steps):
            lg, cache = api.decode_step(params, cache, tokens[:, i],
                                        start + i, cfg)
            out.append(lg)
        torch.cuda.synchronize()
    finally:
        lm.DEFAULT_DTYPE, encdec.DEFAULT_DTYPE = saved
    return out


def _profile_step(api, params, cfg, tokens) -> dict:
    """One decode step (after two warm ones) under ``torch.profiler``."""
    import torch
    cache = api.init_cache(cfg, tokens.shape[0], 8, device=tokens.device)
    for i in range(2):
        _, cache = api.decode_step(params, cache, tokens[:, i], i, cfg)
    torch.cuda.synchronize()
    out = _profile(lambda: api.decode_step(params, cache, tokens[:, 2], 2,
                                           cfg), "codr_matmul",
                   MM_KERNEL_NAMES)
    _say_profile("serve profile, one decode step", out, "codr_matmul")
    return out


def _step_logits(api, params, tokens, cfg, gen_len, *, captured: bool,
                 prefix=None):
    """``run_serve``'s loop for ``cfg``'s family with a copy of every
    step's logits kept, ``decode_step`` eagerly or one ``CapturedDecode``
    replayed (captured under ``_kept_graphs``): the decoder-only loop
    (``greedy_decode``) replays the prompt ``tokens`` over a fresh cache,
    the encoder-decoder loop (``encdec_decode``) continues from the
    prefill of ``prefix`` and ``tokens``, its cache padded out.  Returns
    ``(rows, the CapturedDecode or None)``."""
    import torch

    from repro_torch.launch.serve import pad_self_cache
    from repro_torch.models.lm import CapturedDecode
    batch, prompt_len = tokens.shape
    total = prompt_len + gen_len
    if cfg.family == "encdec":
        logits, cache = api.prefill(params, {"tokens": tokens,
                                             "prefix": prefix}, cfg)
        cache = pad_self_cache(cache, total)
        tok, start = torch.argmax(logits[:, -1], dim=-1), prompt_len
    else:
        cache = api.init_cache(cfg, batch, total, device=tokens.device)
        tok, start = tokens[:, 0], 0
    with _kept_graphs():
        step = CapturedDecode(params, cache, cfg, batch) if captured else None
        rows = []
        for i in range(start, total - 1):
            if step is None:
                logits, cache = api.decode_step(params, cache, tok, i, cfg)
            else:
                logits = step(tok, i)
            rows.append(logits.clone())
            tok = (tokens[:, i + 1] if i + 1 < prompt_len
                   else torch.argmax(logits, dim=-1))
    return rows, step


def _profile_replay(api, params, cfg, tokens, gen_len, per_forward: int,
                    label: str = "serve") -> dict:
    """``run_serve``'s loop replayed from one CUDA graph over the main
    path's full-length cache.  After the step that captures, the other
    steps run back to back (each feeds the next its token on the device;
    one sync at the end): once timed on the host clock, then again under
    ``torch.profiler``, which gives the device-busy time and idle share
    of that window and counts the ``codr_matmul`` kernels it recorded
    (the window runs once more first, inside the same trace, as its
    warm-up).  What the replays launched is counted from the graph: its
    ``codr_matmul`` kernel nodes must be ``per_forward``, the profiler's
    count no more than ``per_forward`` a replay, and the wrapper's
    counters must not move in the window."""
    import torch

    from repro_torch.kernels.codr_matmul import ops
    from repro_torch.models.lm import CapturedDecode
    batch, prompt_len = tokens.shape
    total = prompt_len + gen_len
    with _kept_graphs():
        step = CapturedDecode(params, api.init_cache(cfg, batch, total,
                                                     device=tokens.device),
                              cfg, batch)
        step(tokens[:, 0], 0)         # the warm-up, the capture, a replay
    torch.cuda.synchronize()
    in_graph = _graph_kernels(step.graph, MM_KERNEL_NAMES)

    def window():
        tok = tokens[:, 1]
        for i in range(1, total - 1):
            logits = step(tok, i)
            tok = (tokens[:, i + 1] if i + 1 < prompt_len
                   else torch.argmax(logits, dim=-1))
    n = total - 2
    counted = (ops.launches, ops.captured)
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    out = _profile(window, "codr_matmul", MM_KERNEL_NAMES, warmup=window)
    out.update(replays=n, host_clock_ms_per_step=host_ms / n,
               profiled_ms_per_step=out["wall_ms"] / n,
               device_busy_ms_per_step=out["device_busy_ms"] / n,
               graph_codr_matmul_kernels=in_graph,
               replayed_launches=in_graph * n,
               profiler_missed=in_graph * n - out["codr_matmul_launches"])
    _say_profile(f"{label} profile, {n} replayed steps back to back (one "
                 f"sync at the end) [{SMI}]", out, "codr_matmul")
    say(f"{label} replay window: {host_ms / n:.3f} ms/step on the host clock "
        f"unprofiled, {out['profiled_ms_per_step']:.3f} ms/step profiled, "
        f"device busy {out['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"share {out['idle']}; the graph holds {in_graph} codr_matmul "
        f"kernels ({per_forward} expected), so {n} replays launched "
        f"{in_graph * n}; the profiler recorded "
        f"{out['codr_matmul_launches']} of them (missed "
        f"{out['profiler_missed']}; window from the {out['window_start']}"
        f", {out['kernels_before_marker_after_host_mark']} kernels before "
        f"the marker start after the host mark less 1 ms); the wrapper's "
        f"counters moved "
        f"{ops.launches - counted[0]} / {ops.captured - counted[1]}")
    if in_graph != per_forward or (ops.launches, ops.captured) != counted \
            or not 0 < out["codr_matmul_launches"] <= per_forward * n:
        fail(f"{label}: the graph holds {in_graph} codr_matmul kernels, "
             f"expected {per_forward}; the profiler recorded "
             f"{out['codr_matmul_launches']} over {n} replays; or a counter "
             f"moved")
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
    """The serving path; returns the ``codr_matmul`` row, the q, k, v of
    layer 0's attention in the main path's prefill, and the packs."""
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
    # run_serve's loop on the card: one decode step captured as a CUDA
    # graph and replayed; the counters tick in the warm-up step, the
    # capture records its calls (ops.captured) and a replay calls no
    # wrapper: the profiler counts the replays' kernels further down
    ops.captured = 0
    t0 = time.perf_counter()
    out, _, n_steps = greedy_decode(api, params, tokens, cfg, gen_len)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = ops.launches
    captured = ops.captured
    by_impl = dict(ops.launches_by_impl)
    peak = torch.cuda.max_memory_allocated()
    per_forward = 7 * cfg.n_layers
    ms_step = decode_s / n_steps * 1e3
    tok_s = batch * gen_len / decode_s
    say(f"serve main path: prefill {prefill_ms:.3f} ms; {n_steps} decode "
        f"steps replayed from one CUDA graph {decode_s * 1e3:.3f} ms "
        f"({ms_step:.3f} ms/step, the warm-up step and the capture "
        f"included); generated tokens/s {tok_s:.3f} (batch {batch} x "
        f"{gen_len} over the decode loop, prompt replay included); peak "
        f"device memory {peak} bytes; codr_matmul launches counted "
        f"{launches}: {prefill_launches} in prefill, "
        f"{launches - prefill_launches} in the warm-up step; {captured} "
        f"calls recorded at the capture, which launch nothing")
    if prefill_launches != per_forward or n_steps != prompt_len + gen_len - 1 \
            or launches != 2 * per_forward or captured != per_forward:
        fail(f"codr_matmul counted {prefill_launches} / {launches} launches "
             f"over prefill + warm-up and {captured} captured calls, "
             f"expected {per_forward} each")
    # the routing rule's prediction: prefill at M = batch * prompt, the
    # warm-up step at M = batch
    want_prefill = dict.fromkeys(ops.IMPLS, 0)
    want_prefill[ops.pick_impl(batch * prompt_len, bits)] += per_forward
    want = dict(want_prefill)
    want[ops.pick_impl(batch, bits)] += per_forward
    say(f"serve codr_matmul launches by instance: prefill {prefill_by_impl}, "
        f"counted in all {by_impl} (routing predicts {want_prefill} / "
        f"{want})")
    if prefill_by_impl != want_prefill or by_impl != want:
        fail(f"codr_matmul launches by instance {prefill_by_impl} / "
             f"{by_impl}, the routing rule predicts {want_prefill} / {want}")
    # the same loop eager: the same tokens
    t0 = time.perf_counter()
    out_eager, _, _ = greedy_decode(api, params, tokens, cfg, gen_len,
                                    eager=True)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if not torch.equal(out, out_eager):
        fail("the replayed loop's tokens differ from the eager loop's")
    # and every step's logits, bit for bit, the loop driven step by step
    eager_logits, _ = _step_logits(api, params, tokens, cfg, gen_len,
                                   captured=False)
    replay_logits, _ = _step_logits(api, params, tokens, cfg, gen_len,
                                    captured=True)
    if len(eager_logits) != n_steps or len(replay_logits) != n_steps:
        fail(f"{len(eager_logits)} / {len(replay_logits)} steps, expected "
             f"{n_steps}")
    for i, (a, b) in enumerate(zip(eager_logits, replay_logits)):
        if not torch.equal(a, b):
            fail(f"decode step {i}: replayed logits differ from eager "
                 f"(max-abs {float((a.float() - b.float()).abs().max())})")
    del eager_logits, replay_logits
    graph_loop = {"replay_ms_per_step": ms_step, "replay_tok_s": tok_s,
                  "eager_ms_per_step": eager_s / n_steps * 1e3,
                  "eager_tok_s": batch * gen_len / eager_s,
                  "captured_calls": captured, "replays": n_steps}
    say(f"serve graph: {n_steps} steps, tokens equal and logits equal bit "
        f"for bit at every step; eager {graph_loop['eager_ms_per_step']:.3f} "
        f"ms/step ({graph_loop['eager_tok_s']:.3f} tokens/s) vs replayed "
        f"{ms_step:.3f} ms/step ({tok_s:.3f} tokens/s) [{SMI}]")
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

    # -- where one decode step's time goes (torch.profiler), eager and
    # replayed
    prof = _profile_step(api, params, cfg, tokens)
    graph_loop["profile"] = _profile_replay(api, params, cfg, tokens,
                                            gen_len, per_forward)

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
                launches_note="launches counts the wrapper's launches "
                              "(prefill, each warm-up step); calls "
                              "recorded at a capture launch nothing and "
                              "are not in it, nor are the graphs' "
                              "replays (the profiler counts those: "
                              "main_path.graph.profile)",
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
                           "bf16_lanes": bf16_err, "profile": prof,
                           "graph": graph_loop}), \
        qkv, compiled


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


# ---------------------------------------------------------------------------
# phase 4: the CNN batch server (CompiledModel.serve) on smm_conv
# ---------------------------------------------------------------------------

def _add_phase(row: dict, name: str, phase: dict) -> None:
    """Fold a serving phase's counted launches into its kernel's row."""
    row["launches"] += phase["launches"]
    for impl, n in phase["launches_by_impl"].items():
        row["launches_by_impl"][impl] = row["launches_by_impl"].get(
            impl, 0) + n
    row[name] = phase


def _percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def cnn_server_phase(args, compiled, hw: int = 226) -> dict:
    """The VGG16 model of the first path behind ``CompiledModel.serve``:
    12 single-image requests synchronously, the same 12 asynchronously
    (each group of 4 fills a batch: the load trigger), then 3 that take
    the latency trigger.  Activations are re-quantized per batch, so a
    row depends on its batch's other rows: async and sync are compared
    on the same groups, and each group against ``compiled.run`` on its
    stacked (padded) batch, at max-abs-diff 0."""
    import numpy as np
    import torch

    from repro_torch.kernels.smm_conv import ops
    img_rng = np.random.default_rng(args.seed + 4)
    imgs = [img_rng.integers(0, 256, size=(hw, hw, 3)).astype(np.float32)
            for _ in range(15)]
    groups = [imgs[0:4], imgs[4:8], imgs[8:12]]
    trio = imgs[12:15]
    sync = compiled.serve(max_batch=4)
    server = compiled.serve(max_batch=4, flush_deadline_s=0.005)
    # warm-up: the worker thread's first batch pays smm_conv's per-thread
    # occupancy query; the counts below start after it
    server.start_async()
    for f in [server.submit_async(x) for x in groups[0]]:
        f.result(timeout=300)
    torch.cuda.synchronize()
    buckets0 = dict(server.bucket_counts)

    ops.launches = 0
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
    t0 = time.perf_counter()
    sync_outs = sync.serve(imgs[:12])
    sync_s = time.perf_counter() - t0
    sync_trio = sync.serve(trio)
    lat, async_outs = [], []

    def submit(x):
        t_sub = time.perf_counter()
        fut = server.submit_async(x)
        fut.add_done_callback(lambda _f, t_sub=t_sub: lat.append(
            (time.perf_counter() - t_sub) * 1e3))
        return fut
    t0 = time.perf_counter()
    for g in groups:
        async_outs += [f.result(timeout=300) for f in [submit(x)
                                                        for x in g]]
    async_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    async_trio = [f.result(timeout=300) for f in [submit(x) for x in trio]]
    trio_ms = (time.perf_counter() - t1) * 1e3
    server.stop_async()
    launches, by_impl = ops.launches, dict(ops.launches_by_impl)
    buckets = {b: n - buckets0.get(b, 0)
               for b, n in server.bucket_counts.items()
               if n - buckets0.get(b, 0)}

    n_layers = len(compiled.model.layers)
    want = n_layers * (3 + 1 + 3 + 1)      # sync 3 + 1 batches, async 3 + 1
    say(f"cnn server: sync 12 requests {sync_s * 1e3:.3f} ms "
        f"({12 / sync_s:.3f} images/s); async 12 requests "
        f"{async_s * 1e3:.3f} ms ({12 / async_s:.3f} images/s), latency "
        f"p50 {_percentile(lat[:12], 50):.3f} ms p95 "
        f"{_percentile(lat[:12], 95):.3f} ms; 3 on the latency trigger "
        f"(flush_deadline_s {server.flush_deadline_s}) {trio_ms:.3f} ms, "
        f"latency p50 {_percentile(lat[12:], 50):.3f} ms; async "
        f"bucket_counts {buckets}, sync bucket_counts {sync.bucket_counts}; "
        f"smm_conv launches {launches}, by instance {by_impl}")
    if buckets != {4: 4}:
        fail(f"cnn server: async bucket_counts {buckets}, expected 3 load-"
             f"trigger batches and 1 latency-trigger batch of bucket 4")
    if launches != want or by_impl.get("sm90") != launches:
        fail(f"cnn server: smm_conv launches {launches} ({by_impl}), "
             f"expected {want}, all on sm90")
    err = 0.0
    for gi, g in enumerate(groups + [trio]):
        batch = np.stack(g + [g[-1]] * (4 - len(g)))
        ref = compiled.run(batch).cpu().numpy()
        a = async_outs[4 * gi:4 * gi + 4] if gi < 3 else async_trio
        y = sync_outs[4 * gi:4 * gi + 4] if gi < 3 else sync_trio
        for j in range(len(g)):
            if not (np.array_equal(a[j], y[j])
                    and np.array_equal(y[j], ref[j])):
                fail(f"cnn server: group {gi} row {j}: async / sync / run "
                     f"differ (max-abs {float(np.abs(a[j] - ref[j]).max())}"
                     f" / {float(np.abs(y[j] - ref[j]).max())})")
            if a[j].shape != ref.shape[1:] or not np.isfinite(a[j]).all():
                fail(f"cnn server: row {a[j].shape} not finite")
            err = max(err, float(np.abs(a[j] - ref[j]).max()))
    say(f"cnn server: async == sync == compiled.run on every group, "
        f"max-abs-diff {err}")

    # where a batch's time goes: the model run, then the rows' copy to
    # the host (what every request returns, as in the reference)
    batch = np.stack(groups[1])
    run_ms, copy_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        y = compiled.run(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y.cpu().numpy()
        run_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
    out_bytes = y.numel() * y.element_size()
    say(f"cnn server, one batch of 4: compiled.run {run_ms} ms, its "
        f"{out_bytes}-byte output to host numpy {copy_ms} ms "
        f"({out_bytes / min(copy_ms) / 1e6:.1f} MB/ms at best)")
    prof = _profile(lambda: sync.serve(groups[1]), "smm_conv",
                    SMM_KERNEL_NAMES)
    _say_profile("cnn server profile, one sync batch (serve: run + host "
                 "rows)", prof, "smm_conv")
    return {"launches": launches, "launches_by_impl": by_impl,
            "run_ms": run_ms, "to_host_ms": copy_ms,
            "output_bytes": out_bytes, "profile": prof,
            "sync_ms": sync_s * 1e3, "async_ms": async_s * 1e3,
            "sync_images_s": 12 / sync_s, "async_images_s": 12 / async_s,
            "latency_p50_ms": _percentile(lat[:12], 50),
            "latency_p95_ms": _percentile(lat[:12], 95),
            "deadline_trio_ms": trio_ms, "bucket_counts": buckets,
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 5: the continuous batcher on codr_matmul
# ---------------------------------------------------------------------------

BATCH_LENS = (5, 12, 17, 24, 33, 40)   # prompt lengths of the six requests
BATCH_GEN = 16


def _instrument(cb, stats: dict, mm_ops) -> None:
    """Wrap a batcher's prefill and pooled step: each call's device time
    (synchronized both sides; the batcher copies the logits to the host
    right after anyway) and its codr_matmul launches by instance."""
    import torch

    def timed(kind, fn):
        def call(*a):
            before = dict(mm_ops.launches_by_impl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            stats[kind + "_ms"].append((time.perf_counter() - t0) * 1e3)
            for i in mm_ops.IMPLS:
                stats[kind][i] += mm_ops.launches_by_impl[i] - before[i]
            return out
        return call
    cb._prefill_fn = timed("prefill", cb._prefill_fn)
    cb._step_fn = timed("decode", cb._step_fn)


def _pooled_run(cb, prompts) -> list:
    """Four requests, then — once the first has streamed 4 tokens — two
    more that join mid-stream (they wait for slots to free)."""
    handles = [cb.submit(p, max_new_tokens=BATCH_GEN) for p in prompts[:4]]
    it = iter(handles[0])
    head = [next(it) for _ in range(4)]
    handles += [cb.submit(p, max_new_tokens=BATCH_GEN) for p in prompts[4:]]
    outs = [h.result(timeout=600) for h in handles]
    if head != outs[0][:4]:
        fail("batcher: the stream differs from the result")
    return handles, outs


# the three pools of the batcher phase: keyword arguments of the batcher
POOLS = {"dense": {}, "bf16 paged": {"kv_page_size": 16},
         "int8 paged": {"kv_dtype": "int8"}}


def _batcher_run(packs, cfg, prompts, mm_ops, *, eager: bool, **kv):
    """One pooled run (four requests, two joining mid-stream) on a
    4-slot pool, its prefill / step times and codr_matmul launches by
    instance recorded."""
    from repro_torch.core.batching import ContinuousBatcher
    cb = ContinuousBatcher(packs, cfg, n_slots=4, max_len=96,
                           record_logits=True, eager=eager, **kv)
    stats = {"prefill": dict.fromkeys(mm_ops.IMPLS, 0),
             "decode": dict.fromkeys(mm_ops.IMPLS, 0),
             "prefill_ms": [], "decode_ms": []}
    _instrument(cb, stats, mm_ops)
    t0 = time.perf_counter()
    handles, outs = _pooled_run(cb, prompts)
    wall = time.perf_counter() - t0
    cb.stop_async()
    # the oracles below run through the same wrappers: keep this run's
    run = {"cb": cb, "handles": handles, "outs": outs, "wall_s": wall,
           "prefill": dict(stats["prefill"]),
           "decode": dict(stats["decode"]),
           "step_ms": list(stats["decode_ms"]),
           "prefill_ms": list(stats["prefill_ms"])}
    run["tokens_s"] = sum(len(o) for o in outs) / wall
    run["step_ms_median"] = _percentile(run["step_ms"], 50)
    return run


def _same_bits(a: dict, b: dict, what: str) -> None:
    """Two pooled runs: the same tokens and logits bits, request by
    request."""
    import numpy as np
    if a["outs"] != b["outs"]:
        fail(f"batcher {what}: tokens {a['outs']} differ from {b['outs']}")
    for i, (ha, hb) in enumerate(zip(a["handles"], b["handles"])):
        if len(ha.logits) != len(hb.logits) or not all(
                np.array_equal(x, y) for x, y in zip(ha.logits, hb.logits)):
            fail(f"batcher {what}: request {i}'s logits differ")


def _solo_check(run: dict, prompts, label: str) -> list:
    """Every request of a pooled run against its solo reference, tokens
    and logits bits; returns the references."""
    import numpy as np
    refs = []
    for i, (p, h, out) in enumerate(zip(prompts, run["handles"],
                                        run["outs"])):
        toks, rows = run["cb"].generate_reference(
            p, max_new_tokens=BATCH_GEN, record_logits=True)
        refs.append((toks, np.stack(rows)))
        if out != toks:
            first = next(j for j, (a, b) in enumerate(zip(out, toks))
                         if a != b)
            fail(f"batcher ({label}): request {i} (prompt {len(p)}) differs "
                 f"from its solo reference at token {first}: {out} vs "
                 f"{toks}")
        if not all(np.array_equal(a, b) for a, b in zip(h.logits, rows)):
            diff = float(np.abs(np.stack(h.logits) - refs[-1][1]).max())
            fail(f"batcher ({label}): request {i} logits differ from its "
                 f"solo reference (max-abs {diff})")
    return refs


def batcher_phase(args, packs, cfg) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.codr_matmul import ops
    from repro_torch.launch.serve import run_serve_continuous

    rng = np.random.default_rng(args.seed + 5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in BATCH_LENS]
    bits = packs.params["stack"]["b0"]["mixer"]["q_proj"][0].weight.bits
    per_forward = 7 * cfg.n_layers
    say(f"batcher: {cfg.name} at full width from the serve path's packs "
        f"({bits}-bit); n_slots 4, max_len 96, prompts {BATCH_LENS}, "
        f"max_new_tokens {BATCH_GEN}; the pooled step replays a CUDA graph "
        f"captured over the pool (eager runs beside it for the bits)")

    # the main path: the dense pool, captured
    ops.launches = ops.captured = 0
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
    with _kept_graphs():
        main = _batcher_run(packs, cfg, prompts, ops, eager=False)
    launches, by_impl = ops.launches, dict(ops.launches_by_impl)
    captured = ops.captured
    cb = main["cb"]
    pre, dec = main["prefill"], main["decode"]
    graph = cb._graph
    say(f"batcher pooled run (dense, captured): "
        f"{sum(len(o) for o in main['outs'])} tokens in "
        f"{main['wall_s'] * 1e3:.3f} ms ({main['tokens_s']:.3f} tokens/s); "
        f"steps_run {cb.steps_run}, prefills_run {cb.prefills_run}, "
        f"peak_active {cb.peak_active}; pooled step median "
        f"{main['step_ms_median']:.3f} ms (min {min(main['step_ms']):.3f}, "
        f"max {max(main['step_ms']):.3f}; the first holds the warm-up step "
        f"and the capture); prefill ms in admission order "
        f"{[round(t, 3) for t in main['prefill_ms']]} [{SMI}]")
    want_pre = dict.fromkeys(ops.IMPLS, 0)
    for n in BATCH_LENS:
        want_pre[ops.pick_impl(n, bits)] += per_forward
    want_dec = dict.fromkeys(ops.IMPLS, 0)
    want_dec[ops.pick_impl(4, bits)] += per_forward
    say(f"batcher codr_matmul launches counted: prefill {pre}, decode {dec} "
        f"(the warm-up step), in all {launches}; routing predicts "
        f"{want_pre} / {want_dec}; {captured} calls recorded at the "
        f"capture; {graph.replays} replays, which call no wrapper (the "
        f"graph's kernel nodes are counted below)")
    if (pre != want_pre or dec != want_dec or graph.captures != 1
            or captured != per_forward or graph.replays != cb.steps_run
            or launches != per_forward * (len(BATCH_LENS) + 1)):
        fail(f"batcher: codr_matmul launches {pre} / {dec} (captures "
             f"{graph.captures} recording {captured} calls, replays "
             f"{graph.replays}, steps {cb.steps_run}) differ from the "
             f"routing rule's {want_pre} / {want_dec}")
    if cb.prefills_run != 6 or cb.peak_active != 4 or any(
            len(o) != BATCH_GEN for o in main["outs"]):
        fail(f"batcher: prefills {cb.prefills_run}, peak_active "
             f"{cb.peak_active}, lengths {[len(o) for o in main['outs']]}")

    # every pool eager and captured: the same bits; each against its solo
    # references; bf16 paged == dense; int8 within 0.10 of the spread
    runs = {"dense": {"captured": main,
                      "eager": _batcher_run(packs, cfg, prompts, ops,
                                            eager=True)}}
    for label, kv in POOLS.items():
        if label != "dense":
            runs[label] = {mode: _batcher_run(packs, cfg, prompts, ops,
                                              eager=mode == "eager", **kv)
                           for mode in ("eager", "captured")}
        _same_bits(runs[label]["eager"], runs[label]["captured"],
                   f"{label}: eager vs captured")
    lanes = {label: {mode: {"tokens_s": r["tokens_s"],
                            "step_ms_median": r["step_ms_median"],
                            "steps_run": r["cb"].steps_run,
                            "step_ms": r["step_ms"]}
                     for mode, r in pair.items()}
             for label, pair in runs.items()}
    for label, pair in lanes.items():
        say(f"batcher {label} pool: eager step median "
            f"{pair['eager']['step_ms_median']:.3f} ms, "
            f"{pair['eager']['tokens_s']:.3f} tokens/s; captured step "
            f"median {pair['captured']['step_ms_median']:.3f} ms, "
            f"{pair['captured']['tokens_s']:.3f} tokens/s; eager and "
            f"captured equal bit for bit [{SMI}]")
    ref_rows = _solo_check(main, prompts, "dense, captured")
    _solo_check(runs["int8 paged"]["captured"], prompts, "int8 paged, "
                "captured")
    _same_bits(runs["bf16 paged"]["captured"], main, "bf16 paged vs dense")
    say("batcher: all 6 requests equal their solo references, tokens and "
        "logits bit for bit (dense and int8 paged pools, captured); the bf16 "
        "paged pool equals the dense pool bit for bit")

    # where a pooled step's time goes: eager on a 4-slot pool with
    # per-slot positions (dense, int8-paged), and the dense batcher's
    # captured step replayed (its slots are all free by now)
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import get_model
    api = get_model(cfg)
    tvec = torch.tensor([11, 22, 33, 44], device="cuda")
    pvec = torch.tensor([10, 20, 30, 40], device="cuda")
    profs = {}
    for label, spec in (("dense", None), ("int8 paged", cache_mod.PagedSpec(
            page_size=16, max_len=96, n_slots=4, kv_dtype="int8"))):
        pool = api.init_cache(cfg, 4, 96, paged=spec)
        if spec is not None:
            cache_mod.set_tables(pool, 1 + np.arange(24).reshape(4, 6))
        for _ in range(2):
            api.decode_step(packs.params, pool, tvec, pvec, cfg)
        torch.cuda.synchronize()
        profs[label] = _profile(lambda: api.decode_step(
            packs.params, pool, tvec, pvec, cfg), "codr_matmul",
            MM_KERNEL_NAMES)
        _say_profile(f"batcher profile, one pooled step ({label} pool, "
                     f"eager)", profs[label], "codr_matmul")
        del pool
    profs["dense replayed"] = _profile(lambda: graph(tvec, pvec),
                                       "codr_matmul", MM_KERNEL_NAMES)
    _say_profile(f"batcher profile, one pooled step (dense pool, replayed) "
                 f"[{SMI}]", profs["dense replayed"], "codr_matmul")
    in_graph = _graph_kernels(graph.graph, MM_KERNEL_NAMES)
    recorded = profs["dense replayed"]["codr_matmul_launches"]
    say(f"batcher: the pooled step's graph holds {in_graph} codr_matmul "
        f"kernels ({per_forward} expected); the profiler recorded "
        f"{recorded} in the replay")
    if in_graph != per_forward or not 0 < recorded <= per_forward:
        fail(f"batcher: the pooled step's graph holds {in_graph} codr_matmul "
             f"kernels and the profiler recorded {recorded} in one replay, "
             f"expected {per_forward}")

    # int8 paged pool, teacher-forced through the dense tokens
    int8 = runs["int8 paged"]["captured"]["cb"]
    devs = []
    for i, (p, (toks, rows)) in enumerate(zip(prompts, ref_rows)):
        got = int8.replay_logits(p, toks)
        if not np.array_equal(got[0], rows[0]):
            fail(f"batcher: int8 prefill row of request {i} is not bit-exact")
        spread = float(rows.max() - rows.min()) or 1.0
        devs.append(float(np.abs(got - rows).max()) / spread)
    kv = {"dense_bf16": cb.kv_bytes(),
          "paged_bf16": runs["bf16 paged"]["captured"]["cb"].kv_bytes(),
          "paged_int8": int8.kv_bytes()}
    say(f"batcher: int8 paged teacher-forced deviation per request "
        f"{[round(d, 5) for d in devs]} of the dense logit spread (bound "
        f"0.10); kv_bytes {kv}")
    if not max(devs) < 0.10:
        fail(f"batcher: int8 deviation {max(devs)} >= 0.10 of the spread")

    t0 = time.perf_counter()
    small = run_serve_continuous(check=True, use_codr=True)
    say(f"batcher: run_serve_continuous(check=True) at its smoke size on "
        f"the card: {small['checked']}/{small['n_requests']} checked, "
        f"{time.perf_counter() - t0:.2f} s")
    if small["checked"] != small["n_requests"]:
        fail("run_serve_continuous(check=True) checked too few requests")
    chaos = chaos_phase(packs, cfg, prompts, main)
    for pair in runs.values():
        for r in pair.values():
            r["cb"]._graph = None          # free the graphs' memory
    return {"launches": launches, "launches_by_impl": by_impl,
            "prefill_launches_by_impl": pre, "decode_launches_by_impl": dec,
            "captured_calls": captured, "replays": graph.replays,
            "tokens_s": main["tokens_s"], "wall_ms": main["wall_s"] * 1e3,
            "step_ms_median": main["step_ms_median"],
            "step_ms": main["step_ms"], "prefill_ms": main["prefill_ms"],
            "steps_run": cb.steps_run, "prefills_run": cb.prefills_run,
            "peak_active": cb.peak_active, "lanes": lanes,
            "kv_bytes": kv, "int8_deviation": devs, "profile": profs,
            "chaos": chaos}


def chaos_phase(packs, cfg, prompts, clean: dict) -> dict:
    """The dense pool's captured run again under a seeded fault plan over
    the batcher's three sites (transient errors at prefill and decode, a
    worker crash, latency), retry and restart budgets sized to the plan:
    every output must equal the clean run's, tokens and logits bits."""
    from repro_torch.core.batching import ContinuousBatcher
    from repro_torch.runtime import resilience as res
    plan = res.FaultPlan.seeded(
        0, (res.SITE_BATCHER_WORKER, res.SITE_BATCHER_PREFILL,
            res.SITE_BATCHER_DECODE),
        n_faults=12, max_call=8, latency_s=0.002)
    cb = ContinuousBatcher(packs, cfg, n_slots=4, max_len=96,
                           record_logits=True)
    injector = res.FaultInjector(plan)
    cb.configure_resilience(
        injector=injector,
        retry_policy=res.RetryPolicy(max_retries=max(2, len(plan)),
                                     backoff_s=0.001),
        restart_policy=res.RestartPolicy(max_restarts=max(1, len(plan)),
                                         backoff_s=0.001))
    t0 = time.perf_counter()
    handles, outs = _pooled_run(cb, prompts)
    wall = time.perf_counter() - t0
    cb.stop_async()
    run = {"handles": handles, "outs": outs}
    _same_bits(run, clean, "chaos vs clean")
    fired = [f"{f.site}#{f.at_call}:{f.kind}" for f in injector.fired]
    kinds = {f.kind for f in injector.fired}
    say(f"chaos: FaultPlan.seeded(0, batcher sites, n_faults=12, "
        f"max_call=8): {len(injector.fired)}/{len(plan)} faults fired "
        f"{fired}; worker crashes {cb.worker_crashes}, restarts "
        f"{cb.worker_restarts}; {sum(len(o) for o in outs)} tokens in "
        f"{wall * 1e3:.3f} ms; every output equals the clean run's, tokens "
        f"and logits bit for bit")
    if (len(injector.fired) != len(plan) or not {"error", "crash"} <= kinds
            or cb.worker_restarts != cb.worker_crashes
            or cb.worker_crashes < 1):
        fail(f"chaos: fired {fired}, crashes {cb.worker_crashes}, restarts "
             f"{cb.worker_restarts}")
    return {"plan": plan.describe(), "fired": fired,
            "worker_crashes": cb.worker_crashes,
            "worker_restarts": cb.worker_restarts, "wall_ms": wall * 1e3}


def checkpoint_phase(args, packs, cfg) -> dict:
    """The full-width packs through ``save_packed`` into a temporary
    directory and back with ``load_packed(mmap=True)`` onto the card:
    the same packed bytes, and teacher-forced logits bit for bit.  Then
    ``run_serve_continuous(check=True, chaos_seed=0, packed_ckpt=...)``
    at its smoke size (the serving CLI's path).  The directory is
    deleted afterwards."""
    import shutil
    import tempfile

    import torch

    import repro_torch.api as codr
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import run_serve_continuous
    from repro_torch.models import get_model

    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen,
                           device="cuda")
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=_build.BUILD_DIR)
    try:
        path = os.path.join(tmp, "qwen2.5-3b.codr")
        t0 = time.perf_counter()
        codr.save_packed(packs, path)
        save_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = codr.load_packed(path, mmap=True)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        for (pa, a), (pb, b) in zip(packs.packed_leaves(),
                                    loaded.packed_leaves()):
            if pa != pb or not all(torch.equal(x, y) for x, y in zip(
                    (a.weight.packed, a.weight.table, a.weight.scale),
                    (b.weight.packed, b.weight.table, b.weight.scale))):
                fail(f"checkpoint: {pa} did not round-trip byte for byte")
        want = _teacher_forced(api, packs.params, cfg, tokens,
                               torch.bfloat16, steps=6)
        got = _teacher_forced(api, loaded.params, cfg, tokens,
                              torch.bfloat16, steps=6)
        for i, (a, b) in enumerate(zip(want, got)):
            if not torch.equal(a, b):
                fail(f"checkpoint: logits {i} differ after the round trip")
        del loaded, want, got
        torch.cuda.empty_cache()
        say(f"checkpoint: save_packed of the full-width packs {save_s:.3f} "
            f"s, {n_bytes} bytes on disk in {len(os.listdir(path))} files; "
            f"load_packed(mmap=True) onto the card {boot_s:.3f} s; every "
            f"pack byte for byte, prefill + 6 teacher-forced decode steps "
            f"bit for bit [{SMI}]")
        t0 = time.perf_counter()
        small = run_serve_continuous(check=True, chaos_seed=0,
                                     packed_ckpt=os.path.join(
                                         tmp, "smoke.codr"), verbose=False)
        say(f"checkpoint: run_serve_continuous(check=True, chaos_seed=0, "
            f"packed_ckpt=...) at its smoke size: {small['checked']}/"
            f"{small['n_requests']} checked, kv {small['kv_dtype']}, "
            f"{small['faults_fired']} faults fired, "
            f"{time.perf_counter() - t0:.2f} s")
        if small["checked"] != small["n_requests"]:
            fail("packed + chaos run_serve_continuous checked too few")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        fail(f"checkpoint: {tmp} was not deleted")
    return {"save_s": save_s, "boot_s": boot_s, "bytes_on_disk": n_bytes}


# ---------------------------------------------------------------------------
# phase 6: the per-layer encoding search (repro_torch.tune) on the card
# ---------------------------------------------------------------------------

TUNE_CNN_LAYERS = 4     # VGG16's tuned layers, cut from cnn_path's 7
TUNE_CLI_CONV = 2       # the tune CLI's defaults run, cut from 3 conv layers
# the transformer lane's U grid (tune_params' default) and run_serve's
# loop, cut to 8 new tokens
TUNE_US = (4, 8, 16, 32, 64)
TUNE_BATCH, TUNE_PROMPT, TUNE_GEN = 4, 32, 8


def _requests(compiled, images) -> list:
    """``compiled.run`` on each image batch: ``[(output, ms)]``."""
    import torch
    out = []
    for x in images:
        t0 = time.perf_counter()
        y = compiled.run(x)
        torch.cuda.synchronize()
        out.append((y, (time.perf_counter() - t0) * 1e3))
    return out


def _pick_budget(rel: dict) -> float:
    """A ``max_rel_err`` from the per-leaf table ``rel[U][path]`` under
    which ``tune_params``' pick (the smallest U within the budget, else
    the least lossy) mixes the most bit widths, the smallest such budget
    (the least error) first: midpoints between neighbouring table
    values, so no leaf sits at the budget's edge.  0.2 (the budget of
    ``tests/test_tune.py``) when no budget mixes widths."""
    from repro_torch.core.codr_linear import choose_bits
    us = sorted(rel)
    values = sorted({v for col in rel.values() for v in col.values()})
    best = None
    for lo, hi in zip(values, values[1:]):
        b = (lo + hi) / 2
        widths = set()
        for p in rel[us[0]]:
            fit = [u for u in us if rel[u][p] <= b]
            widths.add(choose_bits(fit[0] if fit else
                                   min(us, key=lambda u: rel[u][p])))
        if len(widths) > 1 and (best is None or len(widths) > best[0]):
            best = (len(widths), b)
    return 0.2 if best is None else best[1]


def tune_phase(args, cnn_row: dict, packs) -> tuple:
    """The per-layer encoding search through the entry points a user
    calls, on the card: (a) VGG16 conv1_1..conv2_2 tuned with
    ``tune_spec`` against the best global config, both compiled on
    ``smm_kernel``; (b) the CLI gate ``repro_torch.launch.tune --small
    --check``, then ``run_tune`` at the CLI's defaults;
    (c) qwen2.5-3b at its published widths tuned with ``tune_params``,
    compiled on ``codr_matmul`` and served by ``run_serve``'s loop, its
    packed checkpoint booted.  Returns the phase's parts of the
    ``smm_conv`` and ``codr_matmul`` rows."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    import torch

    import repro_torch.api as codr
    from repro_torch import tune
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_cnns import VGG16
    from repro_torch.core.backends import _int_activations
    from repro_torch.core.engine import full_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels.codr_matmul import ops as mm_ops
    from repro_torch.kernels.smm_conv import ops, ref
    from repro_torch.launch import tune as tune_cli
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import get_model

    # -- (a) the CNN lane: the paper's search on cnn_path's spec ------------
    hw, batch = (226, 226), 4
    # conv1_1 .. conv2_2: cnn_path's first TUNE_CNN_LAYERS layers (the
    # host search of conv3_x is most of the seven layers' search time)
    spec = codr.ModelSpec.from_shapes(VGG16[:TUNE_CNN_LAYERS], None,
                                      density=0.4,
                                      rng=np.random.default_rng(args.seed))
    budget = tune.TuneBudget(max_rel_err=0.03)
    grid = tune.TuneGrid(max_vectors=2000)
    tune.clear_cache()
    t0 = time.perf_counter()
    plan = tune.tune_spec(spec, hw, budget=budget, grid=grid)
    search_s = time.perf_counter() - t0
    table = tune.layer_candidate_table(spec, hw, grid=grid)
    gcfg, gpred = tune.best_global_config(table, budget=budget, grid=grid)
    say(f"tune cnn: VGG16 conv1_1..conv2_2 (cnn_path's first "
        f"{TUNE_CNN_LAYERS} layers, seed "
        f"{args.seed}), input {hw}, budget {budget.as_dict()}, grid "
        f"max_vectors {grid.max_vectors}: search {search_s:.2f} s on the "
        f"host ({len(plan)} layers x {len(grid.n_uniques)} U x "
        f"{len(grid.t_ms_conv)} t_m; cache {tune.cache_stats()}); best "
        f"global config {gcfg.metadata()}")
    say(plan.table())
    t0 = time.perf_counter()
    tuned = codr.compile(spec, plan=plan, backend="smm_kernel",
                         device="cuda")
    glob = codr.compile(spec, gcfg, backend="smm_kernel", device="cuda")
    encode_s = time.perf_counter() - t0
    say(tuned.layer_table(hw))
    img_rng = np.random.default_rng(args.seed + 1)
    images = [img_rng.integers(0, 256, size=(batch, *hw, 3)).astype(
        np.float32) for _ in range(3)]
    rules = {"tuned": _smm_rule(tuned, batch, hw),
             "global": _smm_rule(glob, batch, hw)}
    ops.launches = 0
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
    runs = {"tuned": _requests(tuned, images),
            "global": _requests(glob, images)}
    cnn_launches, cnn_by_impl = ops.launches, dict(ops.launches_by_impl)
    want = collections.Counter(r for rule in rules.values() for r in rule)
    want = {i: want[i] * len(images) for i in ops.IMPLS}
    say(f"tune cnn smm_conv launches {cnn_launches}, by instance "
        f"{cnn_by_impl}; the rule names per request {rules}")
    if cnn_launches != 2 * len(spec) * len(images) or cnn_by_impl != want:
        fail(f"tune cnn: smm_conv launched {cnn_launches} / {cnn_by_impl}, "
             f"the routing rule gives {want}")
    # VALID 3x3 convolutions at stride 1: 2 rows and columns a layer
    out_shape = (batch, hw[0] - 2 * len(spec), hw[1] - 2 * len(spec),
                 VGG16[TUNE_CNN_LAYERS - 1].m)
    for name, run in runs.items():
        for y, _ in run:
            if tuple(y.shape) != out_shape or \
                    not bool(torch.isfinite(y).all()):
                fail(f"tune cnn {name}: output {tuple(y.shape)} not "
                     f"{out_shape} or not finite")
    # every tuned layer's call on request 0 against the plain version
    x = tuned.model.as_input(images[0])
    ri, ci = hw
    layers = []
    for layer, impl in zip(tuned.model.layers, rules["tuned"]):
        deltas, entries, meta = layer.smm_operands()
        ro, co = layer.out_hw(ri, ci)
        xi, _ = _int_activations(x)
        xin = xi.permute(0, 3, 1, 2).contiguous()
        kw = dict(t_m=meta["t_m"], ro=ro, co=co, stride=layer.stride)
        err = float((ops.smm_conv_cuda(xin, deltas, entries,
                                       int8_weights=meta["int8_weights"],
                                       **kw)
                     - ref.smm_conv_plain(xin, deltas, entries, **kw)
                     ).abs().max())
        st = layer.stats()
        layers.append({"layer": layer.name, "impl": impl,
                       "n_unique": st.n_unique_budget, "t_m": meta["t_m"],
                       "deltas": list(deltas.shape), "max_abs_err": err})
        if err != 0.0:
            fail(f"tune cnn {layer.name} (U {st.n_unique_budget}, t_m "
                 f"{meta['t_m']}): {impl} vs plain max-abs-diff {err}")
        x = tuned.backend.conv(layer, x)
        ri, ci = ro, co
    if not torch.equal(x, runs["tuned"][0][0]):
        fail("tune cnn: layer-by-layer replay differs from the request")
    say("tune cnn per layer [layer, instance, U, t_m, deltas shape, "
        "max-abs-diff vs plain]: " + "; ".join(
            f"{r['layer']} {r['impl']} U{r['n_unique']} t_m {r['t_m']} "
            f"{r['deltas']} {r['max_abs_err']}" for r in layers))
    y_tiled = tuned.run(images[0], backend="tiled")
    rel_tiled = float((runs["tuned"][0][0] - y_tiled).abs().max()) / float(
        y_tiled.abs().max())
    if not rel_tiled <= E2E_REL_TOL:
        fail(f"tune cnn: smm_kernel vs tiled rel err {rel_tiled} > "
             f"{E2E_REL_TOL}")
    if not plan.predicted_total_sram() <= gpred["sram"]:
        fail(f"tune cnn: plan's predicted SRAM "
             f"{plan.predicted_total_sram()} > global {gpred['sram']}")
    steady = {name: [ms for _, ms in run[1:]] for name, run in runs.items()}
    u16 = cnn_row["main_path"]["request_ms"][1:]
    cnn = {"launches": cnn_launches, "launches_by_impl": cnn_by_impl,
           "search_s": search_s, "encode_s": encode_s,
           "global_config": gcfg.metadata(), "layers": layers,
           "bits_per_weight": {"tuned": tuned.bits_per_weight(),
                               "global": glob.bits_per_weight(),
                               "tuned_pred": plan.predicted_bits_per_weight(),
                               "global_pred": gpred["bits_per_weight"]},
           "pred_sram": {"tuned": plan.predicted_total_sram(),
                         "global": gpred["sram"]},
           "request_ms": {name: [ms for _, ms in run]
                          for name, run in runs.items()},
           "smm_vs_tiled_rel_err": rel_tiled}
    say(f"tune cnn: bits/weight tuned {cnn['bits_per_weight']['tuned']:.4f} "
        f"(pred {cnn['bits_per_weight']['tuned_pred']:.4f}), global "
        f"{cnn['bits_per_weight']['global']:.4f} (pred "
        f"{cnn['bits_per_weight']['global_pred']:.4f}); predicted SRAM tuned "
        f"{plan.predicted_total_sram():.6e} <= global {gpred['sram']:.6e}; "
        f"smm_kernel vs tiled rel err {rel_tiled:.6f} (tolerance "
        f"{E2E_REL_TOL}); "
        f"encode of both {encode_s:.2f} s; steady request ms (batch {batch}) "
        f"tuned {steady['tuned']}, global {steady['global']}, cnn_path's "
        f"7 layers at U 16 {u16} [{SMI}]")
    del tuned, glob, runs, x, y_tiled
    torch.cuda.empty_cache()

    # -- (b) the CLI on the card: the reference's CI gate (--small
    # --check), then its defaults cut from 3 conv layers to
    # TUNE_CLI_CONV (28x28; at 3 layers the reference's own top-1
    # condition fails, tuned 0.9375 < global 0.96875 on the CPU, both
    # packages alike): bits/weight and predicted SRAM are held, and the
    # top-1 condition is printed
    t0 = time.perf_counter()
    try:
        tune_cli.main(["--small", "--check"])
    except AssertionError as e:
        fail(f"tune --small --check: {e}")
    cnn["cli_s"] = time.perf_counter() - t0
    res = tune_cli.run_tune(n_conv=TUNE_CLI_CONV, input_hw=(28, 28),
                            verbose=False)
    t, g = res["tuned"], res["global"]
    if t["bits_per_weight"] > g["bits_per_weight"] or \
            t["predicted_sram"] > g["predicted_sram"]:
        fail(f"tune cli defaults: tuned {t} worse than global {g}")
    try:
        tune_cli.check_result(res)
        verdict = "passes"
    except AssertionError as e:
        verdict = f"fails, as the reference's does at these defaults: {e}"
    cnn["cli_defaults"] = {"tuned": t, "global": g, "check": verdict}
    say(f"tune cli: python -m repro_torch.launch.tune --small --check "
        f"passed in {cnn['cli_s']:.2f} s; at the defaults cut to "
        f"{TUNE_CLI_CONV} conv layers (28x28) "
        f"bits/weight tuned {t['bits_per_weight']:.6f} <= global "
        f"{g['bits_per_weight']:.6f}, predicted SRAM "
        f"{t['predicted_sram']:.1f} <= {g['predicted_sram']:.1f}, top-1 "
        f"{t['top1_match']} vs {g['top1_match']}; --check {verdict}")

    # -- (c) the transformer lane: qwen2.5-3b at its published widths ------
    cfg = get_config("qwen2.5-3b")
    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = api.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (TUNE_BATCH, TUNE_PROMPT),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rel = {u: {p: lp.rel_err for p, lp in tune.tune_params(
        params, n_uniques=(u,), budget=tune.TuneBudget(max_rel_err=None)
    ).layers.items()} for u in TUNE_US}
    table_s = time.perf_counter() - t0
    paths = list(rel[TUNE_US[0]])
    say(f"tune lm: {cfg.name} at its published widths (seed {args.seed}); "
        f"per-leaf rel_err at U {TUNE_US} ({table_s:.2f} s): " + "; ".join(
            f"{p.split('/')[-1]} " + " ".join(f"{rel[u][p]:.5f}"
                                              for u in TUNE_US)
            for p in paths))
    max_rel_err = _pick_budget(rel)
    t0 = time.perf_counter()
    lm_plan = tune.tune_params(params, n_uniques=TUNE_US,
                               budget=tune.TuneBudget(
                                   max_rel_err=max_rel_err))
    lm_search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp = codr.compile_params(params, codr.EncodeConfig(n_unique=16),
                             plan=lm_plan, backend="codr_matmul",
                             accounting=False, device="cuda")
    torch.cuda.synchronize()
    lm_encode_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    leaf_bits = {p: leaf.weight.bits for p, leaf in cp.packed_leaves()}
    per_bits = collections.Counter(leaf_bits[p] for p in lm_plan.layers)
    say(f"tune lm: max_rel_err {max_rel_err!r} (chosen from the table: the "
        f"most bit widths, then the least error); tune_params {lm_search_s:.2f}"
        f" s, compile_params {lm_encode_s:.2f} s; plan U "
        f"{ {p.split('/')[-1]: lp.config.n_unique for p, lp in lm_plan.layers.items()} }; "
        f"projection leaves per bit width {dict(sorted(per_bits.items()))}, "
        f"embedding {leaf_bits.get('embed')} bits (unnamed leaves at U 16); "
        f"packed {cp.hbm_bytes()} bytes vs the flat U 16 compile "
        f"{packs.hbm_bytes()} ({cp.hbm_bytes() / packs.hbm_bytes():.4f}x), "
        f"{cp.bits_per_weight():.4f} vs {packs.bits_per_weight():.4f} "
        f"bits/weight")
    if len(per_bits) < 2:
        fail(f"tune lm: the plan has one bit width ({dict(per_bits)}) at "
             f"max_rel_err {max_rel_err}")
    per_forward = 7 * cfg.n_layers
    want_bits = dict.fromkeys(mm_ops.BITS, 0)
    for p in lm_plan.layers:
        want_bits[leaf_bits[p]] += 2 * cfg.n_layers   # prefill + warm-up
    mm_ops.launches = mm_ops.captured = 0
    mm_ops.launches_by_impl.update(dict.fromkeys(mm_ops.IMPLS, 0))
    mm_ops.launches_by_bits.update(dict.fromkeys(mm_ops.BITS, 0))
    t0 = time.perf_counter()
    logits, _ = api.prefill(cp.params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, _, n_steps = greedy_decode(api, cp.params, tokens, cfg, TUNE_GEN)
    torch.cuda.synchronize()
    lm = {"launches": mm_ops.launches,
          "launches_by_impl": dict(mm_ops.launches_by_impl),
          "launches_by_bits": {b: n for b, n in
                               mm_ops.launches_by_bits.items() if n},
          "captured": mm_ops.captured}
    want_impl = dict.fromkeys(mm_ops.IMPLS, 0)
    for p in lm_plan.layers:
        for m in (TUNE_BATCH * TUNE_PROMPT, TUNE_BATCH):
            want_impl[mm_ops.pick_impl(m, leaf_bits[p])] += cfg.n_layers
    say(f"tune lm main path: prefill {prefill_ms:.3f} ms, {n_steps} decode "
        f"steps; codr_matmul launches {lm['launches']} by instance "
        f"{lm['launches_by_impl']} (the rule gives {want_impl}), by bits "
        f"{lm['launches_by_bits']}; {lm['captured']} recorded at the "
        f"capture")
    if lm["launches"] != 2 * per_forward or lm["captured"] != per_forward \
            or lm["launches_by_impl"] != want_impl \
            or lm["launches_by_bits"] != {b: n for b, n in want_bits.items()
                                          if n}:
        fail(f"tune lm: codr_matmul counts {lm}, expected {2 * per_forward} "
             f"launches as {want_impl} / {want_bits} and {per_forward} "
             f"captured")
    if tuple(logits.shape) != (TUNE_BATCH, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()) or \
            tuple(out.shape) != (TUNE_BATCH, TUNE_GEN):
        fail(f"tune lm: logits {tuple(logits.shape)} / tokens "
             f"{tuple(out.shape)} malformed or not finite")
    out_eager, _, _ = greedy_decode(api, cp.params, tokens, cfg, TUNE_GEN,
                                    eager=True)
    if not torch.equal(out, out_eager):
        fail("tune lm: the replayed loop's tokens differ from the eager's")
    eager, _ = _step_logits(api, cp.params, tokens, cfg, TUNE_GEN,
                            captured=False)
    replay, _ = _step_logits(api, cp.params, tokens, cfg, TUNE_GEN,
                             captured=True)
    for i, (a, b) in enumerate(zip(eager, replay)):
        if not torch.equal(a, b):
            fail(f"tune lm: decode step {i}: replayed logits differ from "
                 f"eager")
    del eager, replay
    lm["profile"] = _profile_replay(api, cp.params, cfg, tokens, TUNE_GEN,
                                    per_forward, label="tune lm")
    tiled = _rebind(cp.params, "tiled")
    with full_fp32():
        f32 = {lane: _teacher_forced(api, p, cfg, tokens, torch.float32)
               for lane, p in (("codr_matmul", cp.params),
                               ("tiled", tiled))}
    lane_err = 0.0
    for i, (a, b) in enumerate(zip(f32["codr_matmul"], f32["tiled"])):
        what = "prefill" if i == 0 else f"decode step {i - 1}"
        lane_err = max(lane_err, _lane_check(a, b, f"tune lm {what} "
                                                   f"(float32)"))
    del f32, tiled
    # the packed checkpoint keeps the plan and boots to the same bits
    tmp = tempfile.mkdtemp(prefix="tune-", dir=_build.BUILD_DIR)
    try:
        path = os.path.join(tmp, "qwen2.5-3b-tuned.codr")
        codr.save_packed(cp, path)
        loaded = codr.load_packed(path, mmap=True)
        if loaded.plan is None or loaded.plan.to_json() != lm_plan.to_json():
            fail("tune lm: the checkpoint's plan differs from the plan saved")
        want_lg = _teacher_forced(api, cp.params, cfg, tokens,
                                  torch.bfloat16)
        got_lg = _teacher_forced(api, loaded.params, cfg, tokens,
                                 torch.bfloat16)
        for i, (a, b) in enumerate(zip(want_lg, got_lg)):
            if not torch.equal(a, b):
                fail(f"tune lm: logits {i} differ after the checkpoint")
        del loaded, want_lg, got_lg
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        fail(f"tune lm: {tmp} was not deleted")
    lm.update(max_rel_err=max_rel_err, rel_err_table=rel,
              leaves_per_bits=dict(per_bits), prefill_ms=prefill_ms,
              packed_bytes=cp.hbm_bytes(), flat_u16_bytes=packs.hbm_bytes(),
              lane_vs_tiled_max_abs_err_f32=lane_err,
              ms_per_step=lm["profile"]["host_clock_ms_per_step"],
              search_s=lm_search_s, encode_s=lm_encode_s)
    say(f"tune lm: replayed == eager at all {n_steps} steps, float32 lane "
        f"vs tiled {lane_err:.6f}, checkpoint plan and logits bits equal; "
        f"{lm['ms_per_step']:.3f} ms/step replayed (batch {TUNE_BATCH}) "
        f"[{SMI}]")
    del cp
    torch.cuda.empty_cache()
    return cnn, lm


# ---------------------------------------------------------------------------
# phase 7: deepseek-v2-236b serving on codr_matmul (MLA, MoE, prologue)
# ---------------------------------------------------------------------------

# depth cut 60 -> 3: the dense prologue layer and two scanned MoE layers,
# so the stacked expert packs are sliced at a layer index >= 1
DS_LAYERS = 3
# codr_matmul calls a forward makes, by the code (models/attention.py,
# models/moe.py): per layer MLA's q_a, q_b, kv_a, kv_b and o projections
# plus the prologue's MLP or the MoE layer's shared experts (up, gate,
# down) in prefill; a decode step takes kv_b through dense_weight (the
# absorbed form), so 7 there.  The router and the routed experts are
# weights decoded on dispatch, no kernel
DS_PER_PREFILL = 8 * DS_LAYERS
DS_PER_STEP = 7 * DS_LAYERS
PHASE_BATCH_LENS = (5, 12, 17, 24)     # prompts of model_phase's batchers


def _peak(label: str, peaks: dict, phase: str = "deepseek") -> None:
    """Record and print the peak device memory since the last reset."""
    import torch
    peaks[label] = torch.cuda.max_memory_allocated()
    say(f"{phase} peak device memory, {label}: {peaks[label]} bytes")
    torch.cuda.reset_peak_memory_stats()


def _ds_shapes(params) -> dict:
    """``(K, N) -> [(name, PackedLinear)]`` of every projection shape the
    path sends through codr_matmul: the prologue layer's and layer 0 of
    the stack's."""
    layer0 = {}
    pro = params["prologue"][0]
    for name, pl in pro["mixer"].items():
        if name.endswith("_proj"):
            layer0[f"mla/{name}"] = pl
    for name, pl in pro["mlp"].items():
        layer0[f"prologue_mlp/{name}"] = pl
    for name, pl in params["stack"]["b0"]["mlp"]["shared"].items():
        layer0[f"shared/{name}"] = pl[0]
    return _named_shapes(layer0)


def _ds_calls(name: str, decode: bool) -> int:
    """How many codr_matmul calls of a forward use the projection
    ``name`` of :func:`_ds_shapes`: an MLA projection one a layer (but
    ``kv_b`` none in decode), the prologue's MLP once, the shared experts
    once a MoE layer."""
    if name.startswith("mla/"):
        return 0 if decode and name == "mla/kv_b_proj" else DS_LAYERS
    if name.startswith("shared/"):
        return DS_LAYERS - 1
    return 1


def _shape_rows(args, shapes, batch: int, prompt_len: int,
                label: str = "deepseek") -> list:
    """Each projection shape at M = batch and M = batch * prompt_len, L2
    flushed: the routed instance held to the plain version, and its ms
    beside the plain version's, ``torch.matmul`` bf16 on the dense weight
    and the bound."""
    import torch

    from repro_torch.core.engine import full_fp32
    from repro_torch.kernels.codr_matmul import ops, ref
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()
    xgen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    rows = []
    for (k, n), named in shapes.items():
        pl = named[0][1]
        w = pl.weight
        wd = pl.dense(torch.bfloat16)
        args_w = (w.packed, w.table, w.scale.reshape(-1))
        for m in (batch, batch * prompt_len):
            x = torch.randn(m, k, generator=xgen, device="cuda")
            routed = ops.pick_impl(m, w.bits)

            def call(x=x, args_w=args_w, n=w.shape[1], bits=w.bits):
                return ops.codr_matmul_cuda(x, *args_w, bits=bits, n=n)
            yk = call()
            with full_fp32():
                yp = ref.codr_matmul_ref(x, *args_w, bits=w.bits,
                                         n=w.shape[1])
            err = float((yk - yp).abs().max())
            rtol, atol = MM_F32
            if not bool(((yk - yp).abs() <= atol + rtol * yp.abs()).all()):
                fail(f"{label} codr_matmul [{routed}] {k}x{n} M={m}: "
                     f"kernel vs plain max-abs {err}")
            if not torch.equal(yk, call()):
                fail(f"{label} codr_matmul [{routed}] {k}x{n} M={m}: two "
                     f"calls differ")
            n_bytes = x.numel() * 4 + w.packed.numel() * 4 \
                + w.table.numel() * 4 + 4 + m * w.shape[1] * 4
            b_ms, b_by = bound(n_bytes, 2 * m * k * w.shape[1], BF16_FLOPS)
            xb = x.to(torch.bfloat16)
            with full_fp32():
                row = {"proj": " + ".join(name for name, _ in named),
                       "names": [name for name, _ in named],
                       "m": m, "k": k, "n": n, "bits": w.bits,
                       "impl": routed, "max_abs_err": err,
                       "ms": cold_ms(call, 20, flush),
                       "plain_ms": cold_ms(lambda: ref.codr_matmul_ref(
                           x, *args_w, bits=w.bits, n=w.shape[1]), 5,
                           flush),
                       "library_ms": cold_ms(lambda: torch.matmul(xb, wd),
                                             20, flush),
                       "bytes": n_bytes, "ops": 2 * m * k * w.shape[1],
                       "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            say(f"{label} codr_matmul {row['proj']} {k}x{n} M={m} "
                f"({w.bits}-bit): routed [{routed}] {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, torch.matmul bf16 "
                f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"max-abs-diff {err:.3e} [{SMI}]")
        del wd
    return rows


def _ds_batcher(packs, cfg, prompts, peaks) -> dict:
    """Four requests on the dense, bf16-paged and int8-paged pools, each
    captured and eager with the same bits; bf16 paged == dense and int8
    within 0.10 of the dense spread under teacher forcing (prefill rows
    exact).  Pooled == solo is held for qwen only, as in the reference."""
    import numpy as np
    import torch

    from repro_torch.kernels.codr_matmul import ops
    bits = packs.params["stack"]["b0"]["mixer"]["q_a_proj"][0].weight.bits
    runs, lanes = {}, {}
    for label, kv in POOLS.items():
        ops.launches = ops.captured = 0
        ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))
        pair = {mode: _batcher_run(packs, cfg, prompts, ops,
                                   eager=mode == "eager", **kv)
                for mode in ("captured", "eager")}
        _same_bits(pair["eager"], pair["captured"],
                   f"deepseek {label}: eager vs captured")
        cap = pair["captured"]
        graph = cap["cb"]._graph
        want_pre = dict.fromkeys(ops.IMPLS, 0)
        for n in PHASE_BATCH_LENS:
            want_pre[ops.pick_impl(n, bits)] += DS_PER_PREFILL
        want_dec = dict.fromkeys(ops.IMPLS, 0)
        want_dec[ops.pick_impl(4, bits)] += DS_PER_STEP
        if (cap["prefill"] != want_pre or cap["decode"] != want_dec
                or graph.captures != 1
                or graph.replays != cap["cb"].steps_run):
            fail(f"deepseek batcher {label}: codr_matmul launches "
                 f"{cap['prefill']} / {cap['decode']} (captures "
                 f"{graph.captures}, replays {graph.replays}, steps "
                 f"{cap['cb'].steps_run}), the routing rule predicts "
                 f"{want_pre} / {want_dec}")
        lanes[label] = {mode: {"tokens_s": r["tokens_s"],
                               "step_ms_median": r["step_ms_median"],
                               "steps_run": r["cb"].steps_run}
                        for mode, r in pair.items()}
        lanes[label]["launches_by_impl"] = {"prefill": cap["prefill"],
                                            "decode": cap["decode"]}
        say(f"deepseek batcher {label} pool: captured step median "
            f"{lanes[label]['captured']['step_ms_median']:.3f} ms, "
            f"{lanes[label]['captured']['tokens_s']:.3f} tokens/s; eager "
            f"step median {lanes[label]['eager']['step_ms_median']:.3f} ms; "
            f"eager and captured equal bit for bit; codr_matmul launches "
            f"prefill {cap['prefill']}, warm-up {cap['decode']} (routing "
            f"predicts {want_pre} / {want_dec}) [{SMI}]")
        for r in pair.values():
            r["cb"]._graph = None          # free the graph's memory pool
        runs[label] = cap["cb"]
        torch.cuda.empty_cache()
    _peak("batcher runs", peaks)
    # teacher-forced through the dense pool's tokens: bf16 paged == dense
    # bit for bit, int8 within 0.10 of the dense spread
    dense = runs["dense"]
    devs = []
    for i, p in enumerate(prompts):
        toks, _ = dense.generate_reference(p, max_new_tokens=BATCH_GEN)
        rows = dense.replay_logits(p, toks)
        if not np.array_equal(runs["bf16 paged"].replay_logits(p, toks),
                              rows):
            fail(f"deepseek batcher: bf16 paged logits of request {i} "
                 f"differ from the dense pool's")
        got = runs["int8 paged"].replay_logits(p, toks)
        if not np.array_equal(got[0], rows[0]):
            fail(f"deepseek batcher: int8 prefill row of request {i} is "
                 f"not bit-exact")
        spread = float(rows.max() - rows.min()) or 1.0
        devs.append(float(np.abs(got - rows).max()) / spread)
    kv = {label: cb.kv_bytes() for label, cb in runs.items()}
    say(f"deepseek batcher: bf16 paged == dense bit for bit over "
        f"replay_logits for all {len(prompts)} requests; int8 paged "
        f"teacher-forced deviation {[round(d, 5) for d in devs]} of the "
        f"dense spread (bound 0.10); kv_bytes {kv}")
    if not max(devs) < 0.10:
        fail(f"deepseek batcher: int8 deviation {max(devs)} >= 0.10")
    _peak("batcher checks", peaks)
    return {"lanes": lanes, "int8_deviation": devs, "kv_bytes": kv}


def deepseek_phase(args) -> dict:
    """deepseek-v2-236b at its published widths, depth cut to 3, served
    from 4-bit packs through the entry points a user calls
    (``model_phase``), with the new projection shapes' rows, one decode
    step's and one prefill's sums of them, and the batcher's three
    pools; returns the phase's part of the ``codr_matmul`` row."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DS_LAYERS)
    return model_phase(
        args, "deepseek", cfg,
        f"published widths (MLA q_lora {cfg.q_lora_rank} kv_lora "
        f"{cfg.kv_lora_rank}, {cfg.n_experts} routed experts top-"
        f"{cfg.moe_top_k} of width {cfg.moe_d_ff} + {cfg.n_shared_experts} "
        f"shared), depth 60 -> {DS_LAYERS} (the prologue and "
        f"{cfg.n_periods} MoE layers)", per_prefill=DS_PER_PREFILL,
        per_step=DS_PER_STEP, gen_len=32, shapes=_ds_shapes, calls=_ds_calls,
        profile=True, batcher=_ds_batcher, mesh=ds_mesh_check)


# ---------------------------------------------------------------------------
# phase 8: the other architectures on codr_matmul — jamba-v0.1-52b (mamba,
# attention and MoE in one period) at its published widths, xlstm-350m,
# seamless-m4t-medium and internvl2-26b's prefix; model_phase serves
# deepseek-v2-236b (phase 7) too
# ---------------------------------------------------------------------------

# codr_matmul calls a forward makes, by the code (models/ssm.py,
# models/attention.py, models/moe.py, models/encdec.py; the routers, the
# routed experts and sLSTM's r_proj are weights decoded on dispatch, no
# kernel):
# * jamba, one period: seven mamba layers (in, x, dt, out) and one GQA
#   layer (q, k, v, o), four dense MLPs (up, gate, down): 7·4 + 4 + 4·3;
# * xlstm, a period: mLSTM (up, q, k, v, if, out) and sLSTM (w, out);
# * seamless, prefill: an encoder layer q, k, v, o, up, down, a decoder
#   layer self q, k, v, o, cross q, k, v, o, up, down; a decode step
#   reuses the cross k / v: 8 a decoder layer;
# * internvl: q, k, v, o, up, gate, down a layer.
JAMBA_LAYERS = 8
JAMBA_PER_FORWARD = 7 * 4 + 4 + 4 * 3
XLSTM_PER_PERIOD = 8
SEAMLESS_PER_LAYER = {"enc": 6, "dec_prefill": 10, "dec_step": 8}
INTERNVL_LAYERS = 4


def _zero_counts(ops) -> None:
    ops.launches = ops.captured = 0
    ops.launches_by_impl.update(dict.fromkeys(ops.IMPLS, 0))


def _ssm_batcher(label, packs, cfg, prompts, peaks, *,
                 per_forward: int) -> dict:
    """Four requests through the batcher on the dense pool, captured and
    eager with the same bits, launches held to the routing rule; the
    paged pools refuse an SSM mixer, as in the reference."""
    from repro_torch.core.batching import ContinuousBatcher
    from repro_torch.kernels.codr_matmul import ops
    bits = next(leaf.weight.bits for _, leaf in packs.packed_leaves()
                if hasattr(leaf, "out_features"))
    _zero_counts(ops)
    pair = {mode: _batcher_run(packs, cfg, prompts, ops,
                               eager=mode == "eager")
            for mode in ("captured", "eager")}
    _same_bits(pair["eager"], pair["captured"],
               f"{label} dense: eager vs captured")
    cap = pair["captured"]
    graph = cap["cb"]._graph
    want_pre = dict.fromkeys(ops.IMPLS, 0)
    for n in PHASE_BATCH_LENS:
        want_pre[ops.pick_impl(n, bits)] += per_forward
    want_dec = dict.fromkeys(ops.IMPLS, 0)
    want_dec[ops.pick_impl(4, bits)] += per_forward
    if (cap["prefill"] != want_pre or cap["decode"] != want_dec
            or graph.captures != 1 or graph.replays != cap["cb"].steps_run):
        fail(f"{label} batcher: codr_matmul launches {cap['prefill']} / "
             f"{cap['decode']} (captures {graph.captures}, replays "
             f"{graph.replays}, steps {cap['cb'].steps_run}), the routing "
             f"rule predicts {want_pre} / {want_dec}")
    lanes = {mode: {"tokens_s": r["tokens_s"],
                    "step_ms_median": r["step_ms_median"],
                    "steps_run": r["cb"].steps_run}
             for mode, r in pair.items()}
    for r in pair.values():
        r["cb"]._graph = None              # free the graph's memory pool
    refused = []
    for kv in POOLS.values():
        if not kv:
            continue
        try:
            ContinuousBatcher(packs, cfg, n_slots=4, max_len=96, **kv)
        except NotImplementedError as e:
            refused.append(str(e).split(" — ")[0])
        else:
            fail(f"{label} batcher: a paged pool ({kv}) took an SSM mixer")
    say(f"{label} batcher dense pool: captured step median "
        f"{lanes['captured']['step_ms_median']:.3f} ms, "
        f"{lanes['captured']['tokens_s']:.3f} tokens/s; eager step median "
        f"{lanes['eager']['step_ms_median']:.3f} ms; eager and captured "
        f"equal bit for bit; codr_matmul launches prefill {cap['prefill']}, "
        f"warm-up {cap['decode']} (routing predicts {want_pre} / "
        f"{want_dec}); the paged pools refuse: {refused} [{SMI}]")
    _peak("batcher runs", peaks, label)
    return {"dense": lanes, "launches_by_impl": {"prefill": cap["prefill"],
                                                 "decode": cap["decode"]},
            "paged_refused": refused}


def _sums(label, rows, calls, batch: int, prompt_len: int, bits: int
          ) -> dict:
    """One decode step's and one prefill's sums of the per-shape rows,
    each shape weighted by the calls ``calls(name, decode)`` gives it."""
    from repro_torch.kernels.codr_matmul import ops
    keys = ("ms", "plain_ms", "library_ms", "bytes", "ops")
    fwd, pre = ({key: sum(r[key] * sum(calls(name, decode)
                                       for name in r["names"])
                          for r in rows if r["m"] == m)
                 for key in keys}
                for m, decode in ((batch, True), (batch * prompt_len, False)))
    b_ms, b_by = bound(fwd["bytes"], fwd["ops"], BF16_FLOPS)
    say(f"{label} codr_matmul one decode step (M={batch}, sums of the "
        f"per-shape rows): routed [{ops.pick_impl(batch, bits)}] "
        f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, torch.matmul "
        f"bf16 {fwd['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"prefill (M={batch * prompt_len}): routed "
        f"[{ops.pick_impl(batch * prompt_len, bits)}] {pre['ms']:.4f} ms, "
        f"plain {pre['plain_ms']:.4f} ms, torch.matmul bf16 "
        f"{pre['library_ms']:.4f} ms [{SMI}]")
    return {"per_step": {**fwd, "bound_ms": b_ms, "bound_by": b_by},
            "per_prefill_sums": pre}


def model_phase(args, label: str, cfg, cut: str, *, per_prefill: int,
                per_step: int, gen_len: int, shapes=None, calls=None,
                profile: bool = False, batcher=None, mesh=None) -> dict:
    """One architecture served from 4-bit packs through the entry points
    a user calls (``init_params`` → ``compile_params`` → ``prefill`` →
    ``greedy_decode`` or, for the encoder-decoder, ``pad_self_cache`` →
    ``encdec_decode``: ``run_serve``'s loops) at batch 4 and a prompt of
    32, with a random ``(4, frontend_seq, d_model)`` prefix where the
    model takes one.  Held: the codr_matmul launches to the counts the
    code gives and the routing rule (``per_prefill`` calls a prefill,
    ``per_step`` a step), the graph's kernel nodes to ``per_step``, the
    replayed loop to the eager loop bit for bit at every step, and the
    lane to ``tiled`` in float32.  ``shapes(params)`` names the
    projection shapes to time (``calls(name, decode)`` weights them into
    a step's and a prefill's sums); ``profile`` profiles a replayed
    window (decoder-only); ``batcher(packs, cfg, prompts, peaks)`` runs
    the batcher on four requests; ``mesh(args, params, cfg, tokens)``
    holds the model's mesh lanes to its one-device lane."""
    import numpy as np
    import torch

    import repro_torch.api as codr
    from repro_torch.core.engine import full_fp32
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.kernels.codr_matmul import ops
    from repro_torch.launch.serve import (encdec_decode, greedy_decode,
                                          pad_self_cache)
    from repro_torch.models import get_model

    batch, prompt_len = 4, 32
    api = get_model(cfg)
    peaks: dict = {}
    say(f"{label}: {cfg.name} ({cfg.family}), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, period "
        f"{cfg.block_pattern}; {cut}; batch {batch}, prompt {prompt_len}, "
        f"gen {gen_len}; random weights (seed {args.seed})")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(leaf.numel() for _, leaf in leaves_with_path(params))
    _peak("init", peaks, label)
    t0 = time.perf_counter()
    compiled = codr.compile_params(params, codr.EncodeConfig(n_unique=16),
                                   backend="codr_matmul", accounting=False,
                                   device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del params
    params = compiled.params
    torch.cuda.empty_cache()
    bits = {leaf.weight.bits for _, leaf in compiled.packed_leaves()
            if hasattr(leaf, "out_features")}
    say(f"{label} encode: {n_params} parameters drawn on the card in "
        f"{init_s:.2f} s; compile_params (U = 16) {encode_s:.2f} s; "
        f"{len(compiled.packed_paths)} packed projections + "
        f"{len(compiled.embed_paths)} embeddings, bits {sorted(bits)}; "
        f"packed {compiled.hbm_bytes()} bytes vs dense bf16 "
        f"{compiled.dense_bf16_bytes()} bytes, "
        f"{compiled.bits_per_weight():.4f} bits/weight")
    _peak("encode", peaks, label)
    if len(bits) != 1:
        fail(f"{label}: packs of several widths {bits}")
    bits = bits.pop()

    # -- the main path: prefill, then run_serve's loop replayed from one
    # captured decode step
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device="cuda")
    prefix = None
    batch_in = {"tokens": tokens}
    if cfg.frontend or cfg.family == "encdec":
        prefix = torch.randn((batch, cfg.frontend_seq, cfg.d_model),
                             generator=gen, device="cuda")
        batch_in["prefix"] = prefix
    _zero_counts(ops)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch_in, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_by_impl = dict(ops.launches_by_impl)
    prefill_launches = ops.launches

    def decode_loop(eager: bool):
        if cfg.family == "encdec":
            c = pad_self_cache(api.prefill(params, batch_in, cfg)[1]
                               if eager else cache, prompt_len + gen_len)
            return encdec_decode(api, params, c, logits, cfg, prompt_len,
                                 gen_len, eager=eager)
        return greedy_decode(api, params, tokens, cfg, gen_len, eager=eager)
    t0 = time.perf_counter()
    out, _, n_steps = decode_loop(eager=False)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache
    launches, captured = ops.launches, ops.captured
    by_impl = dict(ops.launches_by_impl)
    # every prefill projection sees more than 16 rows here (M = 128, and
    # the encoder's or the prefixed prompt's 4 x 1024 / 4 x 1056)
    want_prefill = dict.fromkeys(ops.IMPLS, 0)
    want_prefill[ops.pick_impl(batch * prompt_len, bits)] += per_prefill
    want = dict(want_prefill)
    want[ops.pick_impl(batch, bits)] += per_step
    want_steps = gen_len - 1 + (0 if cfg.family == "encdec" else prompt_len)
    ms_step = decode_s / n_steps * 1e3
    say(f"{label} main path: prefill {prefill_ms:.3f} ms; {n_steps} decode "
        f"steps replayed from one CUDA graph {decode_s * 1e3:.3f} ms "
        f"({ms_step:.3f} ms/step, the warm-up step and the capture "
        f"included); codr_matmul launches counted {launches}: "
        f"{prefill_launches} in prefill ({per_prefill} expected), "
        f"{launches - prefill_launches} in the warm-up step ({per_step} "
        f"expected); {captured} calls recorded at the capture; by instance "
        f"prefill {prefill_by_impl}, in all {by_impl} (routing predicts "
        f"{want_prefill} / {want}) [{SMI}]")
    if (prefill_launches != per_prefill or captured != per_step
            or launches != per_prefill + per_step
            or prefill_by_impl != want_prefill or by_impl != want
            or n_steps != want_steps):
        fail(f"{label}: codr_matmul launches {prefill_launches} / "
             f"{launches} / captured {captured} ({prefill_by_impl} / "
             f"{by_impl}) over {n_steps} steps, expected {per_prefill} / "
             f"{per_prefill + per_step} / {per_step} ({want_prefill} / "
             f"{want}) over {want_steps}")
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"{label}: prefill logits {tuple(logits.shape)} not finite")
    if tuple(out.shape) != (batch, gen_len) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{label}: generated tokens {tuple(out.shape)} out of range")
    _peak("prefill + captured decode loop", peaks, label)

    # -- the same loop eager: the same tokens, and every step's logits
    t0 = time.perf_counter()
    out_eager, _, _ = decode_loop(eager=True)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / n_steps * 1e3
    if not torch.equal(out, out_eager):
        fail(f"{label}: the replayed loop's tokens differ from the eager "
             f"loop's")
    eager_rows, _ = _step_logits(api, params, tokens, cfg, gen_len,
                                 captured=False, prefix=prefix)
    replay_rows, step = _step_logits(api, params, tokens, cfg, gen_len,
                                     captured=True, prefix=prefix)
    in_graph = _graph_kernels(step.graph, MM_KERNEL_NAMES)
    del step
    if len(eager_rows) != n_steps or len(replay_rows) != n_steps:
        fail(f"{label}: {len(eager_rows)} / {len(replay_rows)} steps, "
             f"expected {n_steps}")
    for i, (a, b) in enumerate(zip(eager_rows, replay_rows)):
        if not torch.equal(a, b):
            fail(f"{label} decode step {i}: replayed logits differ from "
                 f"eager (max-abs "
                 f"{float((a.float() - b.float()).abs().max())})")
    if in_graph != per_step:
        fail(f"{label}: the graph holds {in_graph} codr_matmul kernels, "
             f"expected {per_step}")
    del eager_rows, replay_rows
    torch.cuda.empty_cache()
    say(f"{label} graph: {n_steps} steps, tokens equal and logits equal bit "
        f"for bit at every step; the graph holds {in_graph} codr_matmul "
        f"kernels ({per_step} expected); eager {eager_ms:.3f} ms/step vs "
        f"replayed {ms_step:.3f} ms/step [{SMI}]")
    say(f"{label} sample generation (first row): {out[0, :16].tolist()}")
    _peak("eager loop + step-by-step logits", peaks, label)

    # -- the codr_matmul lane against the tiled lane, teacher-forced in
    # float32 (gated); bfloat16 printed, not a check
    tiled = _rebind(params, "tiled")
    with full_fp32():
        f32 = {lane: _teacher_forced(api, p, cfg, tokens, torch.float32,
                                     prefix=prefix)
               for lane, p in (("codr_matmul", params), ("tiled", tiled))}
    lane_err = 0.0
    for i, (a, b) in enumerate(zip(f32["codr_matmul"], f32["tiled"])):
        what = "prefill" if i == 0 else f"decode step {i - 1}"
        lane_err = max(lane_err, _lane_check(a, b, f"{label} {what} "
                                                   f"(float32)"))
    del f32
    bf16 = {lane: _teacher_forced(api, p, cfg, tokens, torch.bfloat16,
                                  prefix=prefix)
            for lane, p in (("codr_matmul", params), ("tiled", tiled))}
    bf16_err = [float((a.float() - b.float()).abs().max())
                for a, b in zip(bf16["codr_matmul"], bf16["tiled"])]
    if not torch.equal(bf16["codr_matmul"][0], logits):
        fail(f"{label}: the codr_matmul lane's prefill differs from the "
             f"main path's")
    del bf16, tiled
    torch.cuda.empty_cache()
    say(f"{label} lanes: codr_matmul vs tiled in float32 max-abs "
        f"{lane_err:.5f} (gated); in bfloat16, not a check, per step "
        f"{[round(e, 5) for e in bf16_err]}")
    _peak("lane check", peaks, label)

    result = {"config": f"{cfg.name}, {cut}",
              "launches": launches, "launches_by_impl": by_impl,
              "prefill_launches_by_impl": prefill_by_impl,
              "captured_calls": captured, "graph_codr_matmul_kernels":
              in_graph, "calls_per_prefill": per_prefill,
              "calls_per_step": per_step,
              "main_path": {"prefill_ms": prefill_ms, "ms_per_step": ms_step,
                            "eager_ms_per_step": eager_ms,
                            "decode_s": decode_s, "n_steps": n_steps,
                            "init_s": init_s, "encode_s": encode_s,
                            "n_params": n_params,
                            "packed_bytes": compiled.hbm_bytes(),
                            "dense_bf16_bytes": compiled.dense_bf16_bytes(),
                            "bits_per_weight": compiled.bits_per_weight()},
              "lane_vs_tiled_max_abs_err_f32": lane_err,
              "lane_vs_tiled_bf16": bf16_err}
    if profile:
        result["profile"] = _profile_replay(api, params, cfg, tokens,
                                            gen_len, per_step, label=label)
        torch.cuda.empty_cache()
        _peak("profiled replays", peaks, label)
    if shapes is not None:
        say(f"{label} clocks before the per-shape rows: {clocks()}")
        rows = _shape_rows(args, shapes(params), batch, prompt_len,
                           label=label)
        result["per_shape"] = rows
        if calls is not None:
            result.update(_sums(label, rows, calls, batch, prompt_len, bits))
        torch.cuda.empty_cache()
    if batcher is not None:
        rng = np.random.default_rng(args.seed + 13)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in PHASE_BATCH_LENS]
        result["batcher"] = batcher(compiled, cfg, prompts, peaks)
    if mesh is not None:
        result["mesh"] = mesh(args, params, cfg, tokens)
        _peak("mesh lanes", peaks, label)
    result["peak_memory_bytes"] = peaks
    return result


def _named_shapes(named: dict) -> dict:
    """``(K, N) -> [(name, PackedLinear)]`` of ``{name: PackedLinear}``."""
    shapes: dict = {}
    for name, pl in named.items():
        shapes.setdefault((pl.weight.shape[0], pl.out_features), []).append(
            (name, pl))
    return shapes


def jamba_phase(args) -> dict:
    """jamba-v0.1-52b at its published widths, depth cut 32 -> 8 (one
    whole period: seven mamba layers and one attention layer, four MoE
    and four dense MLPs), served from 4-bit packs; its batcher on the
    dense pool.  Per-shape rows: mamba's x_proj (8192 -> 288), dt_proj
    (K = 256), in_proj and the MoE router (4096 -> 16)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_LAYERS)

    def shapes(params):
        layer = params["stack"]
        return _named_shapes({
            "mamba/x_proj": layer["b0"]["mixer"]["x_proj"][0],
            "mamba/dt_proj": layer["b0"]["mixer"]["dt_proj"][0],
            "mamba/in_proj": layer["b0"]["mixer"]["in_proj"][0],
            "moe/router": layer["b1"]["mlp"]["router"][0]})
    return model_phase(
        args, "jamba", cfg, f"published widths, depth 32 -> {JAMBA_LAYERS} "
        f"(one period)", per_prefill=JAMBA_PER_FORWARD,
        per_step=JAMBA_PER_FORWARD, gen_len=32, shapes=shapes, profile=True,
        batcher=functools.partial(_ssm_batcher, "jamba",
                                  per_forward=JAMBA_PER_FORWARD))


def xlstm_phase(args) -> dict:
    """xlstm-350m whole (24 layers); the batcher on the dense pool; the
    mLSTM ``if_proj`` shape (2048 -> 8)."""
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-350m")
    per = XLSTM_PER_PERIOD * cfg.n_periods

    def shapes(params):
        return _named_shapes({
            "mlstm/if_proj": params["stack"]["b0"]["mixer"]["if_proj"][0]})
    return model_phase(args, "xlstm", cfg, "published size, no cuts",
                       per_prefill=per, per_step=per, gen_len=8,
                       shapes=shapes,
                       batcher=functools.partial(_ssm_batcher, "xlstm",
                                                 per_forward=per))


def seamless_phase(args) -> dict:
    """seamless-m4t-medium whole (12 encoder + 12 decoder layers), stub
    frames (4, 1024, 1024) from the seed; ``run_serve``'s enc-dec loop
    over the padded prefill cache."""
    from repro_torch.configs import get_config
    cfg = get_config("seamless-m4t-medium")
    per = SEAMLESS_PER_LAYER
    return model_phase(
        args, "seamless", cfg, "published size, no cuts",
        per_prefill=(per["enc"] * cfg.n_encoder_layers
                     + per["dec_prefill"] * cfg.n_periods),
        per_step=per["dec_step"] * cfg.n_periods, gen_len=16)


def internvl_phase(args) -> dict:
    """internvl2-26b at its published widths, depth cut 48 -> 4, with a
    stub vision prefix (4, 1024, 6144) from the seed."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("internvl2-26b"),
                              n_layers=INTERNVL_LAYERS)
    return model_phase(args, "internvl", cfg,
                       f"published widths, depth 48 -> {INTERNVL_LAYERS}",
                       per_prefill=7 * INTERNVL_LAYERS,
                       per_step=7 * INTERNVL_LAYERS, gen_len=8)


# ---------------------------------------------------------------------------
# phase 9: the sharded CNN lane and its serving supervisor (VGG16)
# ---------------------------------------------------------------------------

SHARD_DS = (1, 2, 4)            # mesh sizes; D > 1 repeats cuda:0
# sharded vs tiled where the two are not bit for bit: tiled's own bound
# against its reference (cnn_path: tiled vs quantized_reference), a
# share of the output's largest magnitude
SHARD_REL_TOL = 1e-4


def _zero_kernel_counts() -> list:
    """Every kernel's launch counters set to 0; returns the ops modules."""
    from repro_torch.kernels.codr_matmul import ops as mm_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.smm_conv import ops as smm_ops
    for ops in (smm_ops, mm_ops, fa_ops):
        ops.launches = 0
        ops.launches_by_impl.update(dict.fromkeys(ops.launches_by_impl, 0))
    return [smm_ops, mm_ops, fa_ops]


def _no_kernel_launched(label: str, mods) -> None:
    """The lanes of the new phases run no hand-written kernel (the
    reference's sharded lane and training path reach no Pallas kernel)."""
    counts = {m.__name__.split(".")[-2]: m.launches for m in mods}
    say(f"{label}: kernel launches {counts} (the code gives none)")
    if any(counts.values()):
        fail(f"{label}: kernels launched {counts}, expected none")


def sharded_phase(args, compiled) -> dict:
    """The VGG16 model of the first path on the ``sharded`` lane (each
    layer's decoded tile stack split over the output-tile axis, one
    ``F.conv2d`` a shard, gathered to the first device): batch-4
    requests over meshes of D = 1 (the default mesh: the card), 2 and 4
    (cuda:0 repeated), each D gated against ``tiled`` on the same
    compiled model; then a ``CodrBatchServer`` under a
    ``ServingSupervisor`` over the D = 4 lane with two device losses at
    ``sharded.dispatch`` and one dispatch error, served requests equal
    to a clean supervised run's, and the rest of the ladder walked down
    to ``tiled``."""
    import numpy as np
    import torch

    from repro_torch.core import backends
    from repro_torch.core.backends import ShardedBackend
    from repro_torch.runtime import resilience as res
    from repro_torch.sharding import rules

    mods = _zero_kernel_counts()
    img_rng = np.random.default_rng(args.seed + 9)
    batch, n_requests = 4, 3
    images = [img_rng.integers(0, 256, size=(batch, 226, 226, 3)).astype(
        np.float32) for _ in range(n_requests)]
    lanes = {"tiled": backends.get_backend("tiled"),
             1: backends.get_backend("sharded")}
    for d in SHARD_DS[1:]:
        lanes[d] = ShardedBackend(rules.tile_mesh(["cuda:0"] * d),
                                  name=f"sharded_d{d}")
    out = {"launches": 0, "launches_by_impl": {}, "per_d": {}}
    conv_names = re.compile(r"conv|cudnn|implicit|gemm|xmma|winograd|fft")
    bitwise, tiled, scale = True, None, None
    for d, lane in lanes.items():
        mesh = (lane.mesh_for(compiled.device) if d != "tiled"
                else (compiled.device,))
        if d != "tiled" and len(mesh) != d:
            fail(f"sharded D={d}: mesh {mesh}")
        ms, ys = [], []
        for x in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = compiled.run(x, backend=lane)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if tuple(y.shape) != (batch, 212, 212, 256) or \
                    not bool(torch.isfinite(y).all()):
                fail(f"sharded D={d}: output {tuple(y.shape)} not finite")
            ys.append(y)
        if d == "tiled":
            tiled = ys
            scale = max(float(y.abs().max()) for y in tiled)
        err = max(float((y - t).abs().max()) for y, t in zip(ys, tiled))
        del ys
        # D = 1 is tiled's call: its profile would repeat tiled's
        prof = None if d == 1 else _profile(
            lambda: compiled.run(images[1], backend=lane), "conv",
            conv_names)
        steady = ms[1:]
        row = {"mesh": [str(m) for m in mesh], "first_ms": ms[0],
               "steady_ms": steady,
               "images_s": batch * len(steady) / (sum(steady) / 1e3),
               "max_abs_vs_tiled": err, "bit_for_bit": err == 0.0,
               "profile": prof}
        out["per_d"][d] = row
        label = "tiled" if d == "tiled" else f"sharded D={d}"
        say(f"{label} over {row['mesh']}: batch {batch} requests, first "
            f"{ms[0]:.3f} ms{' (places the shards)' if d != 'tiled' else ''}"
            f", steady {[round(t, 3) for t in steady]} ms, "
            f"{row['images_s']:.3f} images/s; vs tiled max-abs {err!r} "
            f"({'bit for bit' if err == 0.0 else f'{err / scale:.3e} of the output range'}) [{SMI}]")
        if prof is not None:
            _say_profile(f"{label} profile, one steady request", prof,
                         "conv")
        if d == "tiled":
            continue
        bitwise &= err == 0.0
        if err > SHARD_REL_TOL * scale:
            fail(f"sharded D={d} vs tiled max-abs {err} > "
                 f"{SHARD_REL_TOL} x {scale}")
    out["bit_for_bit"] = bitwise

    # -- the supervisor over the D = 4 lane --------------------------------
    reqs = [img_rng.integers(0, 256, size=(226, 226, 3)).astype(np.float32)
            for _ in range(12)]

    def supervised(plan):
        lane = ShardedBackend(rules.tile_mesh(["cuda:0"] * 4))
        inj = None if plan is None else res.FaultInjector(plan)
        lane.set_fault_injector(inj)
        sup = res.ServingSupervisor(backend=lane, fallback="tiled")
        srv = compiled.serve(max_batch=4)
        srv.configure_resilience(
            injector=inj, supervisor=sup,
            retry_policy=res.RetryPolicy(max_retries=3, backoff_s=1e-3))
        t0 = time.perf_counter()
        rows = srv.serve(reqs)
        return sup, srv, rows, (time.perf_counter() - t0) * 1e3

    _, _, clean, clean_ms = supervised(None)
    plan = res.FaultPlan(
        [res.Fault(res.SITE_SHARDED_DISPATCH, 0, "device_loss"),
         res.Fault(res.SITE_SHARDED_DISPATCH, 2, "device_loss"),
         res.Fault(res.SITE_SERVER_DISPATCH, 1, "error")])
    sup, srv, rows, chaos_ms = supervised(plan)

    def distance(a, b) -> float:
        if any(r is None for r in a):
            fail("sharded supervisor: a request got no output row")
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    err = distance(rows, clean)
    walk = []
    while sup.backend_name != "tiled":          # the rest of the ladder
        lane = sup.degrade("walk the ladder")
        walk.append(distance(srv.serve(reqs[:4]), clean[:4]))
        say(f"sharded supervisor: rung {lane}, 4 requests vs the clean "
            f"run max-abs {walk[-1]!r}")
    if sup.degrade("past the bottom") is not None:
        fail("sharded supervisor: the ladder did not end at tiled")
    history = [[h["from"], h["to"], h["surviving_devices"], h["reason"]]
               for h in sup.history]
    say(f"sharded supervisor history [from, to, surviving, reason]: "
        f"{history}")
    say(f"sharded supervisor: 12 requests, clean D=4 run {clean_ms:.3f} ms, "
        f"under the plan ({plan.describe().replace(chr(10), ';')}) "
        f"{chaos_ms:.3f} ms; served {srv.requests_served}, quarantined "
        f"{srv.requests_quarantined}, fired {len(srv._injector.fired)}; vs "
        f"clean max-abs {err!r} [{SMI}]")
    names = [h[1] for h in history]
    if names != ["sharded@2", "sharded@2", "sharded@1", "tiled"]:
        fail(f"sharded supervisor: rungs {names}")
    if srv.requests_served != len(reqs) + 4 * len(walk) or \
            srv.requests_quarantined or len(rows) != len(reqs):
        fail(f"sharded supervisor: served {srv.requests_served}, "
             f"quarantined {srv.requests_quarantined}")
    lim = 0.0 if bitwise else SHARD_REL_TOL * scale
    if max([err, *walk]) > lim:
        fail(f"sharded supervisor: outputs {max([err, *walk])} from the "
             f"clean run's (limit {lim})")
    out.update(history=history, chaos_ms=chaos_ms, clean_ms=clean_ms,
               max_abs_vs_clean=max([err, *walk]))
    _no_kernel_launched("sharded phase", mods)
    return out


# ---------------------------------------------------------------------------
# phase 10: training — the CLI, and qwen2.5-3b at its published widths
# ---------------------------------------------------------------------------

TRAIN_DEPTH = 4                 # depth cut of the crash-and-resume run
TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAIL = 40, 10, 25
TRAIN_FULL_STEPS = 12           # the first two untimed
# the resumed losses vs the uninterrupted run's: the embedding's backward
# accumulates with atomics on the card, so the bits of a step may differ;
# the repo's bf16 bound (2e-2 of the magnitude)
TRAIN_RESUME_REL = 2e-2


def _train_loop(cfg, ckpt_dir: str, seed: int, *, total: int, every: int,
                fail_at=None):
    """A ``TrainLoop`` as the CLI makes it (batch 8 × seq 128, lr 3e-3,
    no master copy) over ``cfg`` with params drawn on the card from
    ``seed`` and cast to bf16."""
    import torch

    from repro_torch.core.tree import map_leaves
    from repro_torch.data import DataConfig, host_batch_iterator
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainLoop, TrainLoopConfig
    api = get_model(cfg)
    params = api.init_params(torch.Generator("cuda").manual_seed(seed), cfg)
    params = map_leaves(lambda p: p.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                      global_batch=8)
    return TrainLoop(
        train_loss_fn=lambda p, b: api.train_loss(p, b, cfg),
        params=params, batch_iter=host_batch_iterator(dcfg),
        opt_cfg=AdamWConfig(lr=3e-3, use_master=False),
        loop_cfg=TrainLoopConfig(total_steps=total, checkpoint_every=every,
                                 ckpt_dir=ckpt_dir, peak_lr=3e-3,
                                 fail_at_step=fail_at))


def _n_params(tree) -> int:
    from repro_torch.core.tree import leaves
    return sum(p.numel() for p in leaves(tree))


def _step_ms(hist, skip: int = 1) -> tuple:
    import numpy as np
    t = [h["step_time_s"] * 1e3 for h in hist[skip:]]
    return float(np.median(t)), float(np.mean(t))


def train_phase(args) -> dict:
    """Training through the entry points a user calls: the CLI
    (``python -m repro_torch.launch.train --steps 40``, the smoke variant
    as the reference's CLI always trains) as a child process; qwen2.5-3b
    at its published widths with the depth cut to 4: 40 steps
    uninterrupted, then 40 with checkpoints every 10, a simulated failure
    at step 25 and a resume held to the uninterrupted run; then the full
    depth (36), 10 timed steps with no checkpoint."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    mods = _zero_kernel_counts()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(root, "build", f"train_phase_{os.getpid()}")
    out = {"launches": 0, "launches_by_impl": {}}
    say(f"train: device memory allocated at the start "
        f"{torch.cuda.memory_allocated()} bytes")
    try:
        # -- 1. the CLI as users run it ------------------------------------
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--steps",
             "40", "--ckpt-dir", os.path.join(tmp, "cli")], cwd=root,
            env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        for line in child.stdout.strip().splitlines():
            say(f"train CLI: {line}")
        if child.returncode or "(improved)" not in child.stdout:
            fail(f"train CLI rc {child.returncode}: "
                 f"{child.stdout[-800:]} {child.stderr[-1500:]}")
        say(f"train CLI: --steps 40 in {cli_s:.1f} s (the process, its "
            f"start included) [{SMI}]")
        out["cli_s"] = cli_s

        # -- 2. published widths, depth cut: crash and resume --------------
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  n_layers=TRAIN_DEPTH)
        say(f"train: qwen2.5-3b at its published widths (d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}), depth 36 -> {TRAIN_DEPTH}; bf16 params, "
            f"AdamW without a master copy, batch 8 x seq 128, lr 3e-3, "
            f"remat {cfg.remat}")
        torch.cuda.reset_peak_memory_stats()
        # the uninterrupted run writes no checkpoint (a save copies the
        # state and changes none of it); the crash-and-resume run does
        loop = _train_loop(cfg, os.path.join(tmp, "a"), args.seed,
                           total=TRAIN_STEPS, every=10 ** 9)
        n = _n_params(loop.params)
        full = loop.run()
        losses = [h["loss"] for h in full]
        med, mean = _step_ms(full)
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        peak = torch.cuda.max_memory_allocated()
        say(f"train depth {TRAIN_DEPTH}: {n} params, {len(full)} steps, loss "
            f"{first:.4f} -> {last:.4f} (first / last 10), per step "
            f"{[round(x, 4) for x in losses]}; step median {med:.3f} ms, "
            f"mean {mean:.3f} ms (steps 1..), {8 * 128 / med * 1e3:.1f} "
            f"tokens/s; peak device memory {peak} bytes [{SMI}]")
        if not np.isfinite(losses).all() or not last < first:
            fail(f"train depth {TRAIN_DEPTH}: the loss did not fall "
                 f"({first} -> {last})")
        state = {"params": loop.params, "opt": loop.opt_state}
        t0 = time.perf_counter()
        loop.ckpt.save(TRAIN_STEPS, state, async_=False)
        save_s = time.perf_counter() - t0
        step_dir = os.path.join(tmp, "a", f"step_{TRAIN_STEPS}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        batch = next(iter(loop.batch_iter))[1]
        prof = _profile(lambda: loop.step_fn(loop.params, loop.opt_state,
                                             batch),
                        "gemm", re.compile(r"gemm|xmma|nvjet|cutlass"))
        _say_profile(f"train depth {TRAIN_DEPTH} profile, one step", prof,
                     "gemm")
        say(f"train depth {TRAIN_DEPTH}: checkpoint {ckpt_bytes} bytes "
            f"(params + m + v + step), one synchronous save {save_s:.2f} s "
            f"({ckpt_bytes / save_s / 1e9:.2f} GB/s, device to host and "
            f"the files) [{SMI}]")
        del loop, state, batch
        torch.cuda.empty_cache()

        crash = _train_loop(cfg, os.path.join(tmp, "b"), args.seed,
                            total=TRAIN_STEPS, every=TRAIN_EVERY,
                            fail_at=TRAIN_FAIL)
        try:
            crash.run()
        except RuntimeError as e:
            if "simulated host failure" not in str(e):
                raise
            say(f"train: {e}; checkpoints {crash.ckpt.steps()}")
        else:
            fail("train: the simulated failure did not fire")
        del crash
        torch.cuda.empty_cache()
        resumed = _train_loop(cfg, os.path.join(tmp, "b"), args.seed + 1,
                              total=TRAIN_STEPS, every=TRAIN_EVERY)
        t0 = time.perf_counter()
        start = resumed.try_restore()
        restore_s = time.perf_counter() - t0
        hist = resumed.run()
        steps = [h["step"] for h in hist]
        diff = [abs(h["loss"] - f["loss"]) for h, f in
                zip(hist, full[start:])]
        say(f"train resume: restored step {start - 1} in {restore_s:.2f} s, "
            f"ran steps {steps[0]}..{steps[-1]}; resumed losses vs the "
            f"uninterrupted run: largest difference {max(diff)!r} "
            f"({'bit for bit' if max(diff) == 0 else 'not bit for bit'}), "
            f"per step {[round(d, 6) for d in diff]}")
        if start != TRAIN_EVERY * (TRAIN_FAIL // TRAIN_EVERY) + 1 or \
                steps != list(range(start, TRAIN_STEPS)):
            fail(f"train resume: start {start}, steps {steps}")
        if max(diff) > TRAIN_RESUME_REL * max(abs(full[-1]["loss"]), 1.0):
            fail(f"train resume: losses {max(diff)} from the uninterrupted "
                 f"run's")
        del resumed
        torch.cuda.empty_cache()
        out["cut"] = {"depth": TRAIN_DEPTH, "params": n, "losses": losses,
                      "step_ms": med, "step_ms_mean": mean,
                      "tokens_s": 8 * 128 / med * 1e3, "peak_bytes": peak,
                      "ckpt_bytes": ckpt_bytes, "save_s": save_s,
                      "restore_s": restore_s, "profile": prof,
                      "resume_start": start, "resume_max_diff": max(diff)}

        # -- 3. full depth, 10 timed steps ---------------------------------
        cfg = get_config("qwen2.5-3b")
        torch.cuda.reset_peak_memory_stats()
        loop = _train_loop(cfg, os.path.join(tmp, "c"), args.seed,
                           total=TRAIN_FULL_STEPS, every=10 ** 9)
        n = _n_params(loop.params)
        hist = loop.run()
        peak = torch.cuda.max_memory_allocated()
        med, mean = _step_ms(hist, skip=2)
        batch = next(iter(loop.batch_iter))[1]
        prof = _profile(lambda: loop.step_fn(loop.params, loop.opt_state,
                                             batch),
                        "gemm", re.compile(r"gemm|xmma|nvjet|cutlass"))
        _say_profile("train full depth profile, one step", prof, "gemm")
        tokens = 8 * 128
        n_stack = n - cfg.vocab_size * cfg.d_model     # tied embeddings
        flops = 6 * n * tokens
        remat = 2 * n_stack * tokens if cfg.remat else 0
        share = flops / (med / 1e3) / BF16_FLOPS
        say(f"train full depth {cfg.n_layers}: {n} params, "
            f"{len(hist)} steps, loss {hist[0]['loss']:.4f} -> "
            f"{hist[-1]['loss']:.4f}; step median {med:.3f} ms, mean "
            f"{mean:.3f} ms (steps 2..{len(hist) - 1}), "
            f"{tokens / med * 1e3:.1f} tokens/s; peak device memory {peak} "
            f"bytes; model FLOPs 6 N T = {flops:.4e} a step (remat's extra "
            f"forward 2 N_stack T = {remat:.4e} more), {share:.4f} of the "
            f"dense bf16 peak {BF16_FLOPS:.3e} FLOP/s [{SMI}]")
        if not np.isfinite([h["loss"] for h in hist]).all():
            fail("train full depth: a loss is not finite")
        out["full"] = {"depth": cfg.n_layers, "params": n, "step_ms": med,
                       "step_ms_mean": mean, "tokens_s": tokens / med * 1e3,
                       "peak_bytes": peak, "model_flops": flops,
                       "remat_flops": remat, "bf16_peak_share": share,
                       "profile": prof,
                       "losses": [h["loss"] for h in hist]}
        del loop
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _no_kernel_launched("train phase", mods)
    return out


# ---------------------------------------------------------------------------
# phase 10: the model on a mesh — the sequence-parallel decode attention,
# the expert-parallel and 2-D MoE lanes, build_cell's train step (each held
# to its one-device form), and the dry-run on the meta device
# ---------------------------------------------------------------------------

MESH_SHAPES = ((2, 2), (1, 4))  # (data, model), cuda:0 filling each position
DIST_SEQ = 32768                # decode_32k's cache length
DIST_STEPS = 16
# the first decode position: the steps cross the block boundary at
# DIST_SEQ / 2, which both meshes share (blocks of 16,384 and 8,192)
DIST_START = DIST_SEQ // 2 - DIST_STEPS // 2
DS_MESH_STEPS = 8
MESH_F32_REL = 1e-3             # f32 lanes differ in summation order only
DRYRUN_ARCHS = ("qwen2.5-3b", "deepseek-v2-236b")


def _mesh_check(a, b, what: str, rel: float) -> float:
    """Logits of a mesh lane ``a`` against the one-device lane ``b``:
    max-abs within ``rel · max(|b|max, 1)``, argmax equal where b's top-2
    margin exceeds that."""
    import torch
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    if not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
        fail(f"{what}: non-finite logits")
    lim = rel * max(float(b.abs().max()), 1.0)
    err = float((a - b).abs().max())
    top2 = torch.topk(b, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > lim
    if not err <= lim:
        fail(f"{what}: mesh lane vs one device max-abs {err} > {lim}")
    if not bool((a.argmax(-1)[clear] == b.argmax(-1)[clear]).all()):
        fail(f"{what}: argmax differs where the margin exceeds {lim}")
    return err


def _write_prefix(dst, src) -> None:
    """Copy a prefill cache into the front of a longer decode cache of
    the same tree (each leaf along the axis where their shapes differ)."""
    from repro_torch.core.tree import leaves
    for d, s in zip(leaves(dst), leaves(src)):
        ax = next(i for i, (a, b) in enumerate(zip(d.shape, s.shape))
                  if a != b)
        d.narrow(ax, 0, s.shape[ax]).copy_(s)


def _fill_front(dst, src, n: int) -> None:
    """Fill positions 0 .. n-1 of a longer decode cache with a prefill
    cache repeated along the axis where their shapes differ."""
    from repro_torch.core.tree import leaves
    for d, s in zip(leaves(dst), leaves(src)):
        ax = next(i for i, (a, b) in enumerate(zip(d.shape, s.shape))
                  if a != b)
        p = s.shape[ax]
        for start in range(0, n, p):
            w = min(p, n - start)
            d.narrow(ax, start, w).copy_(s.narrow(ax, 0, w))


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dryrun_phase(root: str) -> dict:
    """The dry-run CLI (``python -m repro_torch.launch.dryrun``) for each
    of ``DRYRUN_ARCHS`` at every shape and production mesh: one
    host-only child process a cell, all at once (no card visible: the
    meta device), run after the card's phases so that no timed or
    profiled window shares the host with them.  Prints each record's
    status, a device's argument bytes, the FLOPs of the step over all
    devices and the lanes' collective bytes."""
    import shutil

    from repro_torch.configs import SHAPES
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUDA_VISIBLE_DEVICES="")
    tmp = os.path.join(root, "build", f"dryrun_{os.getpid()}")
    children, recs = [], {}
    t0 = time.perf_counter()
    try:
        for arch in DRYRUN_ARCHS:
            for shape in SHAPES:
                for mesh in ("pod", "multipod"):
                    d = os.path.join(tmp, f"{arch}__{shape}__{mesh}")
                    os.makedirs(d, exist_ok=True)
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mesh,
                           "--out", d]
                    children.append((f"{arch} {shape} {mesh}", d,
                                     subprocess.Popen(
                                         cmd, cwd=root, env=env,
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)))
        for label, d, proc in children:
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode:
                fail(f"dry-run {label}: rc {proc.returncode} "
                     f"{stdout[-1500:]} {stderr[-1500:]}")
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name)) as f:
                    rec = json.load(f)
                key = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
                recs[key] = rec
                if rec["status"] == "OK":
                    say(f"dry-run {key}: OK, {rec['n_devices']} devices, "
                        f"argument bytes a device "
                        f"{rec['memory']['argument_bytes']:.6e} (the "
                        f"arguments alone fit one H100 80GB: "
                        f"{rec['memory']['arguments_fit_h100_80gb']}), "
                        f"step FLOPs of all devices together "
                        f"{rec['cost']['flops_global']:.6e}, lanes' "
                        f"collective bytes a device "
                        f"{rec['collectives']['total_bytes']:.6e}, meta run "
                        f"{rec['run_s']} s")
                else:
                    say(f"dry-run {key}: {rec['status']} "
                        f"{rec.get('reason', rec.get('error', ''))}")
    finally:
        for _, _, proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"dry-run: {len(children)} children in {time.perf_counter() - t0:.1f}"
        f" s on the host")
    n_ok = sum(r["status"] == "OK" for r in recs.values())
    if n_ok != 6 * len(DRYRUN_ARCHS) or len(recs) != 8 * len(DRYRUN_ARCHS):
        fail(f"dry-run: {n_ok} OK of {len(recs)} records")
    return {k: {"status": r["status"],
                "argument_bytes": r.get("memory", {}).get("argument_bytes"),
                "flops_global": r.get("cost", {}).get("flops_global"),
                "collective_bytes": r.get("collectives", {}).get(
                    "total_bytes")} for k, r in recs.items()}


def dist_phase(args, packs) -> dict:
    """qwen2.5-3b at its published widths and full depth from the serve
    path's packs on the ``tiled`` lane (decode on dispatch, no kernel),
    ``decode_attn="dist"``: a 32-token prompt prefilled, its cache
    repeated over positions 0 .. ``DIST_START`` - 1 of a 32,768-position
    cache (batch 4), and 16 decode steps from ``DIST_START`` through
    ``build_cell``'s decode step on meshes (2, 2) and (1, 4) of cuda:0.
    The steps cross the boundary between two sequence blocks on both
    meshes: the visible keys span blocks 0 .. 1 on (2, 2) and 0 .. 2 on
    (1, 4), the first eight steps write the block before the boundary
    and the last eight the one after it.  Each step's logits are held to
    the standard lane's (one device, no context) on the same tokens, and
    the 16 written positions of the mesh's cache to the standard lane's
    cache."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import get_model
    from repro_torch.sharding import rules
    mods = _zero_kernel_counts()
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), decode_attn="dist")
    api = get_model(cfg)
    params = _rebind(packs.params, "tiled")
    batch, prompt = 4, 32
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 21)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=gen, device="cuda")
    shape = ShapeConfig("decode_32k_b4", DIST_SEQ, batch, "decode")
    with torch.no_grad():
        logits, pre = api.prefill(params, {"tokens": tokens}, cfg)
        base = api.init_cache(cfg, batch, DIST_SEQ, device="cuda")
        _fill_front(base, pre, DIST_START)
    del pre
    written = slice(DIST_START, DIST_START + DIST_STEPS)
    kv_bytes = sum(t.numel() * t.element_size() for t in leaves(base))
    say(f"mesh dist: {cfg.name}, {cfg.n_layers} layers, decode_attn dist, "
        f"batch {batch}, prompt {prompt} repeated over positions 0 .. "
        f"{DIST_START - 1} of a {DIST_SEQ}-position cache of {kv_bytes} "
        f"bytes, {DIST_STEPS} steps from position {DIST_START} (across "
        f"the block boundary at {DIST_SEQ // 2}), packs on the tiled lane")

    def run(step, cache, feed):
        rows, ms, toks = [], [], []
        tok = logits[:, -1].argmax(-1)
        for i in range(DIST_STEPS):
            (lg, cache), t = _timed(lambda: step(cache, tok,
                                                 DIST_START + i))
            rows.append(lg)
            ms.append(t)
            toks.append(lg.argmax(-1))
            tok = feed[i] if feed else toks[-1]
        return rows, ms, toks, cache

    with torch.no_grad():
        std_rows, std_ms, feed, std_cache = run(
            lambda c, t, p: api.decode_step(params, c, t, p, cfg),
            {"stack": {k: tuple(t.clone() for t in v)
                       for k, v in base["stack"].items()}}, None)
    torch.cuda.empty_cache()
    # the standard lane's writes: (n_periods, batch, seq, heads, dim)
    std_written = [t[:, :, written].clone() for t in leaves(std_cache)]
    del std_cache
    std_med = statistics.median(std_ms[1:])
    out = {"config": f"{cfg.name} full depth {cfg.n_layers}, batch {batch}, "
                     f"cache {DIST_SEQ}, steps from {DIST_START}",
           "kv_bytes": kv_bytes,
           "standard_ms_per_step": std_med, "meshes": {}}
    for shape_dm in MESH_SHAPES:
        mesh = make_host_mesh(*shape_dm)
        step, _, _, _ = build_cell(cfg, shape, mesh)
        cache = {"stack": {k: tuple(t.clone() for t in v)
                           for k, v in base["stack"].items()}}
        with rules.count_collectives() as coll:
            rows, ms, _, cache = run(
                lambda c, t, p: step(params, c, t, p), cache, feed)
        placed = leaves(cache)
        if not all(isinstance(t, rules.ShardedTensor) for t in placed):
            fail(f"mesh dist {shape_dm}: the cache is not held as blocks")
        block = max(t.block_nbytes for t in placed)
        n_blocks = len(placed[0].blocks)
        s_loc = DIST_SEQ // shape_dm[1]
        if not DIST_START < (DIST_START // s_loc + 1) * s_loc \
                < DIST_START + DIST_STEPS:
            fail(f"mesh dist {shape_dm}: the steps stay in one block")
        err = max(_mesh_check(a, b, f"mesh dist {shape_dm} step {i}",
                              LANE_REL_TOL)
                  for i, (a, b) in enumerate(zip(rows, std_rows)))
        kv_err = 0.0
        for t, ref in zip(placed, std_written):
            got = rules.region(t, (slice(None), slice(None), written))
            lim = LANE_REL_TOL * max(float(ref.abs().max()), 1.0)
            d = float((got.float() - ref.float()).abs().max())
            if not d <= lim:
                fail(f"mesh dist {shape_dm}: the cache's written positions "
                     f"{DIST_START} .. {DIST_START + DIST_STEPS - 1} differ "
                     f"from the standard lane's by {d} > {lim}")
            kv_err = max(kv_err, d)
        med = statistics.median(ms[1:])
        per_step = coll["by_op_count"]["all-reduce"] / DIST_STEPS
        if per_step != 3 * cfg.n_layers:
            fail(f"mesh dist {shape_dm}: {per_step} combines a step, "
                 f"expected {3 * cfg.n_layers}")
        say(f"mesh dist {shape_dm} over cuda:0: {DIST_STEPS} steps from "
            f"position {DIST_START} across blocks {DIST_START // s_loc} | "
            f"{DIST_START // s_loc + 1} (blocks of {s_loc}), logits within "
            f"{err:.5f} of the standard lane (bound {LANE_REL_TOL} of the "
            f"spread), written cache positions within {kv_err:.5f} of its "
            f"cache; {med:.3f} ms/step (median of "
            f"steps 1..) vs standard {std_med:.3f} ms/step; the first step "
            f"{ms[0]:.3f} ms (places the cache: {n_blocks} blocks a leaf, "
            f"views of one buffer on one card); largest block {block} "
            f"bytes; combines a step {per_step:.0f} (3 a layer), "
            f"{coll['total_bytes'] / DIST_STEPS:.0f} bytes a step a device "
            f"[{SMI}]")
        out["meshes"][f"{shape_dm[0]}x{shape_dm[1]}"] = {
            "ms_per_step": med, "first_step_ms": ms[0], "max_abs_err": err,
            "written_kv_max_abs_err": kv_err,
            "largest_block_bytes": block, "blocks_per_leaf": n_blocks,
            "collective_bytes_per_step": coll["total_bytes"] / DIST_STEPS}
        del cache, placed, step
        torch.cuda.empty_cache()
    del base, std_written
    torch.cuda.empty_cache()
    _no_kernel_launched("mesh dist", mods)
    return out


def ds_mesh_check(args, params, cfg, tokens) -> dict:
    """deepseek-v2-236b from its packs on the ``tiled`` lane (the expert
    stacks decoded on dispatch, as ``_dense_moe_params`` does), float32
    activations with TF32 off: prefill through ``build_cell``'s prefill
    step on a (2, 2) mesh of cuda:0 (the expert-parallel branch), then
    ``DS_MESH_STEPS`` decode steps through its decode step with
    ``moe_decode_2d`` (the 2-D branch), each held to the one-device lane
    on the same tokens."""
    import statistics

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engine import full_fp32
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import get_model, lm
    from repro_torch.sharding import rules
    mods = _zero_kernel_counts()
    cfg = dataclasses.replace(cfg, moe_decode_2d=True)
    api = get_model(cfg)
    tiled = _rebind(params, "tiled")
    batch, prompt = tokens.shape
    total = prompt + DS_MESH_STEPS
    mesh = make_host_mesh(2, 2)
    n_moe = sum(f == "moe" for _, f in cfg.layer_plan()) * cfg.n_periods
    prefill_step = build_cell(cfg, ShapeConfig("prefill", prompt, batch,
                                               "prefill"), mesh)[0]
    decode_step = build_cell(cfg, ShapeConfig("decode", total, batch,
                                              "decode"), mesh)[0]
    saved = lm.DEFAULT_DTYPE
    lm.DEFAULT_DTYPE = torch.float32
    try:
        with full_fp32(), torch.no_grad():
            (lg1, c1), one_ms = _timed(lambda: api.prefill(
                tiled, {"tokens": tokens}, cfg))
            with rules.count_collectives() as coll_p:
                (lgm, cm), mesh_ms = _timed(lambda: prefill_step(
                    tiled, {"tokens": tokens}))
            errs = [_mesh_check(lgm, lg1, "mesh deepseek prefill (EP)",
                                MESH_F32_REL)]
            caches = []
            for src in (c1, cm):
                c = api.init_cache(cfg, batch, total, dtype=torch.float32,
                                   device="cuda")
                _write_prefix(c, src)
                caches.append(c)
            del c1, cm
            tok = lg1[:, -1].argmax(-1)
            one_steps, mesh_steps = [], []
            with rules.count_collectives() as coll_d:
                for i in range(DS_MESH_STEPS):
                    (a, caches[0]), t1 = _timed(lambda: api.decode_step(
                        tiled, caches[0], tok, prompt + i, cfg))
                    (b, caches[1]), t2 = _timed(lambda: decode_step(
                        tiled, caches[1], tok, prompt + i))
                    one_steps.append(t1)
                    mesh_steps.append(t2)
                    errs.append(_mesh_check(b, a, f"mesh deepseek decode "
                                                  f"(2-D) step {i}",
                                            MESH_F32_REL))
                    tok = a.argmax(-1)
            del caches
    finally:
        lm.DEFAULT_DTYPE = saved
    torch.cuda.empty_cache()
    cp, cd = coll_p["by_op_count"], coll_d["by_op_count"]
    if (cp["all-reduce"], cp["all-gather"]) != (n_moe, 0) or (
            cd["all-reduce"], cd["all-gather"]) != (n_moe * DS_MESH_STEPS,
                                                   n_moe * DS_MESH_STEPS):
        fail(f"mesh deepseek: combines prefill {cp}, decode {cd}; expected "
             f"{n_moe} expert-parallel sums, then {n_moe} 2-D gathers and "
             f"sums a step")
    one_med = statistics.median(one_steps[1:])
    mesh_med = statistics.median(mesh_steps[1:])
    say(f"mesh deepseek {cfg.name} (2, 2) over cuda:0, float32: prefill "
        f"(expert parallel) {mesh_ms:.3f} ms vs one device {one_ms:.3f} "
        f"ms; {DS_MESH_STEPS} decode steps (2-D) {mesh_med:.3f} ms/step vs "
        f"{one_med:.3f} ms/step (medians of steps 1..); logits within "
        f"{max(errs):.6f} (bound {MESH_F32_REL} of the spread); combines: "
        f"{n_moe} expert sums in prefill, {n_moe} gathers + sums a step "
        f"[{SMI}]")
    _no_kernel_launched("mesh deepseek", mods)
    return {"prefill_ms": mesh_ms, "one_device_prefill_ms": one_ms,
            "ms_per_step": mesh_med, "one_device_ms_per_step": one_med,
            "max_abs_err_f32": max(errs),
            "collective_bytes_prefill": coll_p["total_bytes"],
            "collective_bytes_decode": coll_d["total_bytes"]}


def train_mesh_check(args, first_loss: float) -> dict:
    """``build_cell``'s train step for qwen2.5-3b at its published widths,
    depth cut to ``TRAIN_DEPTH``, batch 8 x seq 128, on a (2, 2) mesh of
    cuda:0: the same params (seed, bf16) and the same first batch as
    ``train_phase``'s run; one step's loss held within 2e-2 of that
    run's first loss."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import map_leaves
    from repro_torch.data import DataConfig, host_batch_iterator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    mods = _zero_kernel_counts()
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              n_layers=TRAIN_DEPTH)
    params = get_model(cfg).init_params(
        torch.Generator("cuda").manual_seed(args.seed), cfg)
    params = map_leaves(lambda p: p.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    batch = next(host_batch_iterator(dcfg))[1]
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = build_cell(cfg, ShapeConfig("train_b8", 128, 8, "train"),
                      make_host_mesh(2, 2))[0]
    opt = adamw_init(params, AdamWConfig())
    (new, _, metrics), ms = _timed(lambda: step(params, opt, batch))
    loss = float(metrics["loss"])
    del new, opt, params
    torch.cuda.empty_cache()
    diff = abs(loss - first_loss)
    say(f"mesh train: build_cell's train step, {cfg.name} depth "
        f"{TRAIN_DEPTH}, (2, 2) over cuda:0: loss {loss:.6f} vs the "
        f"one-device loop's first step {first_loss:.6f} (diff {diff:.2e}, "
        f"bound 2e-2); {ms:.1f} ms (the first step: autograd, AdamW on new "
        f"trees with a float32 master) [{SMI}]")
    if not diff <= 2e-2:
        fail(f"mesh train: loss {loss} vs {first_loss}")
    _no_kernel_launched("mesh train", mods)
    return {"loss": loss, "one_device_loss": first_loss, "step_ms": ms}


def cost_model_line(compiled) -> None:
    """The paper's Fig. 7/8 comparison over the VGG16 layers of the first
    path, from their measured encoded bits: SRAM accesses and energy of
    the CoDR, UCNN and SCNN dataflows under the 45 nm cost model.  A
    model estimate of the paper's ASIC, not a measurement on this card."""
    from repro_torch.configs.paper_cnns import VGG16
    from repro_torch.core import cost_model, dataflow
    from repro_torch.core.baselines import (scnn_compress_bits,
                                            ucnn_compress_bits)
    sram = dict.fromkeys(("codr", "ucnn", "scnn"), 0.0)
    energy = dict(sram)
    for layer, s in zip(compiled.model.layers, VGG16):
        code = layer.code
        nu = sum(len(u.unique_vals) for u in code.ucr)
        nn = sum(u.n_nonzero for u in code.ucr)
        for name, fn, tiling, bits in (
                ("codr", dataflow.codr_accesses, dataflow.CODR_TILING,
                 code.total_bits),
                ("ucnn", dataflow.ucnn_accesses, dataflow.UCNN_TILING,
                 ucnn_compress_bits(code.ucr)),
                ("scnn", dataflow.scnn_accesses, dataflow.SCNN_TILING,
                 scnn_compress_bits(layer.decoded_weights()))):
            acc = fn(s, tiling, bits, nu, nn)
            sram[name] += acc.total_sram
            energy[name] += cost_model.energy(acc).total_uj
    say(f"cost model (a model estimate under the paper's 45 nm constants, "
        f"not a measurement), VGG16 conv1_1..conv3_3 at the published "
        f"sizes from this run's encoded bits: SRAM accesses UCNN/CoDR "
        f"{sram['ucnn'] / sram['codr']:.3f}x, SCNN/CoDR "
        f"{sram['scnn'] / sram['codr']:.3f}x; energy UCNN/CoDR "
        f"{energy['ucnn'] / energy['codr']:.3f}x, SCNN/CoDR "
        f"{energy['scnn'] / energy['codr']:.3f}x")


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
    global SMI
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    SMI = smi
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- build: one nvcc per source, started together ----------------------
    t0 = time.perf_counter()
    sources = [*smm_ops.SOURCES.values(), *mm_ops.SOURCES.values(),
               *fa_ops.SOURCES.values()]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for fut in [*(pool.submit(smm_ops.load_kernel, i)
                      for i in smm_ops.IMPLS),
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
            if "Used" in line or "spill" in line:
                say(f"  ptxas {src.stem}: {line.strip()}")
        injected = text.count("warpgroup.arrive is injected")
        if injected:
            say(f"  ptxas {src.stem}: warpgroup.arrive injected {injected} "
                f"times (C7519)")
    sm90_log = _build.log_path(fa_ops.SOURCES["sm90"]).read_text()
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        sm90_log)
    if not spills or any(int(a) or int(b) for a, b in spills):
        fail(f"flash_attention_sm90: ptxas reports spills {spills}")
    say(f"  flash_attention_sm90 per D: " + ", ".join(
        f"D={d} {fa_ops.sm90_info(d)}" for d in fa_ops.SM90_HEAD_DIMS))

    t0 = time.perf_counter()
    cnn_model, row = cnn_path(args)
    kernels = [row]
    say(f"cnn path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row, prefill_qkv, packs = serve_path(args)
    kernels.append(row)
    say(f"serve path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(attention_path(args, prefill_qkv))
    say(f"attention path: {time.perf_counter() - t0:.1f} s")
    del prefill_qkv
    t0 = time.perf_counter()
    _add_phase(kernels[0], "cnn_server", cnn_server_phase(args, cnn_model))
    say(f"cnn server phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    _add_phase(kernels[1], "batcher",
               batcher_phase(args, packs, get_config("qwen2.5-3b")))
    say(f"batcher phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels[1]["checkpoint"] = checkpoint_phase(
        args, packs, get_config("qwen2.5-3b"))
    say(f"checkpoint phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cnn_tune, lm_tune = tune_phase(args, kernels[0], packs)
    _add_phase(kernels[0], "tune", cnn_tune)
    _add_phase(kernels[1], "tune", lm_tune)
    say(f"tune phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = {"dist": dist_phase(args, packs)}
    say(f"mesh dist phase: {time.perf_counter() - t0:.1f} s")
    del packs                         # qwen's packs make room for deepseek
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels[1]["deepseek"] = deepseek_phase(args)
    say(f"deepseek phase: {time.perf_counter() - t0:.1f} s")
    for name, phase in (("jamba", jamba_phase), ("xlstm", xlstm_phase),
                        ("seamless", seamless_phase),
                        ("internvl", internvl_phase)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kernels[1][name] = phase(args)
        say(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _add_phase(kernels[0], "sharded", sharded_phase(args, cnn_model))
    say(f"sharded phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_phase(args)
    _add_phase(kernels[1], "train", train)
    say(f"train phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh["train"] = train_mesh_check(args, train["cut"]["losses"][0])
    mesh["deepseek"] = kernels[1]["deepseek"]["mesh"]
    say(f"mesh train check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh["dryrun"] = dryrun_phase(os.path.dirname(os.path.abspath(
        __file__)))
    kernels[1]["mesh"] = mesh
    say(f"dry-run phase: {time.perf_counter() - t0:.1f} s")
    cost_model_line(cnn_model)

    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
