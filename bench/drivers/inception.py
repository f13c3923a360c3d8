"""Driver of the inception cells: one ``repro_torch.api.compile`` of the
whole configuration (inception modules, the poolings between them) on
the cell's lane, a closed loop of requests through its
``CompiledModel.run``, and the comparison of sampled outputs with the
plain reference.

The program runs the whole request: the modules' branches, their SAME
padding and concatenation, the pool branch and the poolings between
modules.  No harness code runs between the modules.  A program without
branch modules (``ModuleSpec``) cannot run the cell: the driver says so
and raises before any weight is drawn.

Set-up: the weights and biases drawn from the seed on the device, the
program's offline encoder (host), the input pool, and warm-up requests
on the pool's batches (the first decodes the bitstreams and packs the
kernel operands).  The window: one client sends a request, waits for the
device to finish it, and sends the next, until ``--seconds`` have
passed; the request that crosses the line is the window's last.  After
the window the program's model is freed and the reference is run on the
sampled requests' inputs, one request at a time.
"""
from __future__ import annotations

import random
import time

from bench import trace as tr
from bench.drivers.cnn import rel_gap
from bench.generators import inception as gen

__all__ = ["drive", "control", "model_spec"]


def model_spec(codr, config: dict, seed: int, device):
    """The configuration as the program's ``ModelSpec``: each module's
    four branches (#1x1; #3x3 reduce, #3x3 on a border of 1; #5x5
    reduce, #5x5 on a border of 2; the 3×3/1 pool, pool proj) and the
    poolings between modules, the weights and biases from the seed."""
    layers = gen.conv_layers(config)

    def conv(i):
        c = layers[i]
        return codr.LayerSpec.conv(
            gen.draw_layer(config, seed, i, device).cpu().numpy(),
            gen.draw_bias(config, seed, i, device).cpu().numpy(),
            padding=c["pad"], activation=config["activation"],
            name=c["name"])

    def step(kind, arg):
        return codr.PoolSpec(**arg) if kind == "pool" else conv(arg)

    steps = []
    for s in gen.plan(config):
        if s[0] == "pool":
            steps.append(codr.PoolSpec(**s[1]))
        else:
            steps.append(codr.ModuleSpec(
                [[step(*b) for b in branch] for branch in s[2]], name=s[1]))
    return codr.ModelSpec(steps)


def drive(run, *, device: str, t_start: float, build=None) -> None:
    """Fill ``run`` (a :class:`bench.harness.Run`): set-up, window,
    counters, memory peak and the correctness check.  ``build`` replaces
    the program's model for the harness's own tests (a fault planted
    under the timed path)."""
    import torch

    import repro_torch.api as codr
    if not hasattr(codr, "ModuleSpec"):
        raise RuntimeError("the program has no branch modules "
                           "(repro_torch.api.ModuleSpec): it cannot run an "
                           "inception cell")
    from bench.reference import inception as ref

    config, traffic, cell = run.config, run.traffic, run.cell_file
    lane = traffic["lane"]
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the inception driver runs one closed-loop client")
    t_imports = time.perf_counter()
    compiled = codr.compile(
        model_spec(codr, config, run.seed, device),
        codr.EncodeConfig(n_unique=int(config["n_unique"])), backend=lane,
        device=device)
    t_compiled = time.perf_counter()
    batch = int(traffic["images_per_request"])
    model = compiled if build is None else build(compiled)
    pool = gen.draw_images(config, traffic, run.seed, device)
    run.shapes = {"batch": batch, "layers": gen.layer_shapes(config),
                  "pools": gen.pool_shapes(config),
                  "nonzero": ref.nonzero_counts(config, run.seed, device),
                  "n_unique": int(config["n_unique"]),
                  "arithmetic": cell["arithmetic"]}
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else (lambda: None))
    t_warm = time.perf_counter()
    for i in range(int(traffic["warmup_requests"])):
        model.run(pool[i % len(pool)])
        sync()
    run.open_window(t_start)
    run.notes.append(
        f"setup: imports {t_imports - t_start:.2f} s, weights and the "
        f"program's encode {t_compiled - t_imports:.2f} s, inputs and "
        f"counts {t_warm - t_compiled:.2f} s, warm-up "
        f"{time.perf_counter() - t_warm:.2f} s")

    keep = int(traffic["sampled_requests"])
    rng = random.Random(gen.derive(run.seed, 3))
    sampled: list = []                      # (request index, output)
    req_ms, enq_ms = [], []

    def window():
        t_w0 = t_end = time.perf_counter()
        i = 0
        while t_end - t_w0 < run.seconds:
            run.attempted += 1
            with tr.mark("request", run.trace_on):
                t0 = time.perf_counter()
                try:
                    y = model.run(pool[i % len(pool)])
                    t1 = time.perf_counter()
                    sync()
                except RuntimeError as exc:
                    run.failed += 1
                    run.notes.append(f"request {i} failed: {exc}")
                    y = None
                    t1 = time.perf_counter()
                t_end = time.perf_counter()
            if y is not None:
                req_ms.append((t_end - t0) * 1e3)
                enq_ms.append((t1 - t0) * 1e3)
                # reservoir sample of the finished requests, from the seed
                if len(sampled) < keep:
                    sampled.append((i, y))
                else:
                    j = rng.randrange(len(req_ms))
                    if j < keep:
                        sampled[j] = (i, y)
            i += 1
        return t_end - t_w0

    if run.trace_on:
        run.window_s, run.trace = tr.record(window, sync=sync)
    else:
        run.window_s = window()
    run.samples = {"request_ms": req_ms, "enqueue_ms": enq_ms}
    run.work = {"images": batch * len(req_ms), "requests": len(req_ms)}
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if device.startswith("cuda") else 0)

    # the program's state goes before the reference runs
    del model, compiled
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    gap = float("inf") if not sampled else 0.0
    for i, y in sampled:
        want = ref.forward(config, lane, run.seed, pool[i % len(pool)])
        gap = max(gap, rel_gap(y, want))
        del want
    run.check("out_rel_gap", gap, float(cell["limits"]["out_rel_gap"]))


def control(run, device: str) -> dict:
    """The control's reading at the cell's size: the reference in the
    program's place one precision below the lane's (int4 features for the
    int8 path of ``smm_kernel``; TF32 for the float path of ``tiled``),
    on the first batch of the run's input pool, against the reference."""
    from bench.reference import inception as ref
    config, lane = run.config, run.traffic["lane"]
    x = gen.draw_images(config, run.traffic, run.seed, device)[0]
    want = ref.forward(config, lane, run.seed, x)
    low = (ref.forward(config, lane, run.seed, x, bits=4)
           if lane == "smm_kernel" else
           ref.forward(config, lane, run.seed, x, tf32=True))
    return {"out_rel_gap": rel_gap(low, want)}
