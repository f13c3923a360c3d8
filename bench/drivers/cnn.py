"""Driver of the CNN cells: ``repro_torch.api.compile`` on the cell's
lane, one compiled model a block of the configuration, a closed loop of
requests through the blocks' ``CompiledModel.run``, and the comparison of
sampled outputs with the plain reference.

The program convolves VALID only and does not pool, so the harness puts
each block's input on its zero border and max-pools between blocks
(:class:`Chain`): a request is the blocks' models in turn.

Set-up: the weights drawn from the seed on the device, the program's
offline encoder (host), the image pool, and warm-up requests on the
pool's batches (the first decodes the bitstreams and packs the kernel
operands).  The window: one client sends a request, waits for the device
to finish it, and sends the next, until ``--seconds`` have passed; the
request that crosses the line is the window's last.  After the window
the program's model is freed and the reference is run on the sampled
requests' images, one request at a time.
"""
from __future__ import annotations

import math
import random
import time

from bench import trace as tr
from bench.generators import cnn as gen

__all__ = ["Chain", "drive", "control"]


def drive(run, *, device: str, t_start: float, build=None) -> None:
    """Fill ``run`` (a :class:`bench.harness.Run`): set-up, window,
    counters, memory peak and the correctness checks.  ``build`` replaces
    the program's model for the harness's own tests (a fault planted
    under the timed path)."""
    import torch

    import repro_torch.api as codr
    from bench.reference import cnn as ref

    config, traffic, cell = run.config, run.traffic, run.cell_file
    lane = traffic["lane"]
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the CNN driver runs one closed-loop client")
    t_imports = time.perf_counter()
    n_layers = len(config["conv_layers"])
    blocks = gen.blocks(config)
    models = []
    for blk in blocks:
        spec = codr.ModelSpec([codr.LayerSpec.conv(
            gen.draw_layer(config, run.seed, i, device).cpu().numpy(),
            stride=config["conv_layers"][i][4],
            activation=config["activation"], name=f"conv{i}")
            for i in blk["layers"]])
        models.append(codr.compile(spec, codr.EncodeConfig(
            n_unique=int(config["n_unique"])), backend=lane, device=device))
        del spec
    t_compiled = time.perf_counter()
    batch = int(traffic["images_per_request"])
    compiled = Chain(models, blocks, config, batch, device)
    model = compiled if build is None else build(compiled)
    pool = gen.draw_images(config, traffic, run.seed, device)
    run.shapes = {"batch": batch, "layers": gen.layer_shapes(config),
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
        f"program's encode {t_compiled - t_imports:.2f} s, images and "
        f"counts {t_warm - t_compiled:.2f} s, warm-up "
        f"{time.perf_counter() - t_warm:.2f} s")

    keep = int(traffic["sampled_requests"])
    rng = random.Random(gen.derive(run.seed, 3))
    sampled: list = []                      # (request index, output)
    req_ms, enq_ms = [], []
    seconds = run.seconds

    def window():
        t_w0 = time.perf_counter()
        t_end = t_w0
        i = 0
        while t_end - t_w0 < seconds:
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
    del model, compiled, models
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    gap = 0.0
    for i, y in sampled:
        x = pool[i % len(pool)]
        want = ref.forward(config, lane, (gen.draw_layer(
            config, run.seed, k, device) for k in range(n_layers)), x)
        gap = max(gap, rel_gap(y, want))
        del want
    if not sampled:
        gap = float("inf")
    run.check("out_rel_gap", gap, float(cell["limits"]["out_rel_gap"]))


class Chain:
    """The timed path of a request: the blocks' compiled models in turn,
    each later block's input the last one's output max-pooled into the
    interior of a zero-bordered buffer (its border never written).
    ``run(x)`` takes the first block's input, border included."""

    def __init__(self, models, blocks, config, batch: int, device):
        import torch
        self.models, self.blocks = models, blocks
        self.bufs = [None]
        for blk in blocks[1:]:
            hw = blk["plane"] + 2 * blk["border"]
            c_in = config["conv_layers"][blk["layers"][0]][1]
            self.bufs.append(torch.zeros((batch, hw, hw, c_in),
                                         device=device))

    def run(self, x):
        import torch.nn.functional as F
        for k, (model, blk) in enumerate(zip(self.models, self.blocks)):
            if k:
                p, hw = blk["border"], blk["plane"]
                buf = self.bufs[k][:x.shape[0]]
                pooled = F.max_pool2d(x.permute(0, 3, 1, 2),
                                      self.blocks[k - 1]["pool"])
                buf[:, p:p + hw, p:p + hw, :].copy_(pooled.permute(0, 2, 3, 1))
                x = buf
            x = model.run(x)
        return x


def rel_gap(y, want) -> float:
    """Largest absolute difference of two outputs over the largest
    magnitude of the reference's (``inf`` where the shapes differ)."""
    if tuple(y.shape) != tuple(want.shape):
        return float("inf")
    scale = float(want.abs().max()) or 1.0
    gap = float((y.double() - want).abs().max()) / scale
    return gap if math.isfinite(gap) else float("inf")



def control(run, device: str) -> dict:
    """The control's reading at the cell's size: the reference in the
    program's place one precision below the lane's (int4 features for the
    int8 path of ``smm_kernel``; TF32 for the float32 path of ``tiled``),
    on the first batch of the run's image pool, against the reference."""
    from bench.reference import cnn as ref
    config, lane = run.config, run.traffic["lane"]
    x = gen.draw_images(config, run.traffic, run.seed, device)[0]

    def weights():
        return (gen.draw_layer(config, run.seed, k, device)
                for k in range(len(config["conv_layers"])))
    want = ref.forward(config, lane, weights(), x)
    low = (ref.forward(config, lane, weights(), x, bits=4)
           if lane == "smm_kernel" else
           ref.forward(config, lane, weights(), x, tf32=True))
    return {"out_rel_gap": rel_gap(low, want)}
