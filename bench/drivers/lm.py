"""Driver of the language-model cells: ``repro_torch.api.compile_params``
on the cell's lane, ``core.batching.ContinuousBatcher`` serving a closed
loop of clients, and the comparison of sampled served tokens with the
plain reference.

Set-up: the float parameters drawn from the seed on the device, the
program's encoder (4-bit packs on the card), the batcher, and the first
population: every client submits its first request, whose output length
is drawn over 1 … its length so that completions are staggered, and the
window opens once each of them has its first token and the pooled step
has been captured and replayed.  The window: each client thread streams
its request's tokens, stamping each on arrival, and submits its next
request when one finishes, until ``--seconds`` have passed; then the
batcher is stopped, cancelling what is in flight.  After the window the
program's state is freed and the reference runs over a sample of the
requests finished in the window (the longest among them), one leaf of
the model at a time.
"""
from __future__ import annotations

import math
import random
import threading
import time

from bench import roofline
from bench import trace as tr
from bench.generators import lm as gen

__all__ = ["drive", "control", "model_config", "served_gaps"]


def model_config(c: dict):
    """The port's ``ModelConfig`` for a DeepSeek-V2-style configuration
    file (catalog keys)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["qk_nope_head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), act=c["hidden_act"],
        use_mla=True, q_lora_rank=c["q_lora_rank"],
        kv_lora_rank=c["kv_lora_rank"], nope_head_dim=c["qk_nope_head_dim"],
        rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        n_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"],
        moe_top_k=c["num_experts_per_tok"],
        moe_d_ff=c["moe_intermediate_size"],
        moe_every=c["moe_layer_freq"],
        n_dense_layers=c["first_k_dense_replace"])


class _Client(threading.Thread):
    """One closed-loop client: submit, stream, stamp, submit again."""

    def __init__(self, idx, batcher, reqs, stop, trace_on):
        super().__init__(name=f"bench-client-{idx}", daemon=True)
        self.idx, self.batcher, self.reqs = idx, batcher, reqs
        self.stop, self.trace_on = stop, trace_on
        self.submitted = threading.Event()   # set at the first submit
        self.first_token = threading.Event()  # set at the first token
        self.done: list = []                 # finished or failed requests
        self.current = None

    def run(self):
        j = 0
        while not self.stop.is_set():
            prompt, n_out = self.reqs.get(self.idx, j)
            rec = {"client": self.idx, "j": j, "prompt": prompt,
                   "n_out": n_out, "times": [], "tokens": None,
                   "failed": False, "end": None}
            self.current = rec
            with tr.mark("submit", self.trace_on):
                rec["submit"] = time.perf_counter()
                handle = self.batcher.submit(prompt, max_new_tokens=n_out)
            self.submitted.set()
            try:
                for _ in handle:
                    rec["times"].append(time.perf_counter())
                    if j == 0 and len(rec["times"]) == 1:
                        self.first_token.set()
            except Exception:            # noqa: BLE001 — recorded below
                if self.stop.is_set():
                    return               # cancelled at the window's end
                rec["failed"] = True
            rec["end"] = time.perf_counter()
            rec["tokens"] = handle.tokens
            self.done.append(rec)
            self.current = None
            j += 1


def drive(run, *, device: str, t_start: float, build=None) -> None:
    """Fill ``run``: set-up, window, counters, memory peak and the
    correctness check.  ``build`` wraps the program's batcher for the
    harness's own tests (a fault planted under the timed path)."""
    import torch

    import repro_torch.api as codr
    from repro_torch.core.batching import ContinuousBatcher

    c, traffic, cell = run.config, run.traffic, run.cell_file
    cfg = model_config(c)
    cp = codr.compile_params(gen.draw_params(c, run.seed, device),
                             codr.EncodeConfig(n_unique=int(c["n_unique"])),
                             backend=traffic["lane"], accounting=False,
                             device=device)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    reqs = gen.Requests(traffic, c["vocab_size"], run.seed)
    n_slots = int(traffic["n_slots"])
    batcher = ContinuousBatcher(cp, cfg, n_slots=n_slots,
                                max_len=reqs.max_len, eos_id=None,
                                device=device)
    served = batcher if build is None else build(batcher)
    run.shapes = {"n_slots": n_slots,
                  "step_matmuls": roofline.mla_moe_step_matmuls(c),
                  "bits": 4 if int(c["n_unique"]) <= 16 else 8,
                  "params_per_token": roofline.mla_moe_params_per_token(c)}

    stop = threading.Event()
    clients = [_Client(i, served, reqs, stop, run.trace_on)
               for i in range(int(traffic["clients"]))]
    box: dict = {}

    def halt():
        """End every thread this run started: the clients and the
        batcher's worker, cancelling what is in flight."""
        stop.set()
        batcher.stop_async(drain=False)
        for cl in clients:
            if cl.is_alive():
                cl.join(timeout=120)
        if any(cl.is_alive() for cl in clients):
            raise RuntimeError("a client did not stop")
    try:
        _serve(run, batcher, clients, reqs, box, t_start, device, halt)
    finally:
        halt()
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if device.startswith("cuda") else 0)
    _account(run, clients, box, n_slots)

    t0, t1 = box["t0"], box["t1"]
    finished = [r for cl in clients for r in cl.done
                if not r["failed"] and r["end"] is not None
                and t0 <= r["end"] <= t1]
    sample = _sample(finished, int(traffic["sampled_requests"]), run.seed)
    run.sample = sample
    del served, batcher, cp, clients
    if device.startswith("cuda"):
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    limits = cell["limits"]
    gaps = served_gaps(c, run.seed, device, sample)["served"] if sample \
        else [[math.inf]]
    flat = [g for row in gaps for g in row]
    run.work["checked_tokens"] = len(flat) if sample else 0
    run.check("served_logit_gap", max(flat),
              float(limits["served_logit_gap"]))
    run.check("served_tokens_off", off_share(flat, cell["off_gap"]),
              float(limits["served_tokens_off"]))


def off_share(gaps, off_gap: float) -> float:
    """Share of tokens whose logit lies more than ``off_gap`` below the
    reference's best at its position."""
    return sum(g > off_gap for g in gaps) / len(gaps)


def _serve(run, batcher, clients, reqs, box, t_start, device,
           halt) -> None:
    """Fill the pool (the first population, submitted in the order of its
    sizes' positions, whichever clients the seed dealt them to: the pool
    is filled in the same order for every seed), open the window, serve
    until it closes, and ``halt``."""
    import torch
    for cl in sorted(clients, key=lambda cl: reqs.position(cl.idx)):
        cl.start()
        if not cl.submitted.wait(timeout=600):
            raise RuntimeError(f"client {cl.idx} did not submit")
    for cl in clients:
        if not cl.first_token.wait(timeout=600):
            raise RuntimeError(f"client {cl.idx}'s first request had no "
                               f"token in 600 s")
    deadline = time.perf_counter() + 600
    while batcher.steps_run < 2:
        if time.perf_counter() > deadline:
            raise RuntimeError("the pooled step never ran twice")
        time.sleep(0.005)
    run.open_window(t_start)

    def window():
        box["steps0"], box["prefills0"] = (batcher.steps_run,
                                           batcher.prefills_run)
        box["t0"] = time.perf_counter()
        time.sleep(run.seconds)
        box["t1"] = time.perf_counter()
        box["steps1"], box["prefills1"] = (batcher.steps_run,
                                           batcher.prefills_run)
        return box["t1"] - box["t0"]

    if run.trace_on:
        run.window_s, run.trace = tr.record(
            window, sync=(torch.cuda.synchronize
                          if device.startswith("cuda") else (lambda: None)),
            after=halt)
    else:
        run.window_s = window()
        halt()


def _account(run, clients, box, n_slots) -> None:
    """Rates, tails and counts of the window from the clients' stamps."""
    t0, t1 = box["t0"], box["t1"]
    inside = lambda t: t0 <= t <= t1  # noqa: E731
    recs = [r for cl in clients for r in cl.done]
    recs += [cl.current for cl in clients if cl.current is not None]
    itl, ttft = [], []
    out = first = prompt_tok = 0
    for r in recs:
        ts = r["times"]
        out += sum(inside(t) for t in ts)
        itl += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])
                if inside(a) and inside(b)]
        if ts and inside(ts[0]):
            first += 1
            prompt_tok += len(r["prompt"])
            ttft.append((ts[0] - r["submit"]) * 1e3)
    ended = [r for r in recs if r["end"] is not None and inside(r["end"])]
    run.attempted = len(ended)
    run.failed = sum(r["failed"] for r in ended)
    run.samples = {"itl_ms": itl, "ttft_ms": ttft}
    run.work = {"tokens_out": out, "first_tokens": first,
                "prompt_tokens": prompt_tok}
    run.counters = {"steps_run": box["steps1"] - box["steps0"],
                    "prefills_run": box["prefills1"] - box["prefills0"],
                    "n_slots": n_slots}


def _sample(finished: list, k: int, seed: int) -> list:
    """``k`` finished requests drawn from the seed, the one with the most
    served tokens among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r["tokens"]), r["client"]))
    rest = [r for r in finished if r is not longest]
    rng = random.Random(gen.derive(seed, 12))
    return [longest] + rng.sample(rest, min(k - 1, len(rest)))


def served_gaps(c: dict, seed: int, device, sample, *,
                control: bool = False) -> dict:
    """Per-token gaps, one list a sampled request: ``"served"``, the gap
    by which each served token's logit lies below the reference's best
    at its position.  With ``control``: ``"control"``, the gap of the
    token that the reference in float8 activations puts first at each
    position, and ``"altered"``, the gap of one served token a request
    altered where it is produced (the next id in the vocabulary, at a
    position drawn from the seed)."""
    import torch

    from bench.reference.mla_moe import Reference, dequantize_
    specs = gen.leaf_specs(c)
    index = {spec[0]: i for i, spec in enumerate(specs)}

    def leaf(path):
        i = index[path]
        w = gen.draw_leaf(specs[i], seed, i, device)
        return dequantize_(w, int(c["n_unique"])) if w.dim() >= 2 else w

    seqs, pos, served = [], [], []
    for r in sample:
        p, toks = r["prompt"], r["tokens"]
        seq = list(p) + list(toks[:-1])
        seqs.append(torch.tensor(seq, dtype=torch.int64, device=device))
        pos.append(torch.arange(len(p) - 1, len(seq), device=device))
        served.append(torch.tensor(toks, dtype=torch.int64, device=device))
    ref = Reference(c, leaf).logits(seqs, pos)

    def gap(lg, toks):
        return (lg.max(-1).values - lg.gather(-1, toks[:, None])[:, 0]
                ).tolist()
    out = {"served": [gap(lg, t) for lg, t in zip(ref, served)]}
    if control:
        low = Reference(c, leaf, act="fp8").logits(seqs, pos)
        out["control"] = [gap(lg, lo.argmax(-1))
                          for lg, lo in zip(ref, low)]
        rng = random.Random(gen.derive(seed, 13))
        out["altered"] = []
        for lg, t in zip(ref, served):
            k = rng.randrange(len(t))
            bad = t.clone()
            bad[k] = (bad[k] + 1) % lg.shape[-1]
            out["altered"].append([gap(lg[k:k + 1], bad[k:k + 1])[0]])
    return out


def control(run, device: str) -> dict:
    """The control's readings on the run's own sample: the reference with
    every matrix product's activations in float8 e4m3, one precision
    below the served bf16, teacher-forced on the same prompts and served
    tokens; at each position the gap of the token it puts first.  Beside
    it, the fault of one served token altered where it is produced."""
    if not run.sample:
        return {}
    g = served_gaps(run.config, run.seed, device, run.sample, control=True)
    flat = {k: [x for row in v for x in row] for k, v in g.items()}
    return {"served_logit_gap": max(flat["control"]),
            "served_tokens_off": off_share(flat["control"],
                                           run.cell_file["off_gap"]),
            "fault_token_altered": min(flat["altered"]),
            "tails": {"program": _tails(g["served"]),
                      "control": _tails(g["control"])}}


def _tails(gaps) -> dict:
    """How a set of per-token gaps is spread: count, share above zero and
    above 0.05 / 0.1 / 0.2, mean, 99th percentile, max."""
    from bench.stats import percentile
    g = [x for row in gaps for x in row]
    n = len(g)
    return {"n": n, "mean": sum(g) / n, "p99": percentile(g, 99.0),
            "max": max(g),
            **{f"above_{t}": sum(x > t for x in g) / n
               for t in (0.0, 0.05, 0.1, 0.2)}}
