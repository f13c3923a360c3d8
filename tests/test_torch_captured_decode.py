"""The decode step captured as a CUDA graph
(``repro_torch.models.lm.CapturedDecode``), the port's counterpart of the
reference's ``jax.jit(decode_step)``.

On the CPU: the entry points keep the eager step (a capture needs a
card, and ``CapturedDecode`` refuses the CPU).  On the card (``cuda``
marker; skipped here with the reason): the replayed step equals the
eager step bit for bit at every step of ``greedy_decode`` (``run_serve``'s
loop) and of the batcher's pooled run on the dense, bf16-paged and
int8-paged pools, every request still equals its solo reference,
binding a new cache forces a new capture, and the launch counters tick
in the warm-up only; the same replayed == eager for the smoke
deepseek-v2-236b (a prologue MLA layer, then MLA + MoE: the routing,
the grouped expert compute and the decode of the expert stacks all run
inside the graph); for the smoke SSM models jamba-v0.1-52b and
xlstm-350m (the warm-up step does not advance the recurrent state
twice) and, over its padded prefill cache, seamless-m4t-medium.  The
smoke variant of
qwen2.5-3b with three layers, weights from a seeded generator, packed
onto ``codr_matmul``.  Nothing here imports JAX, so on the card:

    python -m pytest -q --noconftest -m cuda tests/test_torch_captured_decode.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.api as codr
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.batching import ContinuousBatcher
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import get_model
from repro_torch.models import lm

T = 300
POOLS = {"dense": {}, "bf16-paged": dict(kv_page_size=4),
         "int8-paged": dict(kv_dtype="int8", kv_page_size=4)}


def _model(device, arch="qwen2.5-3b", n_layers=3):
    cfg = smoke_variant(get_config(arch))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    api = get_model(cfg)
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
    cp = codr.compile_params(params, codr.EncodeConfig(n_unique=16),
                             backend="codr_matmul", accounting=False,
                             device=device)
    return cfg, api, cp.params


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


# ---------------------------------------------------------------------------
# the CPU keeps the eager step
# ---------------------------------------------------------------------------

def test_captured_decode_refuses_the_cpu():
    cfg, api, params = _model("cpu")
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        lm.CapturedDecode(params, cache, cfg, 2, device="cpu")


def test_cpu_entry_points_run_the_eager_step(monkeypatch):
    """``greedy_decode`` and the batcher build no graph for CPU tensors."""
    def refuse(*a, **k):
        raise AssertionError("a CPU caller built a CapturedDecode")
    monkeypatch.setattr(lm, "CapturedDecode", refuse)
    cfg, api, params = _model("cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 3)))
    gen, _, n = greedy_decode(api, params, tokens, cfg, 2)
    assert gen.shape == (2, 2) and n == 4
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=16, device="cpu")
    assert cb._graph is None
    (p,) = _prompts(cfg, [4], seed=3)
    assert cb.submit(p, max_new_tokens=3).result(timeout=T) == \
        cb.generate_reference(p, max_new_tokens=3)[0]
    cb.stop_async()


def test_scratch_pool_keeps_an_owners_buffers_apart():
    """Inside ``scratch_pool`` the split-K scratch lives in the owner's
    dict (per thread), and the module's per-stream buffers are left as
    they were; the block's end restores the outer pool."""
    import threading

    from repro_torch.kernels.codr_matmul import ops
    dev = torch.device("cpu")
    before = dict(ops._scratch)
    outer, inner, seen = {}, {}, {}
    with ops.scratch_pool(outer):
        ops._split_scratch(dev, 7, 10, 100)
        with ops.scratch_pool(inner):
            counters, partials = ops._split_scratch(dev, 7, 2000, 300)
        t = threading.Thread(target=lambda: seen.setdefault(
            "pool", getattr(ops._local, "pool", None)))
        t.start()
        t.join()
        grown = ops._split_scratch(dev, 7, 10, 5000)
    assert seen["pool"] is None
    assert ops._scratch == before
    assert list(outer) == list(inner) == [(None, 7)]
    assert counters.numel() == 2048 and partials.numel() == 300
    assert not counters.any()
    assert outer[(None, 7)][0].numel() == 1024 + 5000
    assert grown[1].numel() == 5000


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed on the card; the CPU runs the eager step)")
    return _model("cuda")


def _step_logits(api, params, tokens, cfg, gen_len, *, captured: bool):
    """``greedy_decode``'s loop, a copy of every step's logits kept:
    ``decode_step`` eagerly, or a ``CapturedDecode`` replayed."""
    batch, prompt_len = tokens.shape
    total = prompt_len + gen_len
    cache = api.init_cache(cfg, batch, total, device=tokens.device)
    step = lm.CapturedDecode(params, cache, cfg, batch) if captured else None
    rows, tok = [], tokens[:, 0]
    for i in range(total - 1):
        if step is None:
            logits, cache = api.decode_step(params, cache, tok, i, cfg)
        else:
            logits = step(tok, i)
        rows.append(logits.clone())
        tok = (tokens[:, i + 1] if i + 1 < prompt_len
               else torch.argmax(logits, dim=-1))
    return rows


@pytest.mark.cuda
def test_cuda_greedy_decode_replay_equals_eager(cuda_model):
    cfg, api, params = cuda_model
    tokens = torch.randint(0, cfg.vocab_size, (4, 6), device="cuda",
                           generator=torch.Generator(device="cuda"
                                                     ).manual_seed(1))
    g_eager, _, n_eager = greedy_decode(api, params, tokens, cfg, 7,
                                        eager=True)
    g_replay, _, n_replay = greedy_decode(api, params, tokens, cfg, 7)
    assert n_eager == n_replay == 12
    assert torch.equal(g_eager, g_replay)
    eager = _step_logits(api, params, tokens, cfg, 7, captured=False)
    replay = _step_logits(api, params, tokens, cfg, 7, captured=True)
    assert len(eager) == len(replay) == 12
    for i, (a, b) in enumerate(zip(eager, replay)):
        assert torch.equal(a, b), f"step {i}"


@pytest.mark.cuda
def test_cuda_counters_tick_at_launches_only(cuda_model):
    """The warm-up step launches and counts; the capture records
    (``ops.captured``) and launches nothing; a replay calls no wrapper."""
    from repro_torch.kernels.codr_matmul import ops
    cfg, api, params = cuda_model
    per_step = 7 * cfg.n_layers
    step = lm.CapturedDecode(params, api.init_cache(cfg, 2, 8), cfg, 2)
    tok = torch.tensor([5, 9], device="cuda")
    ops.launches, ops.captured = 0, 0
    step(tok, 0)
    assert (ops.launches, ops.captured) == (per_step, per_step)
    step(tok, 1)
    step(tok, 2)
    torch.cuda.synchronize()
    assert (ops.launches, ops.captured) == (per_step, per_step)
    assert step.replays == 3 and step._scratch
    assert all(buf.data_ptr() != v[0].data_ptr()
               for buf, _ in step._scratch.values()
               for v in ops._scratch.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", list(POOLS.values()), ids=list(POOLS))
def test_cuda_pooled_replay_equals_eager_and_solo(cuda_model, kv):
    cfg, _, params = cuda_model
    prompts = _prompts(cfg, [3, 7, 5, 9, 4], seed=5)
    runs = {}
    for mode in ("eager", "captured"):
        cb = ContinuousBatcher(params, cfg, n_slots=3, max_len=24,
                               record_logits=True, eager=mode == "eager",
                               **kv)
        handles = [cb.submit(p, max_new_tokens=6) for p in prompts]
        runs[mode] = (cb, handles, [h.result(timeout=T) for h in handles])
        cb.stop_async()
    cb, handles, outs = runs["captured"]
    assert cb._graph.captures == 1 and cb._graph.replays == cb.steps_run
    _, e_handles, e_outs = runs["eager"]
    assert outs == e_outs
    for h, e in zip(handles, e_handles):
        for a, b in zip(h.logits, e.logits):
            np.testing.assert_array_equal(a, b)
    for p, h, out in zip(prompts, handles, outs):
        ref, rows = cb.generate_reference(p, max_new_tokens=6,
                                          record_logits=True)
        assert out == ref
        for a, b in zip(h.logits, rows):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_rebinding_forces_a_new_capture(cuda_model):
    cfg, api, params = cuda_model
    tok = torch.tensor([5, 9], device="cuda")

    def fresh():
        return api.init_cache(cfg, 2, 8, device="cuda")
    step = lm.CapturedDecode(params, fresh(), cfg, 2)
    step(tok, 0)
    step(tok, 1)
    assert step.captures == 1 and step.replays == 2
    step.bind(fresh())
    got = step(tok, 0).clone()
    assert step.captures == 2
    want, _ = api.decode_step(params, fresh(), tok, 0, cfg)
    assert torch.equal(got, want)
    assert torch.equal(step(tok, 1), api.decode_step(
        params, api.decode_step(params, fresh(), tok, 0, cfg)[1], tok, 1,
        cfg)[0])
    assert step.captures == 2 and step.replays == 4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [{}, *POOLS.values()],
                         ids=["greedy", *POOLS])
def test_cuda_deepseek_replay_equals_eager(kv):
    """The smoke deepseek-v2-236b with two MoE layers: ``greedy_decode``
    (``{}``) and the batcher on each pool, replayed == eager bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed on the card; the CPU runs the eager step)")
    cfg, api, params = _model("cuda", "deepseek-v2-236b", n_layers=3)
    if not kv:
        tokens = torch.randint(0, cfg.vocab_size, (4, 5), device="cuda",
                               generator=torch.Generator(device="cuda"
                                                         ).manual_seed(2))
        eager = _step_logits(api, params, tokens, cfg, 6, captured=False)
        replay = _step_logits(api, params, tokens, cfg, 6, captured=True)
        assert len(eager) == len(replay) == 10
        for i, (a, b) in enumerate(zip(eager, replay)):
            assert torch.equal(a, b), f"step {i}"
        return
    prompts = _prompts(cfg, [3, 7, 5, 9], seed=6)
    runs = {}
    for mode in ("eager", "captured"):
        cb = ContinuousBatcher(params, cfg, n_slots=3, max_len=24,
                               record_logits=True, eager=mode == "eager",
                               **kv)
        handles = [cb.submit(p, max_new_tokens=5) for p in prompts]
        runs[mode] = (cb, handles, [h.result(timeout=T) for h in handles])
        cb.stop_async()
    cb, handles, outs = runs["captured"]
    assert cb._graph.captures == 1 and cb._graph.replays == cb.steps_run
    _, e_handles, e_outs = runs["eager"]
    assert outs == e_outs
    for h, e in zip(handles, e_handles):
        for a, b in zip(h.logits, e.logits):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cuda_ssm_replay_equals_eager(arch):
    """The smoke SSM models (jamba: seven mamba layers, attention and
    MoE; xlstm: mLSTM and sLSTM): ``greedy_decode``'s loop replayed
    equals eager bit for bit at every step, so the capture's eager
    warm-up step does not advance the recurrent state a second time; the
    batcher's dense pool too, captured == eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed on the card; the CPU runs the eager step)")
    cfg, api, params = _model("cuda", arch, n_layers=None)
    tokens = torch.randint(0, cfg.vocab_size, (4, 5), device="cuda",
                           generator=torch.Generator(device="cuda"
                                                     ).manual_seed(3))
    eager = _step_logits(api, params, tokens, cfg, 6, captured=False)
    replay = _step_logits(api, params, tokens, cfg, 6, captured=True)
    assert len(eager) == len(replay) == 10
    for i, (a, b) in enumerate(zip(eager, replay)):
        assert torch.equal(a, b), f"step {i}"
    prompts = _prompts(cfg, [3, 7, 5, 9], seed=7)
    runs = {}
    for mode in ("eager", "captured"):
        cb = ContinuousBatcher(params, cfg, n_slots=3, max_len=24,
                               record_logits=True, eager=mode == "eager")
        handles = [cb.submit(p, max_new_tokens=5) for p in prompts]
        runs[mode] = (cb, handles, [h.result(timeout=T) for h in handles])
        cb.stop_async()
    cb, handles, outs = runs["captured"]
    assert cb._graph.captures == 1 and cb._graph.replays == cb.steps_run
    _, e_handles, e_outs = runs["eager"]
    assert outs == e_outs
    for h, e in zip(handles, e_handles):
        for a, b in zip(h.logits, e.logits):
            np.testing.assert_array_equal(a, b)
    for p, out in zip(prompts, outs):
        assert out == cb.generate_reference(p, max_new_tokens=5)[0]


@pytest.mark.cuda
def test_cuda_encdec_replay_equals_eager():
    """seamless-m4t-medium's smoke variant: ``encdec_decode`` (``run_serve``'s
    enc-dec loop over the padded prefill cache) replayed equals eager in
    tokens and per-step logits; the cross half is only read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed on the card; the CPU runs the eager step)")
    from repro_torch.launch.serve import encdec_decode, pad_self_cache
    cfg, api, params = _model("cuda", "seamless-m4t-medium", n_layers=None)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 5),
                                     device="cuda", generator=gen),
             "prefix": torch.randn((4, cfg.frontend_seq, cfg.d_model),
                                   device="cuda", generator=gen)}
    outs, crosses = [], []
    for eager in (True, False):
        logits, cache = api.prefill(params, batch, cfg)
        cache = pad_self_cache(cache, 5 + 6)
        cross = [t.clone() for t in cache["cross"]]
        gen_tok, cache, n = encdec_decode(api, params, cache, logits, cfg,
                                          5, 6, eager=eager)
        assert n == 5
        assert all(torch.equal(a, b) for a, b in zip(cache["cross"], cross))
        outs.append((gen_tok, [t.clone() for t in cache["self"]]))
    (e_tok, e_self), (r_tok, r_self) = outs
    assert torch.equal(e_tok, r_tok)
    assert all(torch.equal(a, b) for a, b in zip(e_self, r_self))
