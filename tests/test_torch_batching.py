"""The port's continuous batcher (``repro_torch.core.batching``) on the
CPU, mirroring ``tests/test_continuous_batching.py``: per-request
bit-identity to solo decode (no cross-slot leakage), join-mid-stream,
EOS retirement freeing slots, the join-deadline trigger, streaming,
stop/drain, a worker crash failing every handle with ``WorkerCrashed``,
and a request admitted after a failed pooled step still equal to its
solo reference (the port writes the pool in place, so that step has
already written some layers' rows).

Bit-exactness holds inside the port; against JAX the prompt-replay of
``run_serve_continuous`` is compared by keys and by its own check.
The smoke variant of qwen2.5-3b (three layers where a step must fail
midway), params made by JAX and carried over.
"""
import dataclasses
import threading
import time
from concurrent import futures

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.batching import ContinuousBatcher
from repro_torch.launch.serve import run_serve_continuous
from repro_torch.models import attention as tattn
from repro_torch.models import get_model
from repro_torch.runtime.resilience import (DeadlineExceeded, RejectedError,
                                            WorkerCrashed)

ARCH = "qwen2.5-3b"
T = 120


def _params(n_layers=None):
    jcfg = jsmoke(jget_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return tcfg, convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def setup():
    return _params()


@pytest.fixture(scope="module")
def setup3():
    return _params(n_layers=3)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _batcher(setup, **kw):
    cfg, params = setup
    return ContinuousBatcher(params, cfg, device="cpu", **kw)


def test_cache_slot_helpers_roundtrip(setup):
    cfg, _ = setup
    from repro_torch.models.cache import diff_axes, read_slot, write_slot
    from repro_torch.core.tree import leaves_with_path, map_leaves

    api = get_model(cfg)
    axes = diff_axes(api.init_cache(cfg, 1, 16, device="meta"),
                     api.init_cache(cfg, 2, 16, device="meta"))
    assert [a for _, a in leaves_with_path(axes)] == [1, 1]
    pool = api.init_cache(cfg, 3, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    one = map_leaves(lambda l: torch.randn(l.shape, generator=gen).to(
        l.dtype), api.init_cache(cfg, 1, 16, device="cpu"))
    write_slot(pool, one, 1, axes)
    back = read_slot(pool, 1, axes)
    for (_, a), (_, b) in zip(leaves_with_path(one), leaves_with_path(back)):
        assert torch.equal(a, b)
    for _, leaf in leaves_with_path(read_slot(pool, 0, axes)):
        assert not leaf.any()
    short = map_leaves(torch.ones_like,
                       api.init_cache(cfg, 1, 5, device="cpu"))
    write_slot(pool, short, 2, axes)
    k2 = read_slot(pool, 2, axes)["stack"]["b0"][0]
    assert bool((k2[:, :, :5] == 1).all()) and not k2[:, :, 5:].any()
    with pytest.raises(ValueError, match="one differing axis"):
        diff_axes(api.init_cache(cfg, 1, 16, device="meta"),
                  api.init_cache(cfg, 1, 16, device="meta"))


def test_no_cross_slot_leakage_bit_identical_to_solo(setup):
    cb = _batcher(setup, n_slots=4, max_len=32, record_logits=True)
    prompts = _prompts(setup[0], [3, 5, 4, 7])
    handles = [cb.submit(p, max_new_tokens=6) for p in prompts]
    outs = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    for p, h, out in zip(prompts, handles, outs):
        ref_toks, ref_rows = cb.generate_reference(
            p, max_new_tokens=6, record_logits=True)
        assert out == ref_toks
        assert h.finish_reason == "length"
        assert len(h.logits) == len(ref_rows)
        for got, ref in zip(h.logits, ref_rows):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("backend", ["tiled", "codr_matmul"])
def test_packed_params_bit_identical_to_solo(setup, backend):
    cfg, params = setup
    import repro_torch.api as codr
    compiled = codr.compile_params(params, codr.EncodeConfig(n_unique=16),
                                   backend=backend, accounting=False,
                                   device="cpu")
    cb = ContinuousBatcher(compiled, cfg, n_slots=3, max_len=24,
                           device="cpu")
    prompts = _prompts(cfg, [4, 6, 5], seed=1)
    handles = [cb.submit(p, max_new_tokens=4) for p in prompts]
    outs = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    for p, out in zip(prompts, outs):
        ref_toks, _ = cb.generate_reference(p, max_new_tokens=4)
        assert out == ref_toks


def test_join_mid_stream(setup):
    cb = _batcher(setup, n_slots=2, max_len=32)
    p1, p2 = _prompts(setup[0], [4, 6], seed=2)
    h1 = cb.submit(p1, max_new_tokens=10)
    it = iter(h1)
    first = [next(it) for _ in range(3)]
    h2 = cb.submit(p2, max_new_tokens=5)
    rest = list(it)
    out2 = h2.result(timeout=T)
    cb.stop_async()
    assert first + rest == cb.generate_reference(p1, max_new_tokens=10)[0]
    assert out2 == cb.generate_reference(p2, max_new_tokens=5)[0]


def test_eos_retirement_frees_slot(setup):
    cb = _batcher(setup, n_slots=1, max_len=32)
    prompt = _prompts(setup[0], [5], seed=3)[0]
    ref, _ = cb.generate_reference(prompt, max_new_tokens=8)
    eos = ref[2]
    h = cb.submit(prompt, max_new_tokens=8, eos_id=eos)
    out = h.result(timeout=T)
    assert h.finish_reason == "eos"
    assert out == ref[:ref.index(eos) + 1]
    h2 = cb.submit(prompt, max_new_tokens=4)
    assert h2.result(timeout=T) == ref[:4]
    assert cb.requests_finished == 2
    cb.stop_async()


def test_join_deadline_half_full_pool(setup):
    cb = _batcher(setup, n_slots=4, max_len=32, join_deadline_s=0.05)
    prompts = _prompts(setup[0], [4, 5], seed=4)
    handles = [cb.submit(p, max_new_tokens=4) for p in prompts]
    outs = [h.result(timeout=T) for h in handles]
    assert cb.peak_active == 2
    cb.stop_async()
    for p, out in zip(prompts, outs):
        assert out == cb.generate_reference(p, max_new_tokens=4)[0]


def test_prompt_too_long_and_exact_fit(setup):
    cb = _batcher(setup, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="empty"):
        cb.submit(np.zeros((0,), np.int32))
    prompt = _prompts(setup[0], [12], seed=8)[0]
    h = cb.submit(prompt, max_new_tokens=4)        # 12 + 4 == 16: fits
    out = h.result(timeout=T)
    cb.stop_async()
    assert out == cb.generate_reference(prompt, max_new_tokens=4)[0]
    with pytest.raises(ValueError,
                       match=r"prompt_len 12 \+ max_new_tokens 5 = 17"):
        cb.submit(prompt, max_new_tokens=5)


def test_worker_crash_fails_every_handle_no_hang(setup, monkeypatch):
    """A BaseException out of the pooled step (a crash, not a step
    error) escapes the worker loop: every queued and active handle
    fails with WorkerCrashed, the streamed prefix stays readable, and
    the next submit starts a fresh worker."""
    class Crash(BaseException):
        pass

    cb = _batcher(setup, n_slots=2, max_len=32)
    real, calls = cb._step_fn, []

    def step(*a):
        calls.append(1)
        if len(calls) == 3:
            raise Crash("worker died mid-generation")
        return real(*a)
    monkeypatch.setattr(cb, "_step_fn", step)
    prompts = _prompts(setup[0], [4, 5, 6], seed=9)
    handles = [cb.submit(p, max_new_tokens=12) for p in prompts]
    for h in handles:
        with pytest.raises(WorkerCrashed) as ei:
            h.result(timeout=T)
        assert isinstance(ei.value.__cause__, Crash)
    assert all(h.done() and h.finish_reason == "error" for h in handles)
    assert cb.worker_crashes == 1
    with pytest.raises(WorkerCrashed):
        list(handles[0])                     # the stream ends, too
    monkeypatch.setattr(cb, "_step_fn", real)
    for p, h in zip(prompts, handles):
        ref, _ = cb.generate_reference(p, max_new_tokens=12)
        assert h.tokens == ref[:len(h.tokens)]
    h2 = cb.submit(prompts[0], max_new_tokens=3)
    out = h2.result(timeout=T)
    cb.stop_async()
    assert out == cb.generate_reference(prompts[0], max_new_tokens=3)[0]


@pytest.mark.parametrize("kv", [{}, dict(kv_dtype="int8", kv_page_size=4)])
def test_admission_after_a_failed_step_equals_solo(setup3, monkeypatch, kv):
    """A pooled step that raises after layer 0 wrote its rows fails
    exactly its active handles; a request admitted into the same slot
    afterwards still equals its solo reference — admission overwrites
    the prompt region and (int8) resets every reserved page's scale,
    and decode masks beyond ``pos``."""
    cfg, _ = setup3
    cb = _batcher(setup3, n_slots=2, max_len=24, **kv)
    real, calls = tattn.gqa_decode, []

    def decode(*a, **k):
        calls.append(1)
        if len(calls) == 3 * 3 + 2:          # step 4, after layer 0 wrote
            raise RuntimeError("step failed midway")
        return real(*a, **k)
    monkeypatch.setattr(tattn, "gqa_decode", decode)
    p1, p2 = _prompts(cfg, [6, 9], seed=11)
    h1 = cb.submit(p1, max_new_tokens=10)
    with pytest.raises(RuntimeError, match="midway"):
        h1.result(timeout=T)
    assert h1.finish_reason == "error" and len(h1.tokens) == 4
    h2 = cb.submit(p2, max_new_tokens=8)
    out = h2.result(timeout=T)
    cb.stop_async()
    monkeypatch.setattr(tattn, "gqa_decode", real)
    assert out == cb.generate_reference(p2, max_new_tokens=8)[0]
    assert cb.requests_finished == 2


def test_stop_drain_false_cancels_and_restart(setup):
    cb = _batcher(setup, n_slots=1, max_len=64)
    prompts = _prompts(setup[0], [4, 4, 4], seed=5)
    handles = [cb.submit(p, max_new_tokens=40) for p in prompts]
    cb.stop_async(drain=False)
    for h in handles:
        with pytest.raises((futures.CancelledError, Exception)):
            h.result(timeout=T)
    assert all(h.finish_reason in ("cancelled", "error") for h in handles)
    h2 = cb.submit(prompts[0], max_new_tokens=3)
    out = h2.result(timeout=T)
    cb.stop_async()
    assert out == cb.generate_reference(prompts[0], max_new_tokens=3)[0]


def test_streaming_iteration_yields_incrementally(setup):
    cb = _batcher(setup, n_slots=1, max_len=64)
    prompt = _prompts(setup[0], [4], seed=6)[0]
    h = cb.submit(prompt, max_new_tokens=20)
    it = iter(h)
    first = next(it)
    assert not h.done()
    rest = list(it)
    assert h.done()
    assert [first] + rest == h.result(timeout=10)
    cb.stop_async()


def test_concurrent_submitters_all_served(setup):
    cb = _batcher(setup, n_slots=4, max_len=24)
    prompt = _prompts(setup[0], [4], seed=7)[0]
    handles: list = []
    lock = threading.Lock()

    def worker():
        h = cb.submit(prompt, max_new_tokens=3)
        with lock:
            handles.append(h)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive()
    outs = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    assert sorted(h.rid for h in handles) == list(range(8))
    ref, _ = cb.generate_reference(prompt, max_new_tokens=3)
    assert all(o == ref for o in outs)


def test_deadline_and_shedding(setup):
    cb = _batcher(setup, n_slots=1, max_len=64, max_pending=1)
    prompts = _prompts(setup[0], [4, 4, 4], seed=12)
    with cb._cv:                 # hold the worker off: all three queue
        h_late = cb.submit(prompts[0], max_new_tokens=2, deadline_s=1e-4)
        with pytest.raises(RejectedError):
            cb.submit(prompts[1], max_new_tokens=2)
        time.sleep(0.01)
    with pytest.raises(DeadlineExceeded):
        h_late.result(timeout=T)
    assert h_late.finish_reason == "deadline"
    assert cb.requests_shed == 1 and cb.requests_expired == 1
    cb.stop_async()


def test_configure_resilience_and_rejections(setup):
    from repro_torch.runtime.resilience import ServingSupervisor
    cb = _batcher(setup, n_slots=1, max_len=16)
    sup = ServingSupervisor(backend="sharded", device="cpu")
    assert cb.configure_resilience(supervisor=sup) is cb
    assert cb._supervisor is sup
    assert cb.configure_resilience()._supervisor is None
    for kw in ({"n_slots": 0}, {"max_len": 1}, {"max_pending": 0}):
        with pytest.raises(ValueError):
            _batcher(setup, **kw)
    cfg, params = setup
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ContinuousBatcher(params, dataclasses.replace(cfg, family="encdec"),
                          device="cpu")


# ---------------------------------------------------------------------------
# run_serve_continuous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [{}, dict(kv_page_size=4),
                                dict(kv_dtype="int8")])
def test_run_serve_continuous_returns_the_reference_keys(kv, capsys):
    from repro.launch.serve import run_serve_continuous as jrun
    kw = dict(n_requests=3, n_slots=2, prompt_len=5, gen_len=4, check=True,
              **kv)
    j = jrun(verbose=False, **kw)
    t = run_serve_continuous(device="cpu", **kw)
    assert set(t) == set(j)
    assert t["checked"] == j["checked"] == 3
    for key in ("prompt_lens", "kv_bytes", "kv_dtype", "kv_page_size",
                "prefills_run", "n_slots"):
        assert t[key] == j[key], key
    assert [len(g) for g in t["gen"]] == [4, 4, 4]
    if kv.get("kv_dtype") == "int8":
        assert t["check_dev"] < 0.10
    out = capsys.readouterr().out
    assert "continuous batching: 3 requests" in out and "check: 3/3" in out


def test_run_serve_continuous_packed(capsys):
    t = run_serve_continuous(device="cpu", n_requests=2, gen_len=3,
                             use_codr=True, check=True)
    assert t["checked"] == 2 and t["backend"] == "codr_matmul"
    assert "pack bits/weight" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# positions as a Python int and as a device tensor; retried steps
# ---------------------------------------------------------------------------

POOLS = {"dense": {}, "bf16-paged": dict(kv_page_size=4),
         "int8-paged": dict(kv_dtype="int8", kv_page_size=4)}


def _pool(cfg, kv, n_slots=2, max_len=12):
    """A pool of ``n_slots`` slots as the batcher builds it; paged pools
    get every slot a table row of live pages."""
    from repro_torch.models import cache as cache_mod
    spec = None
    if kv:
        spec = cache_mod.PagedSpec(page_size=kv["kv_page_size"],
                                   max_len=max_len, n_slots=n_slots,
                                   kv_dtype=kv.get("kv_dtype", "bf16"))
    pool = get_model(cfg).init_cache(cfg, n_slots, max_len, paged=spec,
                                     device="cpu")
    if spec is not None:
        cache_mod.set_tables(pool, 1 + np.arange(
            n_slots * spec.max_pages).reshape(n_slots, spec.max_pages))
    return pool


def _pool_bits(pool) -> list:
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.models.cache import PagedKV
    out = []
    for _, leaf in leaves_with_path(pool):
        out += list(leaf.tensors()) if isinstance(leaf, PagedKV) else [leaf]
    return [t.clone() for t in out]


@pytest.mark.parametrize("kv", list(POOLS.values()), ids=list(POOLS))
def test_int_and_tensor_positions_give_the_same_bits(setup3, kv):
    """``decode_step`` with ``pos`` a Python int (the eager callers'
    path), a 0-dim tensor and a ``(B,)`` tensor (the captured step's):
    the same logits and the same pool, bit for bit, step after step."""
    cfg, params = setup3
    api = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (6, 2)))
    pools = [_pool(cfg, kv) for _ in range(3)]
    for i in range(6):
        outs = [api.decode_step(params, pool, toks[i], pos, cfg)[0]
                for pool, pos in zip(pools, (
                    i, torch.tensor(i), torch.full((2,), i)))]
        for got in outs[1:]:
            assert torch.equal(got, outs[0]), i
        bits = [_pool_bits(p) for p in pools]
        for other in bits[1:]:
            assert all(torch.equal(a, b) for a, b in zip(bits[0], other))


@pytest.mark.parametrize("seed", range(4))
def test_int8_page_rewrite_is_idempotent(seed):
    """The int8 page write applied twice with the same row leaves the
    bytes and scales of applying it once: the argument that a re-run
    step writes what its failed attempt wrote."""
    from repro_torch.models import cache as cache_mod
    spec = cache_mod.PagedSpec(page_size=4, max_len=12, n_slots=2,
                               kv_dtype="int8")
    rng = np.random.default_rng(seed)
    pkv = cache_mod.paged_kv_init(spec, (2, 8), device="cpu")
    cache_mod.set_tables(pkv, np.array([[1, 2, 3], [4, 5, 6]]))
    for t in range(11):
        row = torch.from_numpy(rng.normal(size=(2, 1, 2, 8)).astype(
            np.float32) * rng.uniform(0.1, 3.0)).to(torch.bfloat16)
        pos = torch.tensor([t, min(t + 1, 11)])
        pkv.update(row, pos)
        once = [t_.clone() for t_ in pkv.tensors()]
        pkv.update(row, pos)
        for a, b in zip(once, pkv.tensors()):
            assert torch.equal(a, b), t


@pytest.mark.parametrize("kv", list(POOLS.values()), ids=list(POOLS))
def test_retried_step_after_a_partial_write_equals_clean(setup3, monkeypatch,
                                                         kv):
    """A pooled step raises a transient error after its first layer wrote
    its rows; the retry recomputes the step over those rows.  Tokens and
    logits equal the clean solo reference bit for bit, on the dense, the
    bf16-paged and the int8-paged pool."""
    from repro_torch.runtime import resilience as res
    cfg, _ = setup3
    cb = _batcher(setup3, n_slots=2, max_len=24, record_logits=True, **kv)
    cb.configure_resilience(retry_policy=res.RetryPolicy(max_retries=2,
                                                         backoff_s=1e-4))
    real, calls = tattn.gqa_decode, []

    def decode(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        if len(calls) in (3 * 2 + 1, 3 * 5 + 2):   # after layers 0 and 1
            raise res.TransientDispatchError("step failed midway")
        return out
    monkeypatch.setattr(tattn, "gqa_decode", decode)
    p1, p2 = _prompts(cfg, [6, 9], seed=14)
    handles = [cb.submit(p, max_new_tokens=8) for p in (p1, p2)]
    outs = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    monkeypatch.setattr(tattn, "gqa_decode", real)
    assert len(calls) > 3 * 5 + 2
    for p, h, out in zip((p1, p2), handles, outs):
        ref, rows = cb.generate_reference(p, max_new_tokens=8,
                                          record_logits=True)
        assert out == ref
        for got, want in zip(h.logits, rows):
            np.testing.assert_array_equal(got, want)
