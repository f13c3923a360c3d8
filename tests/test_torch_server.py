"""The port's ``CodrBatchServer`` (``CompiledModel.serve``) on the CPU,
mirroring ``tests/test_async_server.py`` and the server half of
``tests/test_serving.py``, and held against the JAX server.

* Inside the port, bit for bit: server rows equal the port's own
  ``CompiledModel.run`` on the same batch, and the async path equals
  the sync path.  The model is one conv layer fed integer inputs within
  int8, so on the ``smm_kernel`` lane every row is exact integer
  arithmetic and does not depend on which requests share its batch.
* Against JAX: the port's rows are within rtol 1e-4 / atol 1e-4 of the
  JAX server's rows (the tolerance of ``tests/test_torch_api.py``).

The ``cuda`` tests run the async path's pinned staging on the card;
the reference package is imported inside its one test, so they also
run where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_server.py

Every wait carries its own timeout; timing assertions are one-sided.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.api as tcodr
from repro_torch.core.serving import CodrBatchServer, FlushDispatchError
from repro_torch.runtime.resilience import (DeadlineExceeded, RejectedError,
                                            WorkerCrashed)

T = 120                              # seconds any single wait may take


def _layers(c, seed=7):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32) * 0.5
    w[rng.random(w.shape) > 0.5] = 0
    return [c.LayerSpec.conv(w, rng.normal(size=6).astype(np.float32),
                             activation="relu", name="c0")]


@pytest.fixture(scope="module")
def compiled():
    """Tiny conv-only model (any input spatial size works, which the
    mixed-shape tests need), on the smm_conv kernel's lane."""
    return tcodr.compile(tcodr.ModelSpec(_layers(tcodr)),
                         tcodr.EncodeConfig(n_unique=16),
                         backend="smm_kernel", device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _img(rng, hw=9, c=3):
    return rng.integers(-127, 128, size=(hw, hw, c)).astype(np.float32)


def _run(compiled, batch):
    return compiled.run(np.asarray(batch)).numpy()


# ---------------------------------------------------------------------------
# rows: the port's own run, and the JAX server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["tiled", "smm", "smm_kernel"])
def test_server_rows_equal_compiled_run(backend, rng):
    tc = tcodr.compile(tcodr.ModelSpec(_layers(tcodr)),
                       tcodr.EncodeConfig(n_unique=16), backend=backend,
                       device="cpu")
    xs = [_img(rng) for _ in range(6)]
    outs = tc.serve(max_batch=4).serve(xs)
    # chunks [0..3] and [4, 5] (bucket 2): each row equals run on its chunk
    ref = np.concatenate([_run(tc, xs[:4]), _run(tc, xs[4:])])
    for o, r in zip(outs, ref):
        assert isinstance(o, np.ndarray)
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("backend", ["tiled", "smm"])
def test_server_rows_match_the_jax_server(backend, rng):
    pytest.importorskip("jax")
    import repro.api as jcodr
    jc = jcodr.compile(jcodr.ModelSpec(_layers(jcodr)),
                       jcodr.EncodeConfig(n_unique=16), backend=backend)
    tc = tcodr.compile(tcodr.ModelSpec(_layers(tcodr)),
                       tcodr.EncodeConfig(n_unique=16), backend=backend,
                       device="cpu")
    xs = [_img(rng) for _ in range(5)] + [_img(rng, 11) for _ in range(2)]
    j_outs = jc.serve(max_batch=4).serve(xs)
    t_sync = tc.serve(max_batch=4).serve(xs)
    server = tc.serve(max_batch=4, flush_deadline_s=0.02)
    with server:
        t_async = [f.result(timeout=T) for f in
                   [server.submit_async(x) for x in xs]]
    for t, a, j in zip(t_sync, t_async, j_outs):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a, t)


# ---------------------------------------------------------------------------
# the async path (tests/test_async_server.py)
# ---------------------------------------------------------------------------

def test_async_matches_sync_bit_for_bit(compiled, rng):
    xs = [_img(rng) for _ in range(11)]
    refs = compiled.serve(max_batch=4).serve(xs)
    server = compiled.serve(max_batch=4, flush_deadline_s=0.05)
    with server:
        futs = [server.submit_async(x) for x in xs]
        outs = [f.result(timeout=T) for f in futs]
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert server.requests_served == len(xs)
    assert server.async_pending == 0


def test_deadline_triggers_partial_flush(compiled, rng):
    server = compiled.serve(max_batch=64, flush_deadline_s=0.05)
    fut = server.submit_async(_img(rng))
    out = fut.result(timeout=T)                 # resolves ⇒ deadline fired
    assert out.shape == (7, 7, 6)
    assert server.batches_run == 1
    assert server.bucket_counts == {1: 1}       # partial: bucket of 1
    server.stop_async()


def test_max_batch_triggers_before_deadline(compiled, rng):
    server = compiled.serve(max_batch=4, flush_deadline_s=3600.0)
    futs = [server.submit_async(_img(rng)) for _ in range(4)]
    outs = [f.result(timeout=T) for f in futs]
    assert all(o.shape == (7, 7, 6) for o in outs)
    assert server.bucket_counts.get(4) == 1
    server.stop_async(drain=False)


def test_out_of_order_completion_across_shape_buckets(compiled, rng):
    a = [_img(rng) for _ in range(3)]
    b = [_img(rng, 11) for _ in range(2)]
    order = []
    done = threading.Event()

    def track(tag):
        def cb(fut):
            order.append(tag)
            if len(order) == 5:
                done.set()
        return cb

    server = compiled.serve(max_batch=64, flush_deadline_s=3600.0)
    server.start_async()
    futs, tags = [], []
    for x, tag in zip([a[0], b[0], a[1], b[1], a[2]],
                      ["a0", "b0", "a1", "b1", "a2"]):
        f = server.submit_async(x)
        f.add_done_callback(track(tag))
        futs.append(f)
        tags.append(tag)
    server.stop_async(drain=True)
    assert done.wait(timeout=T)
    # chunks dispatch grouped by shape: [a0,a1,a2] then [b0,b1]
    assert order.index("a2") < order.index("b0")
    refs_a = compiled.serve(max_batch=64).serve(a)
    refs_b = compiled.serve(max_batch=64).serve(b)
    refs = {"a0": refs_a[0], "a1": refs_a[1], "a2": refs_a[2],
            "b0": refs_b[0], "b1": refs_b[1]}
    for f, tag in zip(futs, tags):
        np.testing.assert_array_equal(f.result(timeout=1), refs[tag])


def test_exception_propagates_to_failed_batch_only(compiled, rng):
    server = compiled.serve(max_batch=2, flush_deadline_s=0.02)
    fut_bad = server.submit_async(_img(rng, c=4))        # model expects 3
    with pytest.raises(Exception):
        fut_bad.result(timeout=T)
    good = _img(rng)
    fut_good = server.submit_async(good)
    np.testing.assert_array_equal(fut_good.result(timeout=T),
                                  _run(compiled, good[None])[0])
    server.stop_async()


def test_failed_staging_lands_on_that_batch_only(compiled, rng,
                                                 monkeypatch):
    """A staging copy that fails (here: the first one) fails exactly its
    batch's futures — no fallback to an unstaged copy — and the next
    batch is served."""
    server = compiled.serve(max_batch=2, flush_deadline_s=3600.0)
    real, calls = server._stage, []

    def stage(batch):
        calls.append(batch.shape)
        if len(calls) == 1:
            raise RuntimeError("staging copy failed")
        return real(batch)
    monkeypatch.setattr(server, "_stage", stage)
    server.start_async()
    xs = [_img(rng) for _ in range(4)]
    with server._cv:                 # one drained queue: two chunks
        futs = [server.submit_async(x) for x in xs]
    for f in futs[:2]:
        with pytest.raises(RuntimeError, match="staging copy failed"):
            f.result(timeout=T)
    for f, r in zip(futs[2:], _run(compiled, xs[2:])):
        np.testing.assert_array_equal(f.result(timeout=T), r)
    server.stop_async()
    assert server.requests_served == 2
    assert len(calls) == 2


def test_stop_drain_false_cancels_and_restart_works(compiled, rng):
    server = compiled.serve(max_batch=64, flush_deadline_s=3600.0)
    x = _img(rng)
    fut = server.submit_async(x)
    server.stop_async(drain=False)
    assert fut.cancelled()
    fut2 = server.submit_async(x)
    server.stop_async(drain=True)
    np.testing.assert_array_equal(fut2.result(timeout=1),
                                  _run(compiled, x[None])[0])


def test_individually_cancelled_future_skips_compute(compiled, rng):
    server = compiled.serve(max_batch=64, flush_deadline_s=3600.0)
    xs = [_img(rng) for _ in range(2)]
    f_cancel = server.submit_async(xs[0])
    f_keep = server.submit_async(xs[1])
    assert f_cancel.cancel()
    server.stop_async(drain=True)
    assert f_cancel.cancelled()
    np.testing.assert_array_equal(
        f_keep.result(timeout=1),
        compiled.serve(max_batch=64).serve([xs[1]])[0])
    assert server.requests_served == 1
    assert server.bucket_counts == {1: 1}


def test_context_manager_drains_on_exit(compiled, rng):
    xs = [_img(rng) for _ in range(3)]
    server = compiled.serve(max_batch=64, flush_deadline_s=3600.0)
    with server:
        futs = [server.submit_async(x) for x in xs]
    refs = compiled.serve(max_batch=64).serve(xs)
    for f, r in zip(futs, refs):
        np.testing.assert_array_equal(f.result(timeout=1), r)


def test_sync_flush_unaffected_by_async_state(compiled, rng):
    server = compiled.serve(max_batch=4, flush_deadline_s=0.01)
    server.start_async()
    rid = server.submit(_img(rng))
    assert rid == 0
    time.sleep(0.05)                    # give the loop a chance to misbehave
    outs = server.flush()
    assert len(outs) == 1 and outs[0].shape == (7, 7, 6)
    server.stop_async()


def test_async_deadline_and_shedding(compiled, rng):
    """A request whose deadline passed before dispatch resolves to
    DeadlineExceeded; a full bounded queue sheds with RejectedError."""
    server = compiled.serve(max_batch=64, flush_deadline_s=3600.0,
                            max_pending=2)
    server.start_async()
    f_late = server.submit_async(_img(rng), deadline_s=1e-4)
    f_ok = server.submit_async(_img(rng))
    with pytest.raises(RejectedError) as ei:
        server.submit_async(_img(rng))
    assert ei.value.retry_after_s == 3600.0
    assert server.requests_shed == 1
    time.sleep(0.01)
    server.stop_async(drain=True)
    with pytest.raises(DeadlineExceeded):
        f_late.result(timeout=1)
    assert f_ok.result(timeout=1).shape == (7, 7, 6)
    assert server.requests_expired == 1
    with pytest.raises(ValueError, match="deadline_s"):
        server.submit_async(_img(rng), deadline_s=0)


def test_sync_deadline_drops_expired_rows(compiled, rng):
    server = compiled.serve(max_batch=4, max_pending=3)
    server.submit(_img(rng), deadline_s=1e-4)
    server.submit(_img(rng))
    time.sleep(0.01)
    outs = server.flush()
    assert outs[0] is None and outs[1].shape == (7, 7, 6)
    assert server.requests_expired == 1
    for _ in range(3):
        server.submit(_img(rng))
    with pytest.raises(RejectedError):
        server.submit(_img(rng))


def test_worker_crash_fails_pending_futures_no_hang(compiled, rng,
                                                    monkeypatch):
    """A BaseException out of the worker loop (a crash, not a dispatch
    error) fails every pending future with WorkerCrashed; the next
    submit starts a fresh worker."""
    class Crash(BaseException):
        pass

    server = compiled.serve(max_batch=64, flush_deadline_s=3600.0)
    real = server._dispatch_async

    def crash(taken):
        server._async_queue.extend(taken)     # leave them pending
        raise Crash("worker died")
    monkeypatch.setattr(server, "_dispatch_async", crash)
    futs = [server.submit_async(_img(rng)) for _ in range(3)]
    server.stop_async(drain=True)
    for f in futs:
        with pytest.raises(WorkerCrashed) as ei:
            f.result(timeout=T)
        assert isinstance(ei.value.__cause__, Crash)
    assert server.worker_crashes == 1
    monkeypatch.setattr(server, "_dispatch_async", real)
    x = _img(rng)
    fut = server.submit_async(x)
    server.stop_async(drain=True)
    np.testing.assert_array_equal(fut.result(timeout=T),
                                  _run(compiled, x[None])[0])


def test_stop_from_a_done_callback_raises(compiled, rng):
    server = compiled.serve(max_batch=1, flush_deadline_s=3600.0)
    seen = []

    def cb(_):
        try:
            server.stop_async()
        except RuntimeError as e:
            seen.append(str(e))
    fut = server.submit_async(_img(rng))
    fut.add_done_callback(cb)
    fut.result(timeout=T)
    server.stop_async()
    assert seen and "worker itself" in seen[0]


@pytest.mark.parametrize("kw", ["injector", "retry_policy", "restart_policy",
                                "supervisor"])
def test_configure_resilience_refuses_until_ported(compiled, kw, rng):
    """Each hook installs alone and beside the serving supervisor (ROADMAP
    A10, ported), and clears; a server with the supervisor dispatches on
    its lane, which a degradation moves to ``tiled`` with the same
    rows."""
    from repro_torch.runtime import resilience as res
    hooks = {"injector": res.FaultInjector(res.FaultPlan()),
             "retry_policy": res.RetryPolicy(),
             "restart_policy": res.RestartPolicy(),
             "supervisor": res.ServingSupervisor(backend="sharded",
                                                 device="cpu")}
    server = compiled.serve()
    sup = (hooks["supervisor"] if kw == "supervisor"
           else res.ServingSupervisor(backend="sharded", device="cpu"))
    assert server.configure_resilience(**{kw: hooks[kw],
                                          "supervisor": sup}) is server
    assert getattr(server, "_" + kw) is hooks[kw]
    assert server._supervisor is sup
    x = _img(rng)
    plain = compiled.serve().serve([x])[0]
    lane = server._supervisor
    assert lane.backend_name == "sharded"
    np.testing.assert_array_equal(server.serve([x])[0], plain)
    assert lane.degrade("test") == "tiled"
    np.testing.assert_array_equal(server.serve([x])[0], plain)
    assert len(lane._warm) == 2                 # one latency per dispatch
    assert server.configure_resilience() is server
    assert getattr(server, "_" + kw, None) is None
    assert server._supervisor is None


def test_server_argument_validation(compiled):
    for kw in ({"max_batch": 0}, {"flush_deadline_s": 0},
               {"max_pending": 0}):
        with pytest.raises(ValueError):
            compiled.serve(**kw)


# ---------------------------------------------------------------------------
# the sync path (the server half of tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_batch_server_ids_monotonic_across_flushes_and_failures(rng):
    from repro_torch.core.dataflow import ConvShape

    spec = tcodr.ModelSpec.from_shapes([ConvShape(4, 2, 3, 3, 8, 8, 1)],
                                       3, density=0.8, rng=rng)
    server = CodrBatchServer(tcodr.compile(spec, device="cpu"), max_batch=2)
    issued = []
    good = rng.normal(size=(8, 8, 2)).astype(np.float32)
    issued += [server.submit(good) for _ in range(3)]
    server.flush()
    issued += [server.submit(good) for _ in range(2)]
    server.flush()
    issued += [server.submit(good) for _ in range(2)]
    bad = rng.normal(size=(3, 3, 2)).astype(np.float32)   # kernel > input
    issued.append(server.submit(bad))
    with pytest.raises(Exception):
        server.flush()
    issued += [server.submit(good) for _ in range(2)]
    server.flush()
    assert issued == list(range(len(issued)))


def test_flush_failure_keeps_undispatched_tail(compiled, rng):
    server = compiled.serve(max_batch=2)
    good, bad, tail = _img(rng), _img(rng, c=4), _img(rng, 11)
    for x in (good, good, bad, tail, tail):
        server.submit(x)
    with pytest.raises(FlushDispatchError) as ei:
        server.flush()
    err = ei.value
    assert err.requeued == 2
    assert err.failed == [2]
    assert err.partial[0] is not None and err.partial[1] is not None
    assert err.partial[2] is None and err.partial[4] is None
    outs = server.flush()
    assert len(outs) == 2
    assert all(o is not None and o.shape == (9, 9, 6) for o in outs)
    assert server.flush() == []


def test_flush_failure_does_not_requeue_poison(compiled, rng):
    server = compiled.serve(max_batch=2)
    server.submit(_img(rng, c=4))
    with pytest.raises(FlushDispatchError):
        server.flush()
    assert server.flush() == []
    server.submit(_img(rng))
    assert len(server.flush()) == 1


def test_threaded_submit_ids_unique_and_all_served(compiled, rng):
    server = compiled.serve(max_batch=4)
    good = _img(rng)
    ids: list[int] = []
    lock = threading.Lock()

    def worker():
        for _ in range(25):
            rid = server.submit(good)
            with lock:
                ids.append(rid)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive()
    assert sorted(ids) == list(range(100))
    outs = server.flush()
    assert len(outs) == 100 and all(o is not None for o in outs)
    assert server.bucket_counts == {4: 25}


# ---------------------------------------------------------------------------
# on the card: pinned staging on a side stream
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the staging path copies to it)")
    return tcodr.compile(tcodr.ModelSpec(_layers(tcodr)),
                         tcodr.EncodeConfig(n_unique=16),
                         backend="smm_kernel", device="cuda")


@pytest.mark.cuda
def test_cuda_staged_async_equals_sync(cuda_compiled, rng):
    xs = [_img(rng) for _ in range(4)] + [_img(rng, 11) for _ in range(3)]
    refs = cuda_compiled.serve(max_batch=4).serve(xs)
    server = cuda_compiled.serve(max_batch=4, flush_deadline_s=3600.0)
    server.start_async()
    with server._cv:                 # one drained queue: three chunks
        futs = [server.submit_async(x) for x in xs]
    outs = [f.result(timeout=T) for f in futs]
    server.stop_async()
    assert server._copy_stream is not None
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)


@pytest.mark.cuda
def test_cuda_failed_pinned_copy_fails_its_batch(cuda_compiled, rng,
                                                 monkeypatch):
    """The first pinned copy fails: that batch's futures get the error
    (no fallback to the host array), the next batch is served."""
    real, calls = torch.Tensor.pin_memory, []

    def pin(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("pinned allocation failed")
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    xs = [_img(rng) for _ in range(4)]
    server = cuda_compiled.serve(max_batch=2, flush_deadline_s=3600.0)
    server.start_async()
    with server._cv:
        futs = [server.submit_async(x) for x in xs]
    for f in futs[:2]:
        with pytest.raises(RuntimeError, match="pinned allocation failed"):
            f.result(timeout=T)
    ref = cuda_compiled.run(np.stack(xs[2:])).cpu().numpy()
    for f, r in zip(futs[2:], ref):
        np.testing.assert_array_equal(f.result(timeout=T), r)
    server.stop_async()
