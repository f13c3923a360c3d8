"""The port's serving resilience (``repro_torch.runtime.resilience``) on
the CPU, mirroring ``tests/test_resilience.py`` (its three
serving-supervisor tests and the mixed run's device loss are mirrored in
``tests/test_torch_sharded.py``, beside the sharded lane they degrade):
seeded fault plans are deterministic, site-safe and the reference's own
plans;
injected dispatch failures retry to bit-identical results with no
request lost or double-counted; budget exhaustion quarantines exactly
the poison chunk; shedding and deadlines; worker crashes restart with
pending work preserved or fail every live future, never hang.

The server's model is one conv layer on the ``smm_kernel`` lane fed
integer inputs within int8, so every row is exact integer arithmetic
and does not depend on which requests share its batch (the async
grouping depends on timing).  The batcher runs the smoke variant of
qwen2.5-3b with params made by JAX and carried over.
"""
import time

import jax
import numpy as np
import pytest

import repro_torch.api as tcodr
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import get_model as jget_model
from repro.runtime import resilience as jres
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.batching import ContinuousBatcher
from repro_torch.core.serving import FlushDispatchError
from repro_torch.runtime import resilience as res

T = 300


@pytest.fixture(scope="module")
def compiled():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32) * 0.5
    w[rng.random(w.shape) > 0.5] = 0
    spec = tcodr.ModelSpec([tcodr.LayerSpec.conv(
        w, rng.normal(size=6).astype(np.float32), activation="relu",
        name="c0")])
    return tcodr.compile(spec, tcodr.EncodeConfig(n_unique=16),
                         backend="smm_kernel", device="cpu")


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(3)
    return [rng.integers(-127, 128, size=(9, 9, 3)).astype(np.float32)
            for _ in range(6)]


@pytest.fixture(scope="module")
def clean_ref(compiled, samples):
    """Reference outputs from a run with no resilience configured."""
    srv = compiled.serve(max_batch=2, flush_deadline_s=0.005)
    with srv:
        outs = [f.result(timeout=T)
                for f in [srv.submit_async(s) for s in samples]]
    return outs


@pytest.fixture(scope="module")
def lm():
    """(port cfg, port params) of the smoke qwen2.5-3b, made by JAX."""
    jcfg = jsmoke(jget_config("qwen2.5-3b"))
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return (smoke_variant(get_config("qwen2.5-3b")),
            convert.params_from_reference(jax.tree.map(np.asarray, jparams),
                                          "cpu"))


def _plan_rows(plan):
    return [(f.site, f.at_call, f.kind, f.latency_s) for f in plan]


# ---------------------------------------------------------------------------
# fault plans + injector
# ---------------------------------------------------------------------------

def test_seeded_plan_deterministic_and_site_safe():
    sites = res.ALL_SITES
    p1 = res.FaultPlan.seeded(42, sites, n_faults=8)
    p2 = res.FaultPlan.seeded(42, sites, n_faults=8)
    assert _plan_rows(p1) == _plan_rows(p2)
    p3 = res.FaultPlan.seeded(43, sites, n_faults=8)
    assert _plan_rows(p1) != _plan_rows(p3)
    for seed in range(25):
        for f in res.FaultPlan.seeded(seed, sites, n_faults=8,
                                      kinds=res.Fault.KINDS):
            if f.kind == "crash":
                assert f.site.endswith(".worker")
            if f.kind == "device_loss":
                assert f.site == res.SITE_SHARDED_DISPATCH
            if f.site.endswith(".worker"):
                assert f.kind in ("latency", "crash")


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 42, 1234])
@pytest.mark.parametrize("sites,kw", [
    ("all", {"n_faults": 8, "kinds": ("error", "latency", "device_loss",
                                      "crash")}),
    ("batcher", {"n_faults": 4, "max_call": 16, "latency_s": 0.002}),
    ("server", {"n_faults": 64, "max_call": 3})])      # saturates
def test_seeded_plan_is_the_references(seed, sites, kw):
    """One seed, one site list and one set of options: the same plan in
    both packages, fault for fault, and the same description."""
    names = {"all": "ALL_SITES",
             "batcher": ("SITE_BATCHER_WORKER", "SITE_BATCHER_PREFILL",
                         "SITE_BATCHER_DECODE"),
             "server": ("SITE_SERVER_WORKER", "SITE_SERVER_DISPATCH")}[sites]
    if isinstance(names, str):
        t_sites, j_sites = getattr(res, names), getattr(jres, names)
    else:
        t_sites = tuple(getattr(res, n) for n in names)
        j_sites = tuple(getattr(jres, n) for n in names)
    assert t_sites == j_sites
    t = res.FaultPlan.seeded(seed, t_sites, **kw)
    j = jres.FaultPlan.seeded(seed, j_sites, **kw)
    assert _plan_rows(t) == _plan_rows(j)
    assert t.describe() == j.describe()


def test_plan_validation():
    with pytest.raises(ValueError, match="duplicate"):
        res.FaultPlan([res.Fault("a.dispatch", 0),
                       res.Fault("a.dispatch", 0, "latency")])
    with pytest.raises(ValueError, match="unknown fault kind"):
        res.Fault("a.dispatch", 0, "meteor")
    with pytest.raises(ValueError, match="at_call"):
        res.Fault("a.dispatch", -1)
    assert len(res.FaultPlan()) == 0
    assert "empty" in res.FaultPlan().describe()


def test_injector_fires_at_exact_call_index():
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault("x.dispatch", 2, "error")]))
    inj.fire("x.dispatch")                  # call 0
    inj.fire("x.dispatch")                  # call 1
    inj.fire("y.dispatch")                  # other site: own counter
    with pytest.raises(res.InjectedFault):
        inj.fire("x.dispatch")              # call 2 → scheduled fault
    inj.fire("x.dispatch")                  # call 3: clean again
    assert inj.calls("x.dispatch") == 4
    assert inj.calls("y.dispatch") == 1
    assert [f.at_call for f in inj.fired] == [2]
    assert inj.remaining() == 0


def test_injector_fault_kinds():
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault("s.dispatch", 0, "latency", latency_s=0.01),
         res.Fault("s.dispatch", 1, "device_loss"),
         res.Fault("s.worker", 0, "crash")]))
    t0 = time.monotonic()
    inj.fire("s.dispatch")
    assert time.monotonic() - t0 >= 0.009
    with pytest.raises(res.DeviceLost):
        inj.fire("s.dispatch")
    with pytest.raises(res.InjectedCrash) as ei:
        inj.fire("s.worker")
    assert not isinstance(ei.value, Exception)      # a BaseException
    assert issubclass(res.InjectedFault, res.TransientDispatchError)


# ---------------------------------------------------------------------------
# retry_call semantics
# ---------------------------------------------------------------------------

def test_retry_call_transient_then_success():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise res.TransientDispatchError("blip")
        return "ok"

    pol = res.RetryPolicy(max_retries=3, backoff_s=1e-4)
    assert res.retry_call(flaky, policy=pol) == "ok"
    assert len(calls) == 3


def test_retry_call_non_transient_raises_immediately():
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("shape mismatch")      # never retryable

    with pytest.raises(ValueError):
        res.retry_call(broken,
                       policy=res.RetryPolicy(max_retries=5,
                                              backoff_s=1e-4))
    assert len(calls) == 1


def test_retry_call_exhaustion_quarantines_with_cause():
    calls = []

    def poison():
        calls.append(1)
        raise res.TransientDispatchError("always")

    with pytest.raises(res.QuarantinedError) as ei:
        res.retry_call(poison,
                       policy=res.RetryPolicy(max_retries=2,
                                              backoff_s=1e-4))
    assert ei.value.attempts == 3               # initial + 2 retries
    assert isinstance(ei.value.__cause__, res.TransientDispatchError)
    assert len(calls) == 3
    # no policy: exactly fn()
    assert res.retry_call(lambda: 5) == 5
    # a device loss degrades the supervisor's lane and retries there; at
    # the bottom of the ladder the loss re-raises
    sup = res.ServingSupervisor(backend="sharded", device="cpu")
    lanes = []

    def lost():
        lanes.append(sup.backend_name)
        raise res.DeviceLost("lost")

    with pytest.raises(res.DeviceLost):
        res.retry_call(lost, supervisor=sup)
    assert lanes == ["sharded", "tiled"] and sup.degradations == 1
    with pytest.raises(res.DeviceLost):        # without a supervisor
        res.retry_call(lost, policy=res.RetryPolicy(max_retries=2))


def test_retry_policy_backoff_grows_and_jitters_bounded():
    pol = res.RetryPolicy(backoff_s=0.01, backoff_mult=2.0, jitter=0.25)
    rng = np.random.default_rng(0)
    for attempt in range(4):
        nominal = 0.01 * 2.0 ** attempt
        d = pol.delay(attempt, rng)
        assert 0.75 * nominal <= d <= 1.25 * nominal
    assert res.RetryPolicy(jitter=0.0).delay(1) == 0.005 * 2.0
    # the same delays as the reference's policy
    jpol = jres.RetryPolicy(backoff_s=0.01, backoff_mult=2.0, jitter=0.25)
    for attempt in range(4):
        assert pol.delay(attempt) == jpol.delay(attempt)
    assert res.RestartPolicy().delay(3) == jres.RestartPolicy().delay(3)


# ---------------------------------------------------------------------------
# server: retry / quarantine / shedding / deadlines
# ---------------------------------------------------------------------------

def test_async_retry_bit_identical_no_request_lost(compiled, samples,
                                                   clean_ref):
    """Transient dispatch failures + retry: every request resolves to
    exactly the clean-run bits, served exactly once."""
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault(res.SITE_SERVER_DISPATCH, 0, "error"),
         res.Fault(res.SITE_SERVER_DISPATCH, 3, "error"),
         res.Fault(res.SITE_SERVER_DISPATCH, 4, "latency",
                   latency_s=0.003)]))
    srv = compiled.serve(max_batch=2, flush_deadline_s=0.005)
    srv.configure_resilience(
        injector=inj,
        retry_policy=res.RetryPolicy(max_retries=2, backoff_s=1e-3))
    with srv:
        outs = [f.result(timeout=T)
                for f in [srv.submit_async(s) for s in samples]]
    for got, ref in zip(outs, clean_ref):
        np.testing.assert_array_equal(got, ref)
    assert srv.requests_served == len(samples)      # exactly once each
    assert srv.requests_quarantined == 0
    assert len(inj.fired) >= 1


def test_async_quarantine_isolates_poison_chunk(compiled, samples,
                                                clean_ref):
    """A chunk that fails through the whole retry budget is quarantined:
    its futures get the QuarantinedError, every other chunk still
    serves.  Nothing is requeued."""
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault(res.SITE_SERVER_DISPATCH, i, "error")
         for i in range(3)]))
    srv = compiled.serve(max_batch=len(samples), flush_deadline_s=0.01)
    srv.configure_resilience(
        injector=inj,
        retry_policy=res.RetryPolicy(max_retries=2, backoff_s=1e-3))
    with srv:
        f_poison = srv.submit_async(samples[0])
        with pytest.raises(res.QuarantinedError):
            f_poison.result(timeout=T)
        f_ok = srv.submit_async(samples[1])
        np.testing.assert_array_equal(f_ok.result(timeout=T),
                                      clean_ref[1])
    assert srv.requests_quarantined == 1
    assert len(srv.quarantined) == 1
    assert srv.quarantined[0]["attempts"] == 3


def test_bounded_admission_sheds_with_retry_after(compiled, samples):
    srv = compiled.serve(max_batch=64, flush_deadline_s=0.2,
                         max_pending=2)
    with srv:
        f1 = srv.submit_async(samples[0])
        f2 = srv.submit_async(samples[1])
        with pytest.raises(res.RejectedError) as ei:
            srv.submit_async(samples[2])
        assert ei.value.retry_after_s == pytest.approx(0.2)
        f1.result(timeout=T)
        f2.result(timeout=T)
        srv.submit_async(samples[2]).result(timeout=T)
    assert srv.requests_shed == 1
    assert srv.requests_served == 3


def test_async_deadline_expiry_cancels_cleanly(compiled, samples,
                                               clean_ref):
    srv = compiled.serve(max_batch=64, flush_deadline_s=0.05)
    with srv:
        f_dead = srv.submit_async(samples[0], deadline_s=1e-9)
        f_live = srv.submit_async(samples[1])
        with pytest.raises(res.DeadlineExceeded):
            f_dead.result(timeout=T)
        np.testing.assert_array_equal(f_live.result(timeout=T),
                                      clean_ref[1])
    assert srv.requests_expired == 1
    assert srv.requests_served == 1


def test_sync_flush_retry_and_quarantine(compiled, samples, clean_ref):
    """Sync path: transient failures retry inside flush; exhaustion
    raises FlushDispatchError chaining QuarantinedError with the tail
    requeued."""
    srv = compiled.serve(max_batch=2)
    srv.configure_resilience(
        injector=res.FaultInjector(res.FaultPlan(
            [res.Fault(res.SITE_SERVER_DISPATCH, 0, "error")])),
        retry_policy=res.RetryPolicy(max_retries=2, backoff_s=1e-3))
    outs = srv.serve(samples[:4])
    for got, ref in zip(outs, clean_ref[:4]):
        np.testing.assert_array_equal(got, ref)

    srv2 = compiled.serve(max_batch=2)
    srv2.configure_resilience(
        injector=res.FaultInjector(res.FaultPlan(
            [res.Fault(res.SITE_SERVER_DISPATCH, i, "error")
             for i in (0, 1, 2)])),
        retry_policy=res.RetryPolicy(max_retries=1, backoff_s=1e-3))
    for s in samples[:4]:
        srv2.submit(s)
    with pytest.raises(FlushDispatchError) as ei:
        srv2.flush()
    assert isinstance(ei.value.__cause__, res.QuarantinedError)
    assert ei.value.failed == [0, 1]
    assert ei.value.requeued == 2
    assert srv2.requests_quarantined == 2
    tail = srv2.flush()
    assert len(tail) == 2
    for got, ref in zip(tail, clean_ref[2:4]):
        np.testing.assert_array_equal(got, ref)


def test_sync_submit_deadline_and_shedding(compiled, samples):
    srv = compiled.serve(max_batch=4, max_pending=2)
    srv.submit(samples[0], deadline_s=1e-9)
    srv.submit(samples[1])
    with pytest.raises(res.RejectedError):
        srv.submit(samples[2])
    time.sleep(0.005)
    outs = srv.flush()
    assert outs[0] is None                      # expired, never dispatched
    assert outs[1] is not None
    assert srv.requests_expired == 1 and srv.requests_shed == 1


# ---------------------------------------------------------------------------
# worker crash: fail-live vs supervised restart
# ---------------------------------------------------------------------------

def test_worker_crash_without_restart_fails_futures_no_hang(compiled,
                                                            samples):
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault(res.SITE_SERVER_WORKER, 0, "crash")]))
    srv = compiled.serve(max_batch=64, flush_deadline_s=0.02)
    srv.configure_resilience(injector=inj)      # no RestartPolicy
    f = srv.submit_async(samples[0])
    with pytest.raises(res.WorkerCrashed):
        f.result(timeout=60)
    assert srv.worker_crashes == 1 and srv.worker_restarts == 0
    f2 = srv.submit_async(samples[1])
    assert f2.result(timeout=T) is not None
    srv.stop_async()


def test_worker_crash_with_restart_preserves_pending(compiled, samples,
                                                     clean_ref):
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault(res.SITE_SERVER_WORKER, 0, "crash")]))
    srv = compiled.serve(max_batch=2, flush_deadline_s=0.01)
    srv.configure_resilience(
        injector=inj,
        restart_policy=res.RestartPolicy(max_restarts=2, backoff_s=1e-3))
    with srv:
        outs = [f.result(timeout=T)
                for f in [srv.submit_async(s) for s in samples]]
    for got, ref in zip(outs, clean_ref):
        np.testing.assert_array_equal(got, ref)
    assert srv.worker_crashes == 1
    assert srv.worker_restarts == 1
    assert srv.requests_served == len(samples)


def test_worker_crash_past_the_restart_budget_fails_live(compiled, samples):
    """Two crashes against a budget of one restart: the second fails the
    pending futures with WorkerCrashed naming the exhausted budget."""
    inj = res.FaultInjector(res.FaultPlan(
        [res.Fault(res.SITE_SERVER_WORKER, i, "crash") for i in (0, 1)]))
    srv = compiled.serve(max_batch=64, flush_deadline_s=0.02)
    srv.configure_resilience(
        injector=inj,
        restart_policy=res.RestartPolicy(max_restarts=1, backoff_s=1e-3))
    f = srv.submit_async(samples[0])
    with pytest.raises(res.WorkerCrashed, match="budget 1 exhausted"):
        f.result(timeout=60)
    assert srv.worker_crashes == 2 and srv.worker_restarts == 1
    srv.stop_async()


# ---------------------------------------------------------------------------
# mixed chaos run + the batcher
# ---------------------------------------------------------------------------

def test_mixed_chaos_run_no_loss_no_dup_bit_identical(compiled, samples,
                                                      clean_ref, lm):
    """A dispatch failure, a worker crash and latency in a
    CodrBatchServer, then a decode failure and a worker crash in a
    ContinuousBatcher: no request lost or duplicated, every handle
    resolves, outputs equal the clean run's (server) and the solo
    oracle's (batcher) bit for bit."""
    plan = res.FaultPlan(
        [res.Fault(res.SITE_SERVER_DISPATCH, 0, "error"),
         res.Fault(res.SITE_SERVER_WORKER, 1, "crash"),
         res.Fault(res.SITE_SERVER_DISPATCH, 4, "latency",
                   latency_s=0.003)])
    srv = compiled.serve(max_batch=2, flush_deadline_s=0.005)
    srv.configure_resilience(
        injector=res.FaultInjector(plan),
        retry_policy=res.RetryPolicy(max_retries=3, backoff_s=1e-3),
        restart_policy=res.RestartPolicy(max_restarts=2, backoff_s=1e-3))
    with srv:
        futs = [srv.submit_async(s) for s in samples]
        outs = [f.result(timeout=T) for f in futs]
    for got, ref in zip(outs, clean_ref):
        np.testing.assert_array_equal(got, ref)
    assert srv.requests_served == len(samples)
    assert srv.requests_quarantined == 0
    assert all(f.done() for f in futs)

    cfg, params = lm
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=24, device="cpu")
    cb.configure_resilience(
        injector=res.FaultInjector(res.FaultPlan(
            [res.Fault(res.SITE_BATCHER_DECODE, 1, "error"),
             res.Fault(res.SITE_BATCHER_WORKER, 2, "crash")])),
        retry_policy=res.RetryPolicy(max_retries=2, backoff_s=1e-3),
        restart_policy=res.RestartPolicy(max_restarts=1, backoff_s=1e-3))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (4, 6)]
    handles = [cb.submit(p, max_new_tokens=5) for p in prompts]
    outs_cb = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    assert cb.worker_crashes == 1 and cb.worker_restarts == 1
    for p, out in zip(prompts, outs_cb):
        ref, _ = cb.generate_reference(p, max_new_tokens=5)
        assert out == ref


def test_batcher_decode_retry_bit_identity(lm):
    """Injected decode-step and prefill failures retried in place: the
    emitted tokens and logits match the solo oracle bit for bit."""
    cfg, params = lm
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=24,
                           record_logits=True, device="cpu")
    cb.configure_resilience(
        injector=res.FaultInjector(res.FaultPlan(
            [res.Fault(res.SITE_BATCHER_DECODE, 0, "error"),
             res.Fault(res.SITE_BATCHER_PREFILL, 1, "error")])),
        retry_policy=res.RetryPolicy(max_retries=2, backoff_s=1e-3))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 5)]
    handles = [cb.submit(p, max_new_tokens=4) for p in prompts]
    outs = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    for p, h, out in zip(prompts, handles, outs):
        ref, rows = cb.generate_reference(p, max_new_tokens=4,
                                          record_logits=True)
        assert out == ref
        for got, want in zip(h.logits, rows):
            np.testing.assert_array_equal(got, want)


def test_batcher_deadline_and_shedding(lm):
    cfg, params = lm
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)

    cb = ContinuousBatcher(params, cfg, n_slots=1, max_len=32,
                           max_pending=2, device="cpu")
    h_long = cb.submit(prompt, max_new_tokens=20)
    h_dead = cb.submit(prompt, max_new_tokens=4, deadline_s=1e-9)
    with pytest.raises(res.DeadlineExceeded):
        h_dead.result(timeout=T)
    assert h_dead.finish_reason == "deadline"
    assert h_long.result(timeout=T)
    assert cb.requests_expired == 1
    h1 = cb.submit(prompt, max_new_tokens=20)
    next(iter(h1))                              # h1 admitted to its slot
    h2 = cb.submit(prompt, max_new_tokens=4)
    h3 = cb.submit(prompt, max_new_tokens=4)
    with pytest.raises(res.RejectedError):
        cb.submit(prompt, max_new_tokens=4)
    assert cb.requests_shed == 1
    for h in (h1, h2, h3):
        h.result(timeout=T)
    cb.stop_async()


def test_validation_errors():
    with pytest.raises(ValueError, match="max_retries"):
        res.RetryPolicy(max_retries=0)
    with pytest.raises(ValueError, match="max_restarts"):
        res.RestartPolicy(max_restarts=0)
    with pytest.raises(ValueError, match="at least one site"):
        res.FaultPlan.seeded(0, ())
