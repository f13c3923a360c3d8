"""Serving resilience — the port's copy of ``repro.runtime.resilience``:
deterministic fault injection, retry with quarantine, supervised worker
restart, and the error types a future or a generation handle of the
port's servers resolves to.

* **Fault injection** — :class:`FaultPlan` / :class:`FaultInjector`: a
  seeded, deterministic schedule of faults fired at named *sites*
  inside the serving stack (dispatch exceptions, latency, worker
  crashes).  Every hooked object holds ``_injector = None`` by default
  and guards the site with one ``is None`` check.
  ``FaultPlan.seeded`` draws from ``np.random.default_rng`` exactly as
  the reference does, so one seed and one site list give the same plan
  in both packages.
* **Request robustness** — :class:`RetryPolicy` (bounded exponential
  backoff with deterministic jitter for *transient* failures,
  :func:`retry_call`), quarantine once the budget is spent
  (:class:`QuarantinedError`), deadlines (:class:`DeadlineExceeded`)
  and load shedding (:class:`RejectedError`).
* **Supervision** — :class:`RestartPolicy`: a crashed worker thread
  backs off and re-enters its loop with pending work preserved
  (``serving.AsyncWorkerLoop._run_worker``).

The reference's ``ServingSupervisor`` degrades a ``sharded`` lane over
an elastic mesh; the port has no sharded backend yet, so a
``supervisor=`` argument raises ``NotImplementedError`` naming ROADMAP
A10 (here and in ``AsyncWorkerLoop.configure_resilience``).

Crash faults (:class:`InjectedCrash`) derive from ``BaseException`` so
they pass through the per-batch ``except Exception`` handlers and kill
the worker thread wherever they fire, as a real thread death does.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = [
    "TransientDispatchError", "InjectedFault", "InjectedCrash",
    "DeviceLost", "WorkerCrashed", "DeadlineExceeded", "RejectedError",
    "QuarantinedError", "Fault", "FaultPlan", "FaultInjector",
    "RetryPolicy", "RestartPolicy", "retry_call", "refuse_supervisor",
    "SITE_SERVER_WORKER", "SITE_SERVER_DISPATCH", "SITE_BATCHER_WORKER",
    "SITE_BATCHER_PREFILL", "SITE_BATCHER_DECODE", "SITE_SHARDED_DISPATCH",
    "ALL_SITES",
]

SITE_SERVER_WORKER = "server.worker"
SITE_SERVER_DISPATCH = "server.dispatch"
SITE_BATCHER_WORKER = "batcher.worker"
SITE_BATCHER_PREFILL = "batcher.prefill"
SITE_BATCHER_DECODE = "batcher.decode"
# no port code fires it before ROADMAP A10 (the sharded backend); kept so
# that plans over ALL_SITES are the reference's plans
SITE_SHARDED_DISPATCH = "sharded.dispatch"

ALL_SITES = (SITE_SERVER_WORKER, SITE_SERVER_DISPATCH, SITE_BATCHER_WORKER,
             SITE_BATCHER_PREFILL, SITE_BATCHER_DECODE,
             SITE_SHARDED_DISPATCH)


def refuse_supervisor(supervisor) -> None:
    """Raise for a serving supervisor: it degrades a sharded lane, which
    the port does not have before ROADMAP A10."""
    if supervisor is not None:
        raise NotImplementedError(
            "supervisor=: the serving supervisor degrades a sharded lane "
            "over an elastic mesh, and the port has no sharded backend "
            "yet (ROADMAP A10)")


# ---------------------------------------------------------------------------
# fault taxonomy
# ---------------------------------------------------------------------------

class TransientDispatchError(RuntimeError):
    """A dispatch failure that is safe to retry: re-running the work
    unit gives the result a first clean run gives.  :class:`RetryPolicy`
    treats it as retryable by default."""


class InjectedFault(TransientDispatchError):
    """A scheduled transient dispatch failure from a :class:`FaultPlan`."""


class InjectedCrash(BaseException):
    """A scheduled worker-thread crash.  Derives from ``BaseException``
    so the per-batch ``except Exception`` isolation does not contain it:
    it escapes the worker loop like a thread death and lands in the
    ``AsyncWorkerLoop`` supervision path (restart or fail-live)."""


class DeviceLost(RuntimeError):
    """A device dropped out of the mesh (the ``device_loss`` fault kind,
    which plans schedule only at the sharded dispatch site).  Not
    retryable in place."""


class WorkerCrashed(RuntimeError):
    """Handed to every live future/handle when a serving worker thread
    died and the restart budget (if any) is exhausted — the guarantee
    that ``result()`` never hangs on a dead loop."""


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before it was dispatched (or, for a
    streaming generation, before it finished)."""


class RejectedError(RuntimeError):
    """Admission rejected: the bounded queue is full.  ``retry_after_s``
    is the server's hint for when capacity is likely to free up."""

    def __init__(self, msg: str, *, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QuarantinedError(RuntimeError):
    """A work unit failed transiently more times than the retry budget
    allows and is quarantined: consumed, recorded, never requeued.
    ``attempts`` counts executions including the first; the last
    failure is chained as ``__cause__``."""

    def __init__(self, msg: str, *, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


# ---------------------------------------------------------------------------
# fault plans + injector
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: at the ``at_call``-th firing (0-based) of
    ``site``, do ``kind`` — ``"error"`` (raise :class:`InjectedFault`),
    ``"latency"`` (sleep ``latency_s``), ``"device_loss"`` (raise
    :class:`DeviceLost`) or ``"crash"`` (raise :class:`InjectedCrash`).
    """

    site: str
    at_call: int
    kind: str = "error"
    latency_s: float = 0.0

    KINDS = ("error", "latency", "device_loss", "crash")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self.KINDS}")
        if self.at_call < 0:
            raise ValueError("at_call must be >= 0")


def _site_kinds(site: str, kinds) -> tuple[str, ...]:
    """Kinds executable at a site.  Worker-loop sites take latency or
    crash (an error at a loop top has no per-request owner); dispatch
    sites take error/latency, plus device loss at the sharded
    dispatch."""
    if site.endswith(".worker"):
        allowed = {"latency", "crash"}
    else:
        allowed = {"error", "latency"}
        if site == SITE_SHARDED_DISPATCH:
            allowed.add("device_loss")
    out = tuple(k for k in kinds if k in allowed)
    return out or ("latency",)


class FaultPlan:
    """An immutable schedule of :class:`Fault`\\ s, built explicitly or
    derived from a seed (:meth:`seeded`, the ``--chaos SEED`` surface):
    the same seed always yields the same plan."""

    def __init__(self, faults=()):
        self.faults = tuple(faults)
        seen = set()
        for f in self.faults:
            key = (f.site, f.at_call)
            if key in seen:
                raise ValueError(f"duplicate fault at {key}")
            seen.add(key)

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def by_site(self) -> dict[str, dict[int, Fault]]:
        out: dict[str, dict[int, Fault]] = {}
        for f in self.faults:
            out.setdefault(f.site, {})[f.at_call] = f
        return out

    def describe(self) -> str:
        if not self.faults:
            return "FaultPlan(empty)"
        rows = [f"  {f.site}#{f.at_call}: {f.kind}"
                + (f"({f.latency_s * 1e3:.0f}ms)" if f.kind == "latency"
                   else "")
                for f in sorted(self.faults,
                                key=lambda f: (f.site, f.at_call))]
        return "FaultPlan:\n" + "\n".join(rows)

    @classmethod
    def seeded(cls, seed: int, sites, *, n_faults: int = 4,
               kinds=("error", "latency", "crash"), max_call: int = 10,
               latency_s: float = 0.01) -> "FaultPlan":
        """Deterministic plan: ``n_faults`` faults spread over ``sites``
        at call indexes in ``[0, max_call)``, kinds drawn from ``kinds``
        but restricted per site to what is executable there.  The draws
        are the reference's, in its order."""
        sites = tuple(sites)
        if not sites:
            raise ValueError("need at least one site")
        rng = np.random.default_rng(seed)
        faults, used = [], set()
        for _ in range(n_faults):
            for _attempt in range(64):
                site = sites[int(rng.integers(len(sites)))]
                at = int(rng.integers(max_call))
                if (site, at) not in used:
                    break
            else:                                # plan saturated
                break
            used.add((site, at))
            pool = _site_kinds(site, kinds)
            kind = pool[int(rng.integers(len(pool)))]
            faults.append(Fault(site, at, kind, latency_s=latency_s))
        return cls(faults)


class FaultInjector:
    """Executes a :class:`FaultPlan`.  Thread-safe: every hooked site
    calls :meth:`fire` with its name; the injector counts calls per site
    and fires the scheduled fault at its exact index.  ``fired`` is the
    execution log."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_site = plan.by_site()
        self._counts: dict[str, int] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self.fired: list[Fault] = []        # guarded-by: _lock

    def calls(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def remaining(self) -> int:
        with self._lock:
            return len(self.plan) - len(self.fired)

    def fire(self, site: str) -> None:
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
            fault = self._by_site.get(site, {}).get(idx)
            if fault is not None:
                self.fired.append(fault)
        if fault is None:
            return
        if fault.kind == "latency":
            time.sleep(fault.latency_s)
        elif fault.kind == "error":
            raise InjectedFault(f"injected dispatch failure at "
                                f"{site}#{idx}")
        elif fault.kind == "device_loss":
            raise DeviceLost(f"injected device loss at {site}#{idx}")
        else:                                    # crash
            raise InjectedCrash(f"injected worker crash at {site}#{idx}")


# ---------------------------------------------------------------------------
# retry / restart policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter for
    *transient* dispatch failures.  ``transient`` is the exception
    allowlist — anything else re-raises at once.  After ``max_retries``
    re-executions the work unit is quarantined
    (:class:`QuarantinedError`)."""

    max_retries: int = 3
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    jitter: float = 0.25               # ± fraction of the nominal delay
    seed: int = 0
    transient: tuple = (TransientDispatchError,)

    def __post_init__(self):
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")

    def is_transient(self, exc: BaseException) -> bool:
        return isinstance(exc, self.transient)

    def delay(self, attempt: int, rng=None) -> float:
        base = self.backoff_s * self.backoff_mult ** attempt
        if not self.jitter:
            return base
        r = (rng or np.random.default_rng(self.seed + attempt)).random()
        return base * (1.0 + self.jitter * (2.0 * r - 1.0))


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Supervised worker restart: a crashed worker thread backs off and
    re-enters its loop with all pending work preserved, up to
    ``max_restarts`` times over the loop's lifetime; past the budget the
    crash fails every live future/handle (:class:`WorkerCrashed`)."""

    max_restarts: int = 2
    backoff_s: float = 0.005
    backoff_mult: float = 2.0

    def __post_init__(self):
        if self.max_restarts < 1:
            raise ValueError("max_restarts must be >= 1")

    def delay(self, n_restarts: int) -> float:
        return self.backoff_s * self.backoff_mult ** n_restarts


def retry_call(fn, *, policy: RetryPolicy | None = None, supervisor=None,
               rng=None):
    """Run ``fn()`` under the retry ladder.

    * Transient failures (``policy.is_transient``) retry with backoff +
      jitter, at most ``policy.max_retries`` times; exhaustion raises
      :class:`QuarantinedError` chaining the last failure.
    * Everything else re-raises at once (:class:`DeviceLost` included:
      degrading past it is the supervisor's, ROADMAP A10).

    With no ``policy`` this is exactly ``fn()``.  ``fn`` must give on a
    re-run what a first clean run gives: the batcher's steps write the
    pool in place, and ``core.batching`` argues why re-running them is
    that."""
    refuse_supervisor(supervisor)
    if policy is None:
        return fn()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:          # noqa: BLE001 — classified below
            if not policy.is_transient(e):
                raise
            if attempt >= policy.max_retries:
                raise QuarantinedError(
                    f"quarantined after {attempt + 1} attempts: {e}",
                    attempts=attempt + 1) from e
            time.sleep(policy.delay(attempt, rng))
            attempt += 1
