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
  (``serving.AsyncWorkerLoop._run_worker``).  :class:`ServingSupervisor`
  watches dispatch latency and walks a ``sharded`` lane down a
  degradation ladder over an elastic mesh: one device fewer a rung,
  ``tiled`` at the bottom.

Crash faults (:class:`InjectedCrash`) derive from ``BaseException`` so
they pass through the per-batch ``except Exception`` handlers and kill
the worker thread wherever they fire, as a real thread death does.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.runtime.elastic import ElasticMeshManager, HostSet
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor

__all__ = [
    "TransientDispatchError", "InjectedFault", "InjectedCrash",
    "DeviceLost", "WorkerCrashed", "DeadlineExceeded", "RejectedError",
    "QuarantinedError", "Fault", "FaultPlan", "FaultInjector",
    "RetryPolicy", "RestartPolicy", "retry_call", "ServingSupervisor",
    "SITE_SERVER_WORKER", "SITE_SERVER_DISPATCH", "SITE_BATCHER_WORKER",
    "SITE_BATCHER_PREFILL", "SITE_BATCHER_DECODE", "SITE_SHARDED_DISPATCH",
    "ALL_SITES",
]

SITE_SERVER_WORKER = "server.worker"
SITE_SERVER_DISPATCH = "server.dispatch"
SITE_BATCHER_WORKER = "batcher.worker"
SITE_BATCHER_PREFILL = "batcher.prefill"
SITE_BATCHER_DECODE = "batcher.decode"
SITE_SHARDED_DISPATCH = "sharded.dispatch"

ALL_SITES = (SITE_SERVER_WORKER, SITE_SERVER_DISPATCH, SITE_BATCHER_WORKER,
             SITE_BATCHER_PREFILL, SITE_BATCHER_DECODE,
             SITE_SHARDED_DISPATCH)


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


def retry_call(fn, *, policy: RetryPolicy | None = None,
               supervisor: "ServingSupervisor | None" = None, rng=None):
    """Run ``fn()`` under the request-robustness ladder.

    * Transient failures (``policy.is_transient``) retry with backoff +
      jitter, at most ``policy.max_retries`` times; exhaustion raises
      :class:`QuarantinedError` chaining the last failure.
    * :class:`DeviceLost` asks the supervisor to degrade the lane and
      retries on the new one (bounded by the ladder depth — at the
      bottom the loss re-raises).
    * Everything else re-raises at once.

    With ``policy`` and ``supervisor`` both ``None`` this is exactly
    ``fn()``.  ``fn`` must give on a re-run what a first clean run
    gives: the batcher's steps write the pool in place, and
    ``core.batching`` argues why re-running them is that."""
    if policy is None and supervisor is None:
        return fn()
    attempt = 0
    while True:
        try:
            return fn()
        except DeviceLost:
            if supervisor is None or supervisor.notify_device_loss() is None:
                raise
        except Exception as e:          # noqa: BLE001 — classified below
            if policy is None or not policy.is_transient(e):
                raise
            if attempt >= policy.max_retries:
                raise QuarantinedError(
                    f"quarantined after {attempt + 1} attempts: {e}",
                    attempts=attempt + 1) from e
            time.sleep(policy.delay(attempt, rng))
            attempt += 1


# ---------------------------------------------------------------------------
# the serving supervisor: latency watch + degradation ladder
# ---------------------------------------------------------------------------

class ServingSupervisor:
    """Watches serving health and executes graceful degradation.

    **Latency watch.**  :meth:`record_latency` feeds each dispatch /
    decode-step wall time into a :class:`StragglerMonitor` as host 0 of
    a synthetic 4-host fleet whose other hosts report the warmed-up
    baseline (median of the first ``warmup`` samples) — so the monitor's
    fleet-median machinery (EWMA, threshold × median, patience) applies
    unchanged to a single serving lane.  A sustained flag degrades one
    rung.

    **Degradation ladder.**  The lane starts as a ``sharded`` backend
    over N devices.  Each degradation marks one device failed in an
    :class:`ElasticMeshManager` (devices are modeled as 1-chip hosts)
    and rebuilds the tile mesh over the largest surviving feasible grid;
    when no grid is feasible the lane falls back to ``fallback``
    (default ``tiled``, the single-device lane).  Each sharded rung is a
    fresh :class:`~repro_torch.core.backends.ShardedBackend` registered
    as ``<name>@<n>`` — its per-layer shard state is keyed on the mesh,
    so the first dispatch after a shrink re-shards.  A degradation
    changes latency, not results, wherever the sharded lane equals
    ``tiled`` (``ShardedBackend``'s docstring).

    ``device`` names the lane's devices when the base backend has no
    explicit mesh: the default mesh of that device (every card unless
    the caller passes ``"cpu"``).

    :meth:`notify_device_loss` degrades immediately (the dispatch that
    observed the loss retries on the new lane via :func:`retry_call`).
    ``history`` records every transition for the control plane.
    """

    def __init__(self, *, backend="sharded", fallback: str = "tiled",
                 monitor_cfg: StragglerConfig | None = None,
                 warmup: int = 8, device=None):
        from repro_torch.core import backends as _backends
        self._lock = threading.Lock()
        self._base = _backends.resolve(backend)
        self._backend = self._base          # guarded-by: _lock
        self.fallback = fallback
        self.warmup = max(1, warmup)
        self.monitor = StragglerMonitor(
            4, monitor_cfg or StragglerConfig(patience=4))
        self._warm: list[float] = []        # guarded-by: _lock
        self._baseline: float | None = None  # guarded-by: _lock
        self.history: list[dict] = []       # guarded-by: _lock
        self.degradations = 0               # guarded-by: _lock
        self._exhausted = False             # guarded-by: _lock
        devices = self._lane_devices(device)
        hosts = HostSet(n_hosts=len(devices), chips_per_host=1,
                        healthy=np.ones(len(devices), dtype=bool))
        self.mesh_manager = ElasticMeshManager(
            hosts, model_parallel=1, global_batch=len(devices))
        self._devices = devices

    def _lane_devices(self, device) -> list:
        mesh = getattr(self._base, "_mesh", None)
        if mesh is not None:
            return list(mesh)
        from repro_torch.sharding import rules
        return list(rules.tile_mesh(device=device))

    # -- state --------------------------------------------------------------
    @property
    def backend(self):
        """The current lane (a Backend instance) — what dispatches
        should execute on right now."""
        with self._lock:
            return self._backend

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def baseline_s(self) -> float | None:
        with self._lock:
            return self._baseline

    # -- events -------------------------------------------------------------
    def record_latency(self, dt_s: float) -> str | None:
        """Feed one dispatch/step wall time.  Returns the new lane name
        when this observation tipped a sustained-degradation rung, else
        ``None``."""
        with self._lock:
            if self._baseline is None:
                self._warm.append(float(dt_s))
                if len(self._warm) >= self.warmup:
                    self._baseline = float(np.median(self._warm))
                return None
            fleet = np.array([dt_s] + [self._baseline] * 3)
            res = self.monitor.observe(fleet)
            if res["actions"].get(0) is None:
                return None
            name = self._degrade_locked(
                f"latency sustained {res['ratio'][0]:.2f}x baseline "
                f"({res['actions'][0]})")
            # the flag condition was measured against the OLD lane;
            # restart the evidence window for the new one
            self.monitor.flag_streak[:] = 0
            self.monitor.initialized = False
            return name

    def notify_device_loss(self, exc: BaseException | None = None
                           ) -> str | None:
        """A dispatch observed a lost device: degrade NOW.  Returns the
        new lane name, or ``None`` when the ladder is exhausted (the
        caller should let the loss propagate)."""
        with self._lock:
            return self._degrade_locked(
                f"device loss{f': {exc}' if exc else ''}")

    def degrade(self, reason: str = "manual") -> str | None:
        """Force one rung down the ladder (control-plane surface)."""
        with self._lock:
            return self._degrade_locked(reason)

    # -- internals ----------------------------------------------------------
    def _degrade_locked(self, reason: str) -> str | None:
        from repro_torch.core import backends as _backends
        if self._exhausted:
            return None
        prev = self._backend.name
        healthy = np.nonzero(self.mesh_manager.hosts.healthy)[0]
        if healthy.size:
            self.mesh_manager.mark_failed(int(healthy[-1]))
        try:
            n_dev, _ = self.mesh_manager.current_grid()
        except ValueError:
            # no feasible grid survives — final rung: single-device lane
            new = _backends.get_backend(self.fallback)
            self._exhausted = True
        else:
            new = _backends.ShardedBackend(
                self._devices[:n_dev], name=f"{self._base.name}@{n_dev}")
            # carry the fault injector down the ladder so a chaos plan
            # can lose a second device from the already-shrunken lane
            new._injector = getattr(self._backend, "_injector", None)
            # re-register so the rung is selectable by name everywhere a
            # backend name is accepted; its first dispatch re-shards
            _backends.register(new, overwrite=True)
        self._backend = new
        self.degradations += 1
        self.history.append({
            "event": "degrade", "reason": reason, "from": prev,
            "to": new.name, "t": time.monotonic(),
            "surviving_devices": int(
                self.mesh_manager.hosts.healthy_chips),
        })
        return new.name
