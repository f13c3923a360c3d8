"""CoDR weight compression as a serving feature — the accounting half of
``repro.core.serving``.

``codr_compress_params`` runs the paper's offline pipeline over every
large leaf of a params tree: int8 quantization → unique-weight budget U
→ UCR → customized RLE parameter search.  It returns the params with the
quantization *applied* (the quantize-applied reference lane: what
serving from the compressed weights must reproduce) and a per-tensor
report of encoded bits (CoDR) vs UCNN / SCNN / the fixed-width pack.

The RLE accounting is NumPy on the host, as in the reference; the
applied quantization is torch on the leaf's device, with the arithmetic
of :func:`repro_torch.core.codr_linear.quantize_restrict`.

The serving half: :class:`AsyncWorkerLoop`, the worker-thread chassis
shared with :class:`repro_torch.core.batching.ContinuousBatcher`, and
:class:`CodrBatchServer`, the bucketed sync/async batch server over a
compiled CNN (``CompiledModel.serve``).  Its async path stages each
batch into pinned host memory and copies it to the card on a side
stream while the previous batch computes.  Fault injection, retry with
quarantine and supervised worker restart come from
:mod:`repro_torch.runtime.resilience`; with none configured every path
is the unconfigured one.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent import futures

import numpy as np
import torch

from repro_torch.core import rle, ucr
from repro_torch.core.baselines import scnn_compress_bits, ucnn_compress_bits
from repro_torch.core.codr_linear import choose_bits, quantize_restrict
from repro_torch.core.tree import map_with_path
from repro_torch.runtime.resilience import (DeadlineExceeded,
                                            QuarantinedError, RejectedError,
                                            WorkerCrashed, retry_call)

__all__ = ["MIN_COMPRESS_SIZE", "TensorReport", "compress_tensor",
           "account_tensor", "codr_compress_params", "codr_report",
           "codr_serving_stats", "AsyncWorkerLoop", "FlushDispatchError",
           "CodrBatchServer"]

MIN_COMPRESS_SIZE = 1024           # skip tiny leaves (norms, biases)


@dataclasses.dataclass
class TensorReport:
    """Per-tensor compression accounting.  ``codr/ucnn/scnn_bits`` are
    the variable-width storage formats; ``pack_bits`` is the size of the
    fixed-width unique-index pack the decode-fused kernel executes from
    (the weight traffic of the serving path)."""

    path: str
    n_weights: int
    codr_bits: int
    ucnn_bits: int
    scnn_bits: int
    density: float
    n_unique_mean: float
    pack_bits: int = 0

    @property
    def codr_bits_per_weight(self) -> float:
        return self.codr_bits / self.n_weights

    @property
    def pack_bits_per_weight(self) -> float:
        return self.pack_bits / self.n_weights


def compress_tensor(w: np.ndarray, *, n_unique: int = 256, t_m: int = 256
                    ) -> tuple[np.ndarray, dict]:
    """Offline CoDR pipeline for one (d_in, d_out) matrix.  Returns the
    dequantized-after-restriction tensor + size accounting."""
    q, scale = ucr.quantize_int8(w)
    q = ucr.restrict_unique(q, n_unique)
    # UCR per output-column-tile vector (linear layer = 1×1-kernel conv)
    ucrs = []
    m, n = q.shape[1], q.shape[0]       # weights stored (d_in, d_out)
    qt = q.T                            # (M=d_out, N=d_in)
    for m0 in range(0, m, t_m):
        tile = qt[m0 : m0 + t_m]
        for nn in range(n):
            ucrs.append(ucr.ucr_transform(tile[:, nn]))
    codr_bits = rle.layer_bits_size_only(ucrs, min(t_m, m))
    report = {
        "codr_bits": codr_bits,
        "ucnn_bits": ucnn_compress_bits(ucrs),
        "scnn_bits": scnn_compress_bits(q),
        "density": float((q != 0).mean()),
        "n_unique_mean": float(np.mean([len(u.unique_vals) for u in ucrs])),
        "pack_bits": int(q.size) * choose_bits(
            max(int(len(np.unique(q))), 2)),
    }
    deq = ucr.dequantize_int8(q, scale)
    return deq.astype(np.float32), report


def account_tensor(mat: np.ndarray, *, n_unique: int,
                   sample_rows: int | None) -> dict:
    """Sampled RLE/baseline accounting for one ``(rows, d_out)`` matrix:
    encode the leading ``sample_rows`` rows, scale the bit counts back up
    by the sampled fraction."""
    rows = mat.shape[0]
    if sample_rows and rows > sample_rows:
        sub, scale_f = mat[:sample_rows], rows / sample_rows
    else:
        sub, scale_f = mat, 1.0
    _, rep = compress_tensor(sub, n_unique=n_unique)
    out = {k: int(rep[k] * scale_f)
           for k in ("codr_bits", "ucnn_bits", "scnn_bits", "pack_bits")}
    out["density"] = rep["density"]
    out["n_unique_mean"] = rep["n_unique_mean"]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def codr_compress_params(params, *, n_unique: int = 16,
                         sample_rows: int | None = 4096):
    """Compress every large 2-D+ leaf; returns ``(new_params, reports)``.

    ``sample_rows`` bounds the RLE accounting work per tensor (the
    leading rows of the ``(rows, d_out)`` reshape, scaled back up); the
    quantization is always applied to the full tensor."""
    reports = []

    def leaf_fn(path, leaf):
        if leaf.dim() < 2 or leaf.numel() < MIN_COMPRESS_SIZE:
            return leaf
        mat = leaf.reshape(-1, leaf.shape[-1])
        acc = account_tensor(_host(mat), n_unique=n_unique,
                             sample_rows=sample_rows)
        full_deq, _ = _quantize_only(mat, n_unique)
        reports.append(TensorReport(path=path, n_weights=leaf.numel(),
                                    **acc))
        return full_deq.reshape(leaf.shape).to(leaf.dtype)

    return map_with_path(leaf_fn, params), reports


def _quantize_only(mat: torch.Tensor, n_unique: int):
    q, scale, _ = quantize_restrict(mat, n_unique)
    return q.to(torch.float32) * scale, q


def codr_report(reports: list[TensorReport], *,
                per_tensor: bool = False) -> str:
    """Aggregate compression report; ``per_tensor=True`` appends one row
    per tensor (path, mean unique count, measured CoDR and pack
    bits/weight)."""
    tot_w = sum(r.n_weights for r in reports)
    tot_codr = sum(r.codr_bits for r in reports)
    tot_ucnn = sum(r.ucnn_bits for r in reports)
    tot_scnn = sum(r.scnn_bits for r in reports)
    tot_pack = sum(r.pack_bits for r in reports)
    lines = [
        f"CoDR weight compression over {len(reports)} tensors "
        f"({tot_w/1e6:.1f}M weights):",
        f"  CoDR : {tot_codr/tot_w:.2f} bits/weight "
        f"({16*tot_w/max(tot_codr,1):.1f}x vs bf16)",
        f"  UCNN : {tot_ucnn/tot_w:.2f} bits/weight "
        f"(CoDR {tot_ucnn/max(tot_codr,1):.2f}x better)",
        f"  SCNN : {tot_scnn/tot_w:.2f} bits/weight "
        f"(CoDR {tot_scnn/max(tot_codr,1):.2f}x better)",
    ]
    if tot_pack:
        lines.append(
            f"  pack : {tot_pack/tot_w:.2f} bits/weight fixed-width "
            f"unique-index pack (serving HBM traffic, "
            f"{16*tot_w/max(tot_pack,1):.1f}x vs bf16)")
    if per_tensor:
        lines.append(f"  {'tensor':<40} {'weights':>9} {'uniq':>6} "
                     f"{'codr b/w':>9} {'pack b/w':>9}")
        for r in reports:
            pack = (f"{r.pack_bits_per_weight:9.2f}" if r.pack_bits
                    else f"{'-':>9}")
            lines.append(f"  {r.path:<40} {r.n_weights:>9} "
                         f"{r.n_unique_mean:6.1f} "
                         f"{r.codr_bits_per_weight:9.2f} {pack}")
    return "\n".join(lines)


def codr_serving_stats(cfg, *, n_unique: int = 16, seed: int = 0,
                       reports: list[TensorReport] | None = None) -> dict:
    """Per-decode-token weight traffic under each format (GB).

    With ``reports`` (from a real ``codr_compress_params`` /
    ``compile_params`` run) bits/weight is measured from the model's own
    tensors; without, it is extrapolated from one synthetic 512×512
    Gaussian matrix — ``stats["source"]`` says which, and printers label
    the synthetic path as an estimate."""
    n_active = cfg.active_param_count()
    if reports:
        tot_w = sum(r.n_weights for r in reports)
        bits_pw = sum(r.codr_bits for r in reports) / tot_w
        pack_pw = sum(r.pack_bits for r in reports) / tot_w
        source = "measured"
    else:
        rng = np.random.default_rng(seed)
        w = rng.normal(size=(512, 512)).astype(np.float32) * 0.02
        _, rep = compress_tensor(w, n_unique=n_unique)
        bits_pw = rep["codr_bits"] / w.size
        pack_pw = rep["pack_bits"] / w.size
        source = "synthetic-estimate"
    return {
        "bf16_gb": n_active * 2 / 1e9,
        "int8_gb": n_active * 1 / 1e9,
        "codr_gb": n_active * bits_pw / 8 / 1e9,
        "codr_bits_per_weight": bits_pw,
        "pack_bits_per_weight": pack_pw,
        "source": source,
    }


# ---------------------------------------------------------------------------
# async worker chassis (shared by CodrBatchServer and ContinuousBatcher)
# ---------------------------------------------------------------------------

class AsyncWorkerLoop:
    """Condition-variable worker-thread chassis: lazy daemon start,
    stop/drain/restart, and the can't-stop-from-the-worker guard.

    Subclasses provide the actual work:

    * :meth:`_loop` — the worker body.  It must re-check
      ``self._stopping`` under ``self._cv`` and return once stopping
      *and* (when draining) the pending work is gone.
    * :meth:`_cancel_pending_locked` — called under ``self._cv`` by
      ``stop_async(drain=False)`` to drop queued work (cancel futures,
      fail handles, ...).
    * :meth:`_fail_live_locked` — called under ``self._cv`` when the
      worker died, to deliver the failure to every live future/handle.

    All shared state transitions happen under ``self._cv``; subclasses
    take the same lock for their own queue state so one lock orders
    everything.

    **Supervision**: the worker thread runs :meth:`_loop` under
    :meth:`_run_worker`, which catches *any* escape — including
    ``BaseException`` crashes — and, when a ``RestartPolicy`` is
    configured via :meth:`configure_resilience`, backs off and re-enters
    the loop on the same thread, so every pending request survives the
    crash.  Past the restart budget (or with no policy) the crash fails
    every live future/handle with
    :class:`~repro_torch.runtime.resilience.WorkerCrashed`, so
    ``result()`` never hangs on a dead loop; the next submit starts a
    fresh worker.  ``configure_resilience`` also installs the fault
    injector (:meth:`_fire` is the site hook), the retry policy and the
    serving supervisor the subclasses dispatch under.
    """

    _thread_name = "async-worker"

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._worker: threading.Thread | None = None   # guarded-by: _cv
        self._stopping = False                         # guarded-by: _cv
        # -- resilience (all optional; None ⇒ the unconfigured path)
        self._injector = None           # runtime.resilience.FaultInjector
        self._retry_policy = None       # runtime.resilience.RetryPolicy
        self._restart_policy = None     # runtime.resilience.RestartPolicy
        self._supervisor = None         # runtime.resilience.ServingSupervisor
        self.worker_crashes = 0                        # guarded-by: _cv
        self.worker_restarts = 0                       # guarded-by: _cv

    # -- subclass hooks -----------------------------------------------------
    def _loop(self) -> None:
        raise NotImplementedError

    def _cancel_pending_locked(self) -> None:
        raise NotImplementedError

    def _fail_live_locked(self, exc: BaseException) -> None:
        """Under ``self._cv``: deliver ``exc`` to every live future /
        handle (pending *and* in-flight) so no caller hangs after the
        worker died for good.  Subclasses with queues must override."""

    # -- resilience ---------------------------------------------------------
    def configure_resilience(self, *, injector=None, retry_policy=None,
                             restart_policy=None, supervisor=None):
        """Install resilience hooks (all optional, from
        :mod:`repro_torch.runtime.resilience`): a ``FaultInjector``
        firing at this loop's sites, a ``RetryPolicy`` for transient
        dispatch failures (exhaustion ⇒ quarantine), a ``RestartPolicy``
        for worker crashes and a ``ServingSupervisor`` for latency watch
        and mesh degradation.  With none installed every code path is
        the unconfigured one.  Returns ``self``."""
        with self._cv:
            self._injector = injector
            self._retry_policy = retry_policy
            self._restart_policy = restart_policy
            self._supervisor = supervisor
        return self

    def _fire(self, site: str) -> None:
        """Fault-injection site hook: one attribute load + ``None``
        check when disabled — the cost a production dispatch pays."""
        inj = self._injector
        if inj is not None:
            inj.fire(site)

    def _guarded(self, fn):
        """Run one dispatch under the retry / supervisor ladder; exactly
        ``fn()`` when neither is configured."""
        return retry_call(fn, policy=self._retry_policy,
                          supervisor=self._supervisor)

    def _run_worker(self) -> None:
        """Thread target: supervise :meth:`_loop`.  A normal return ends
        the thread; any escape (an ``Exception`` or a ``BaseException``
        crash) consumes one restart from the ``RestartPolicy`` budget and
        re-enters the loop after backoff, pending work intact.  Budget
        exhausted (or no policy) ⇒ fail all live work with
        ``WorkerCrashed`` (chaining the cause) and clear ``self._worker``
        so a later submit can lazily start a fresh worker."""
        while True:
            try:
                self._loop()
                return
            except BaseException as e:  # noqa: BLE001 — supervision net
                with self._cv:
                    self.worker_crashes += 1
                    pol = self._restart_policy
                    if (pol is not None and not self._stopping
                            and self.worker_restarts < pol.max_restarts):
                        n = self.worker_restarts
                        self.worker_restarts += 1
                    else:
                        err = WorkerCrashed(
                            f"{self._thread_name} worker died: {e!r}"
                            + ("" if pol is None else
                               f" (restart budget {pol.max_restarts} "
                               "exhausted)"))
                        err.__cause__ = e
                        # clear the thread slot BEFORE failing waiters: a
                        # woken submitter may resubmit at once and must
                        # be able to start a fresh worker
                        self._worker = None
                        self._fail_live_locked(err)
                        self._cv.notify_all()
                        return
                time.sleep(pol.delay(n))

    # -- lifecycle ----------------------------------------------------------
    def start_async(self):
        """Start the worker explicitly (idempotent)."""
        with self._cv:
            if self._stopping:
                raise RuntimeError(f"{type(self).__name__} is stopping")
            if self._worker is None or not self._worker.is_alive():
                self._start_locked()
        return self

    def _start_locked(self) -> None:
        self._worker = threading.Thread(target=self._run_worker,
                                        name=self._thread_name,
                                        daemon=True)
        self._worker.start()

    def stop_async(self, *, drain: bool = True) -> None:
        """Stop the worker.  ``drain=True`` (default) lets it finish the
        pending work first; ``drain=False`` cancels pending work.
        Idempotent; the loop can be restarted with :meth:`start_async`
        afterwards.  Must not be called from the worker itself (e.g.
        inside a ``Future`` done-callback, which runs on the worker
        thread) — that raises ``RuntimeError`` without corrupting state.
        """
        with self._cv:
            worker = self._worker
            if worker is threading.current_thread():
                raise RuntimeError(
                    f"stop_async called from the {self._thread_name} "
                    "worker itself (done callbacks run on the worker "
                    "thread) — stop from another thread")
            self._stopping = True
            if not drain:
                self._cancel_pending_locked()
            self._cv.notify_all()
        try:
            if worker is not None:
                worker.join()
        finally:
            with self._cv:
                self._worker = None
                self._stopping = False

    def __enter__(self):
        return self.start_async()

    def __exit__(self, *exc) -> None:
        self.stop_async(drain=True)


# ---------------------------------------------------------------------------
# batched request path over a CoDR engine model
# ---------------------------------------------------------------------------

class FlushDispatchError(RuntimeError):
    """A :meth:`CodrBatchServer.flush` chunk dispatch failed.

    Attributes:
        partial: submission-order output list for the flushed queue —
            rows computed by chunks that succeeded before the failure,
            ``None`` elsewhere.
        failed: queue positions (within the flushed queue) of the
            requests in the chunk whose dispatch raised.  These are
            consumed, not requeued.
        requeued: how many undispatched requests were restored to the
            server queue (they will be served by the next ``flush``).
    """

    def __init__(self, msg: str, *, partial, failed, requeued):
        super().__init__(msg)
        self.partial = partial
        self.failed = failed
        self.requeued = requeued


@dataclasses.dataclass
class _AsyncReq:
    """One queued async request: the sample, its future, and the
    absolute monotonic deadline (``None`` ⇒ no deadline)."""

    sample: np.ndarray
    future: futures.Future
    deadline: float | None = None


def _to_host(y: torch.Tensor) -> np.ndarray:
    """A model output as a host array (waits for the device)."""
    return y.detach().to("cpu").numpy()


class CodrBatchServer(AsyncWorkerLoop):
    """Batched inference over a CoDR executable (a
    :class:`repro_torch.core.engine.CodrModel` or a
    :class:`repro_torch.core.api.CompiledModel` — anything with ``.run``
    and ``.device``).

    Single-sample requests are queued and executed together in batches,
    the serving-side complement of the engine's encode-once/run-many
    contract.  Dispatch is **size-bucketed**: requests are grouped by
    sample shape, and ragged tail batches are padded (with copies of the
    last sample) up to the next power-of-two bucket (≤ ``max_batch``),
    so a mixed stream runs at most ``len(shapes) × log2(max_batch)+1``
    batch shapes while padding waste stays below 2x.

    Two request paths share that dispatch core:

    * **Synchronous** — :meth:`submit` + :meth:`flush` (or
      :meth:`serve`): the caller owns batching cadence; a dispatch
      failure raises out of ``flush``.
    * **Asynchronous** — :meth:`submit_async` returns a
      :class:`concurrent.futures.Future` immediately; a background flush
      loop dispatches when either ``max_batch`` requests are pending
      (load trigger) or the oldest pending request has waited
      ``flush_deadline_s`` (latency trigger).  Consecutive batches are
      **double-buffered**: on the card, batch *i+1* is staged in pinned
      host memory and copied on a side stream while batch *i* computes;
      the compute stream waits on the copy's event.  A dispatch failure
      — a failed staging copy included — propagates into exactly the
      futures of the failed batch; other batches are unaffected.

    Outputs are host ``np.ndarray`` rows, as in the reference.  The loop
    starts lazily on first ``submit_async`` (or via :meth:`start_async`)
    and is joined by :meth:`stop_async` / ``with server: ...``.
    """

    _thread_name = "codr-batch-server"

    def __init__(self, model, *, max_batch: int = 8,
                 flush_deadline_s: float = 0.01,
                 max_pending: int | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if flush_deadline_s <= 0:
            raise ValueError("flush_deadline_s must be > 0")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        super().__init__()                  # _cv / _worker / _stopping
        self.model = model
        self.max_batch = max_batch
        self.flush_deadline_s = flush_deadline_s
        self.max_pending = max_pending      # bounded admission (None=∞)
        device = getattr(model, "device", None)
        # the async path's copy stream (used by the worker thread only)
        self._copy_stream = (torch.cuda.Stream(device) if device is not None
                             and device.type == "cuda" else None)
        self._queue: list[tuple[np.ndarray, float | None]] = []  # guarded-by: _cv
        self._next_id = 0                   # guarded-by: _cv
        self.batches_run = 0                # guarded-by: _cv
        self.requests_served = 0            # guarded-by: _cv
        self.bucket_counts: dict[int, int] = {}   # guarded-by: _cv
        self.requests_shed = 0              # guarded-by: _cv
        self.requests_expired = 0           # guarded-by: _cv
        self.requests_quarantined = 0       # guarded-by: _cv
        self.quarantined: list[dict] = []   # guarded-by: _cv
        # -- async state ------------------------------------------------
        self._async_queue: list[_AsyncReq] = []   # guarded-by: _cv
        self._oldest_t: float | None = None       # guarded-by: _cv

    def _bucket(self, n_real: int) -> int:
        b = 1
        while b < n_real:
            b *= 2
        return min(b, self.max_batch)

    def _chunks(self, samples: list[np.ndarray]):
        """Shared batching core: group positions by sample shape, split
        into ≤ ``max_batch`` chunks, pad each to its power-of-two bucket.
        Yields ``(positions, batch, n_real, bucket)`` with ``batch`` a
        stacked host array of ``bucket`` rows."""
        by_shape: dict[tuple, list[int]] = {}
        for pos, x in enumerate(samples):
            by_shape.setdefault(x.shape, []).append(pos)
        for positions in by_shape.values():
            for i in range(0, len(positions), self.max_batch):
                chunk_pos = positions[i : i + self.max_batch]
                chunk = [samples[p] for p in chunk_pos]
                n_real = len(chunk)
                bucket = self._bucket(n_real)
                if n_real < bucket:          # pad → bucketed batch shape
                    chunk = chunk + [chunk[-1]] * (bucket - n_real)
                yield chunk_pos, np.stack(chunk), n_real, bucket

    def _count(self, n_real: int, bucket: int) -> None:
        # locked: the sync flush (caller thread) and the async flush
        # loop (worker thread) both account onto these counters
        with self._cv:
            self.batches_run += 1
            self.requests_served += n_real
            self.bucket_counts[bucket] = \
                self.bucket_counts.get(bucket, 0) + 1

    def _admit_deadline(self, deadline_s: float | None) -> float | None:
        if deadline_s is None:
            return None
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        return time.monotonic() + deadline_s

    def _shed_locked(self, pending: int) -> None:
        """Under ``self._cv``: reject admission when the bounded queue
        is full (``RejectedError`` with a retry-after hint — one flush
        deadline is when capacity frees up at the latest)."""
        if self.max_pending is not None and pending >= self.max_pending:
            self.requests_shed += 1
            raise RejectedError(
                f"admission queue full ({pending}/{self.max_pending} "
                f"pending); retry in ~{self.flush_deadline_s:.3f}s",
                retry_after_s=self.flush_deadline_s)

    # -- synchronous path ---------------------------------------------------
    def submit(self, x: np.ndarray, *, deadline_s: float | None = None
               ) -> int:
        """Queue one sample (no batch dim).  Returns its request id.

        Ids come from a dedicated monotonic counter, issued exactly once,
        forever — never derived from ``requests_served``, which advances
        in chunk order during :meth:`flush`.

        ``deadline_s`` bounds how long the request may wait in the
        queue: if the next :meth:`flush` starts after the deadline, the
        request is dropped (its output row is ``None``, counted in
        ``requests_expired``).  With ``max_pending`` set, a full queue
        rejects admission with ``RejectedError``.

        Thread-safe: queue append and id issue happen under the same
        lock the async worker and :meth:`flush` take.
        """
        sample = np.asarray(x, dtype=np.float32)
        deadline = self._admit_deadline(deadline_s)
        with self._cv:
            self._shed_locked(len(self._queue))
            self._queue.append((sample, deadline))
            rid = self._next_id
            self._next_id += 1
        return rid

    def flush(self) -> list[np.ndarray]:
        """Run all queued requests; returns outputs in submission order.

        If a chunk's dispatch raises, the failure is re-raised as
        :class:`FlushDispatchError` carrying the already-computed
        partial results, and every *undispatched* request is restored
        to the queue head (submission order preserved) so the next
        ``flush`` serves them.  The failed chunk itself is NOT
        requeued: a poison request would otherwise kill every
        subsequent flush.

        With a :class:`~repro_torch.runtime.resilience.RetryPolicy`
        configured, *transient* chunk failures retry with backoff first;
        only retry-budget exhaustion (the chunk is then recorded in
        ``self.quarantined``) or a non-transient error reaches the
        ``FlushDispatchError`` path.  Requests whose ``deadline_s``
        already passed are dropped up front (``None`` output row,
        ``requests_expired``).
        """
        with self._cv:
            queue, self._queue = self._queue, []
        outs: list[np.ndarray | None] = [None] * len(queue)
        live_pos = list(range(len(queue)))
        if any(d is not None for _, d in queue):
            now = time.monotonic()
            live_pos = [p for p in live_pos
                        if queue[p][1] is None or now < queue[p][1]]
            if len(live_pos) < len(queue):
                with self._cv:
                    self.requests_expired += len(queue) - len(live_pos)
        chunks = list(self._chunks([queue[p][0] for p in live_pos]))
        for ci, (chunk_pos, batch, n_real, bucket) in enumerate(chunks):
            try:
                y = self._guarded_dispatch(batch)
            except Exception as e:          # noqa: BLE001 — rewrapped
                qpos = [live_pos[p] for p in chunk_pos]
                self._note_quarantine(e, n_real)
                tail = sorted(live_pos[p] for c in chunks[ci + 1:]
                              for p in c[0])
                with self._cv:
                    self._queue[:0] = [queue[p] for p in tail]
                raise FlushDispatchError(
                    f"dispatch failed on a chunk of {n_real} request(s) "
                    f"(bucket {bucket}); {len(tail)} undispatched "
                    f"request(s) restored to the queue",
                    partial=outs, failed=qpos,
                    requeued=len(tail)) from e
            for p, row in zip(chunk_pos, y[:n_real]):
                outs[live_pos[p]] = row
            self._count(n_real, bucket)
        return outs

    def _model_run(self, batch):
        """One model dispatch, routed through the supervisor's current
        lane when one is installed (a degradation changes the backend)."""
        sup = self._supervisor
        if sup is not None:
            return self.model.run(batch, backend=sup.backend)
        return self.model.run(batch)

    def _guarded_dispatch(self, batch: np.ndarray) -> np.ndarray:
        """Dispatch one host chunk under the resilience ladder: fire the
        injection site, run on the current lane, block to host.
        Transient failures re-execute with backoff (a dispatch writes
        nothing but its own output, so a re-run is a first run); with a
        supervisor, a device loss degrades the lane and retries there,
        and the chunk's wall time feeds its latency watch.  Unconfigured
        this is exactly one attempt."""

        def _attempt():
            self._fire("server.dispatch")
            return _to_host(self._model_run(batch))

        sup = self._supervisor
        t0 = time.monotonic()
        y = self._guarded(_attempt)
        if sup is not None:
            sup.record_latency(time.monotonic() - t0)
        return y

    def _note_quarantine(self, exc: BaseException, n_real: int) -> None:
        """Record a consumed-not-requeued chunk.  Only exhaustion of a
        configured retry budget counts as quarantine; a plain dispatch
        error without a policy is not recorded."""
        if not isinstance(exc, QuarantinedError):
            return
        with self._cv:
            self.requests_quarantined += n_real
            self.quarantined.append({
                "n_requests": n_real, "attempts": exc.attempts,
                "error": repr(exc.__cause__ or exc),
                "t": time.monotonic()})
            del self.quarantined[:-64]      # bounded log

    def serve(self, samples) -> list[np.ndarray]:
        """Convenience: submit + flush a list of single samples."""
        for s in samples:
            self.submit(s)
        return self.flush()

    # -- asynchronous path --------------------------------------------------
    @property
    def async_pending(self) -> int:
        """Requests submitted via :meth:`submit_async` not yet dispatched."""
        with self._cv:
            return len(self._async_queue)

    def submit_async(self, x: np.ndarray, *,
                     deadline_s: float | None = None) -> futures.Future:
        """Queue one sample (no batch dim) on the background flush loop.

        Returns immediately with a :class:`concurrent.futures.Future`
        that resolves to this sample's output row (host ``np.ndarray``)
        once its batch is dispatched — by the ``max_batch`` load trigger
        or the ``flush_deadline_s`` latency trigger, whichever fires
        first.  If the batch's staging or dispatch raises, the exception
        lands on the future.  Starts the flush loop if it is not
        running.  Raises ``RuntimeError`` after :meth:`stop_async` began
        (a future that could never resolve must not be issued).

        ``deadline_s`` bounds queue wait: a request still undispatched
        when its deadline passes resolves to
        :class:`~repro_torch.runtime.resilience.DeadlineExceeded`.  With
        ``max_pending`` set, a full admission queue sheds the request
        with ``RejectedError`` (``retry_after_s`` hint).
        """
        fut: futures.Future = futures.Future()
        sample = np.asarray(x, dtype=np.float32)
        deadline = self._admit_deadline(deadline_s)
        with self._cv:
            if self._stopping:
                raise RuntimeError("server is stopping; submit_async "
                                   "rejected (future would never resolve)")
            self._shed_locked(len(self._async_queue))
            if self._worker is None or not self._worker.is_alive():
                self._start_locked()
            self._async_queue.append(_AsyncReq(sample, fut, deadline))
            if self._oldest_t is None:
                self._oldest_t = time.monotonic()
            self._cv.notify_all()
        return fut

    def _cancel_pending_locked(self) -> None:
        for req in self._async_queue:
            req.future.cancel()
        self._async_queue.clear()
        self._oldest_t = None

    def _fail_live_locked(self, exc: BaseException) -> None:
        # the worker died: every undispatched future gets the
        # WorkerCrashed (already-cancelled ones stay cancelled)
        for req in self._async_queue:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)
        self._async_queue.clear()
        self._oldest_t = None

    def _loop(self) -> None:
        """Background worker: wait for a trigger, take the whole queue,
        dispatch it bucketed with double-buffered staging."""
        while True:
            # injection site "server.worker": fires BEFORE the queue is
            # taken, so a crash here leaves every pending request queued
            self._fire("server.worker")
            with self._cv:
                while not self._stopping:
                    if len(self._async_queue) >= self.max_batch:
                        break                      # load trigger
                    if self._oldest_t is not None:
                        wait = (self._oldest_t + self.flush_deadline_s
                                - time.monotonic())
                        if wait <= 0:
                            break                  # latency trigger
                        self._cv.wait(wait)
                    else:
                        self._cv.wait()
                taken = self._async_queue
                self._async_queue = []
                self._oldest_t = None
                stopping = self._stopping
            if taken:
                self._dispatch_async(taken)
            if stopping:
                return

    def _stage(self, batch: np.ndarray):
        """Start one host chunk's transfer to the model's device: pinned
        host memory, a non-blocking copy on the side stream, and an
        event recorded after it.  On a CPU model this is the host array
        itself."""
        if self._copy_stream is None:
            return batch
        host = torch.from_numpy(batch).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            x = host.to(self._copy_stream.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return x, ready, host

    def _try_stage(self, batch: np.ndarray):
        """:meth:`_stage`, with a failure returned rather than raised: it
        belongs to that batch alone, and :meth:`_run_staged` raises it on
        the batch's turn, so it lands on exactly that batch's futures."""
        try:
            return self._stage(batch)
        except Exception as e:      # noqa: BLE001 — raised on the batch's turn
            return e

    def _run_staged(self, staged) -> torch.Tensor:
        """Run the model on a staged chunk: the compute stream waits for
        the copy, and the batch's device memory is marked as used on the
        compute stream so the allocator cannot hand it out before the
        compute is done."""
        if isinstance(staged, Exception):
            raise staged
        if isinstance(staged, np.ndarray):
            return self.model.run(staged)
        x, ready, _host = staged
        compute = torch.cuda.current_stream(x.device)
        compute.wait_event(ready)
        x.record_stream(compute)
        return self.model.run(x)

    def _dispatch_async(self, taken) -> None:
        """Run one drained queue: stage batch i+1's host→device transfer
        while batch i computes (double buffering), resolve each batch's
        futures as its results arrive, and propagate a failed staging or
        dispatch into exactly that batch's futures.  With resilience
        configured the chunks go through :meth:`_guarded_dispatch`
        instead (:meth:`_dispatch_chunks_resilient`); the unconfigured
        path is the staged one."""
        # drop requests cancelled while queued BEFORE batching — they
        # must neither burn compute nor inflate requests_served (this
        # also moves every surviving future to RUNNING, so a cancel
        # arriving after this point is a no-op).  Deadline-expired
        # requests resolve to DeadlineExceeded here, for the same reason
        live = []
        now = time.monotonic()
        expired = 0
        for req in taken:
            if not req.future.set_running_or_notify_cancel():
                continue
            if req.deadline is not None and now >= req.deadline:
                expired += 1
                req.future.set_exception(DeadlineExceeded(
                    "deadline expired before dispatch"))
                continue
            live.append(req)
        if expired:
            with self._cv:
                self.requests_expired += expired
        if not live:
            return
        futs = [r.future for r in live]
        chunks = list(self._chunks([r.sample for r in live]))
        if (self._retry_policy is not None or self._supervisor is not None
                or self._injector is not None):
            self._dispatch_chunks_resilient(chunks, futs)
            return
        staged: list = [None] * len(chunks)
        staged[0] = self._try_stage(chunks[0][1])
        for i, (chunk_pos, _, n_real, bucket) in enumerate(chunks):
            try:
                y_dev = self._run_staged(staged[i])
            except Exception as e:      # noqa: BLE001 — lands on futures
                y_dev, err = None, e
            else:
                err = None
            if i + 1 < len(chunks):     # overlaps with batch i's compute
                staged[i + 1] = self._try_stage(chunks[i + 1][1])
            if err is None:
                try:
                    y = _to_host(y_dev)     # block on batch i only
                except Exception as e:  # noqa: BLE001 — lands on futures
                    err = e
            staged[i] = None            # release batch i's buffers
            if err is None:
                # account BEFORE resolving: a caller waking up on
                # Future.result() must already see this batch counted
                self._count(n_real, bucket)
            for j, p in enumerate(chunk_pos):
                if err is not None:
                    futs[p].set_exception(err)
                else:
                    futs[p].set_result(y[j])

    def _dispatch_chunks_resilient(self, chunks, futs) -> None:
        """Async dispatch under the resilience ladder: each chunk runs
        through :meth:`_guarded_dispatch` (fire site → current lane →
        block), retries transients, quarantines on budget exhaustion
        (that chunk's futures get the ``QuarantinedError``; later chunks
        are served) and feeds per-chunk latency to the supervisor.
        No staging overlap here — a retried chunk owns its dispatch end
        to end."""
        for chunk_pos, batch, n_real, bucket in chunks:
            try:
                y = self._guarded_dispatch(batch)
            except Exception as e:      # noqa: BLE001 — lands on futures
                self._note_quarantine(e, n_real)
                for p in chunk_pos:
                    futs[p].set_exception(e)
                continue
            self._count(n_real, bucket)
            for j, p in enumerate(chunk_pos):
                futs[p].set_result(y[j])
