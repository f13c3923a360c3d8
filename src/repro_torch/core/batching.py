"""Continuous batching: a production decode loop over packed weights —
the port's copy of ``repro.core.batching``.

``ContinuousBatcher`` runs a fixed pool of KV-cache slots (one pooled
cache whose batch axis is the slot axis) and drives every *active* slot
forward with a single pooled ``decode_step`` per iteration:

* **join-on-prefill** — a new request is prefilled on its own (batch-1,
  its exact prompt length) and its cache block-written into a free slot
  (:func:`repro_torch.models.cache.write_slot`); the pooled decode batch
  never stalls behind a long prompt.
* **leave-on-EOS** — a slot retires the moment its request samples
  ``eos_id`` or hits ``max_new_tokens``, freeing the slot (and, paged,
  its pages) for the next admission while the rest of the pool keeps
  decoding.
* **streaming** — :meth:`submit` returns a :class:`GenerationHandle`
  immediately; iterating it yields tokens as they are produced, and
  ``handle.result()`` blocks for the full sequence.

Per-request results are **bit-identical** to a solo decode of the same
prompt on the same params (:meth:`ContinuousBatcher.generate_reference`
is that oracle, on a fresh pool of the same ``n_slots``, so every
kernel sees the same row count): decode attention masks every cache
position beyond a slot's own ``pos``, so a neighbour slot's content —
or the stale tail a previous tenant left — contributes exactly 0.0, and
no kernel on the path mixes rows.

Where the reference jits ``decode_step``, the port captures the pooled
step over the batcher's pool as one CUDA graph
(:class:`repro_torch.models.lm.CapturedDecode`) and replays it; each
step copies the token and position vectors into the graph's static
buffers, and the paged pool's host page table into the pool, before the
replay.  Prefill stays eager (the reference retraces its jitted prefill
for every prompt length); so do the CPU and ``eager=True``.  The
capture happens on the worker thread, at the first pooled step, with
``capture_error_mode="thread_local"``: callers may
run CUDA work of their own on other threads meanwhile, and a sync or an
allocation of theirs must not invalidate the capture.  The port's
decode writes the pool in place, so the oracles build pools of their
own, run eagerly, and never touch the batcher's.

**Retry and the in-place pool.**  With a ``RetryPolicy`` configured a
failed prefill or pooled step re-runs (``_attempt``), and a re-run step
must give what one clean step gives although the failed attempt may
have written some layers' rows already.  A step writes, per layer, the
row at each slot's ``pos`` and reads rows ``<= pos``:

* dense and bf16-paged pools: the write is a plain store.  Layer
  ``l``'s row depends on the step's inputs, on rows ``< pos`` (which no
  attempt of the step touches) and on the rows at ``pos`` of layers
  ``< l``, which the attempt itself writes first; so, layer by layer, a
  re-run stores the same bits again;
* int8-paged pools: the write requantizes the row's page under the
  grow-only scale ``s1 = max(s0, amax(row)/127)``.  Re-run from the
  attempt's result ``(q, s1)``: the scale stays ``s1`` (the same row,
  the same max), the new row rounds to the same byte, and every other
  byte ``q`` (``|q| <= 127``) comes back as ``round(fl(q·s1)/s1) = q``
  — float32 division after multiplication is off by at most a few
  units in the 24th bit, far below 0.5 — so the page is unchanged.

So a re-run writes the bits the failed attempt wrote, and reads what a
clean step reads; ``tests/test_torch_batching.py`` fails a step after
its first layer wrote and holds the retried run to the clean one on all
three pools.  The graph's first replay re-runs the eager warm-up step
in the same way.

An SSM mixer's state is different: a step reads the whole state and
writes it back advanced (``h ← decay·h + drive``), so a re-run over a
state that its failed attempt already wrote would advance it twice.  The
SSM models run on the dense pool only (a paged pool raises, as in the
reference), and with a ``RetryPolicy`` or a ``ServingSupervisor``
configured the pooled step saves the pool's SSM states
(``models.lm.recurrent_state``) before its first attempt and puts them
back before every attempt, so each attempt starts from the state a
clean step starts from; ``CapturedDecode`` does the same around its
eager warm-up.  ``tests/test_torch_ssm.py`` fails a step
after its first layer on the jamba and xlstm pools and holds the retried
run to the clean one.

The async chassis (condition-variable worker, lazy start, stop/drain/
restart, exception isolation) is :class:`repro_torch.core.serving
.AsyncWorkerLoop`, shared with ``CodrBatchServer``.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import time
from concurrent import futures

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.serving import AsyncWorkerLoop
from repro_torch.core.tree import leaves_with_path
from repro_torch.runtime.resilience import DeadlineExceeded, RejectedError

__all__ = ["GenerationHandle", "ContinuousBatcher"]

_DONE = object()                    # stream sentinel: generation finished


class GenerationHandle:
    """Streaming handle for one request.

    * iterate it (``for tok in handle``) to stream tokens as the pool
      produces them — the iterator ends at EOS/max-tokens and re-raises
      a generation failure;
    * ``handle.result(timeout)`` blocks for the full token list;
    * ``handle.finish_reason`` is ``"eos"``, ``"length"``,
      ``"cancelled"``, ``"deadline"`` or ``"error"`` once finished.

    Tokens are plain Python ints.  When the batcher was built with
    ``record_logits=True``, ``handle.logits`` holds one float32 vocab
    row per emitted token (the bit-identity witness).
    """

    def __init__(self, rid: int, prompt_len: int, max_new_tokens: int):
        self.rid = rid
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.finish_reason: str | None = None
        self.future: futures.Future = futures.Future()
        self.logits: list[np.ndarray] = []
        self._tokens: list[int] = []
        self._stream: queue_mod.SimpleQueue = queue_mod.SimpleQueue()

    # -- worker side --------------------------------------------------------
    def _emit(self, tok: int, logits_row: np.ndarray | None = None) -> None:
        self._tokens.append(tok)
        if logits_row is not None:
            self.logits.append(logits_row)
        self._stream.put(tok)

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.future.set_result(list(self._tokens))
        self._stream.put(_DONE)

    def _fail(self, exc: BaseException, reason: str = "error") -> None:
        self.finish_reason = reason
        self.future.set_exception(exc)
        self._stream.put(exc)

    # -- caller side --------------------------------------------------------
    def __iter__(self):
        while True:
            item = self._stream.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until generation finishes; returns all emitted tokens."""
        return self.future.result(timeout)

    @property
    def tokens(self) -> list[int]:
        """Tokens emitted so far (snapshot; may still be growing)."""
        return list(self._tokens)

    def done(self) -> bool:
        return self.future.done()


@dataclasses.dataclass
class _Slot:
    """One occupied pool slot (ACTIVE state of the slot machine)."""
    handle: GenerationHandle
    eos_id: int | None
    last_tok: int                   # token fed to the next decode step
    pos: int                        # cache position that step writes
    n_gen: int                      # tokens emitted so far
    deadline: float | None = None   # absolute monotonic deadline


@dataclasses.dataclass
class _Pending:
    """A submitted request waiting for a free slot (QUEUED state)."""
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None
    handle: GenerationHandle
    deadline: float | None = None   # absolute monotonic deadline


def _host_rows(logits: torch.Tensor) -> np.ndarray:
    """Logits as float32 host rows (waits for the device)."""
    return logits.detach().to("cpu", torch.float32).numpy()


class ContinuousBatcher(AsyncWorkerLoop):
    """Slot-pooled continuous-batching decode loop over an LM.

    ``params`` may be a params tree or a
    :class:`repro_torch.core.api.CompiledParams` (packed weights; its
    ``.params`` tree is served through the backend registry, so every
    projection runs on the ``codr_matmul`` kernel on the card).  The
    params must live on ``device`` — the card unless the caller passes
    ``device="cpu"``.  Decoder-only families only, without a frontend;
    SSM and hybrid models on the dense pool only.

    The worker admits up to ``prefill_per_step`` queued requests per
    iteration (each prefilled at its own prompt length, outside the
    decode batch), then advances every active slot with ONE pooled
    ``decode_step`` whose per-slot positions ride in a ``(n_slots,)``
    vector.  ``join_deadline_s > 0`` lets a partially-filled pool wait
    that long after an admission for co-riders before decoding resumes.

    On the card the pooled step replays a CUDA graph captured over the
    pool (module docstring); ``eager=True`` (tests and ``chip_smoke.py``)
    runs it eagerly instead.

    A failed *prefill* fails only its own request's handle; a failed
    pooled *decode step* fails the handles of exactly the slots that
    were active in it — after any configured retries
    (:meth:`configure_resilience`).  The worker survives both and keeps
    serving: a step that raised midway has written some layers' rows of
    its slots, which admission overwrites (the prompt region, the int8
    scales of every reserved page) or decode masks (beyond ``pos``).
    """

    _thread_name = "codr-continuous-batcher"

    def __init__(self, params, cfg, *, n_slots: int = 4, max_len: int = 128,
                 eos_id: int | None = None, prefill_per_step: int = 1,
                 join_deadline_s: float = 0.0, record_logits: bool = False,
                 max_pending: int | None = None,
                 kv_dtype: str = "bf16", kv_page_size: int | None = None,
                 kv_pages: int | None = None, device=None,
                 eager: bool = False):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        if kv_dtype == "int8" and kv_page_size is None:
            kv_page_size = 16            # int8 storage is always paged
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if cfg.family == "encdec" or cfg.frontend:
            raise NotImplementedError(
                "ContinuousBatcher supports decoder-only LM configs "
                f"(got family={cfg.family!r}, frontend={cfg.frontend!r})")
        super().__init__()
        from repro_torch.models import cache as cache_mod  # lazy: core → models
        from repro_torch.models import get_model, lm
        from repro_torch.models.lm import CapturedDecode
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_per_step = max(1, prefill_per_step)
        self.join_deadline_s = join_deadline_s
        self.record_logits = record_logits
        self.max_pending = max_pending      # bounded admission (None=∞)
        # CompiledParams duck-typing: serve from its packed tree
        self._params = getattr(params, "params", params)
        self._api = get_model(cfg)
        self._cache_mod = cache_mod
        if kv_page_size is not None:
            # paged KV: pool of fixed-size pages + per-slot page tables.
            # The page table lives host-side (self._kv_table) — admission
            # allocates, retirement frees by repointing rows at the
            # scratch page — and is pushed into the pool before every
            # decode step
            self._paged = cache_mod.PagedSpec(
                page_size=kv_page_size, max_len=max_len, n_slots=n_slots,
                kv_dtype=kv_dtype, n_pages=kv_pages)
            self._paged.total_pages     # validate geometry up front
            self._page_pool = cache_mod.PagePool(self._paged)
            self._slot_pages: list[list[int] | None] = [None] * n_slots  # guarded-by: _cv
            self._kv_table = np.zeros((n_slots, self._paged.max_pages),  # guarded-by: _cv
                                      np.int32)
            self._axes = None
        else:
            self._paged = None
            # slot axis per cache leaf, discovered structurally on the
            # meta device — no memory allocated
            self._axes = cache_mod.diff_axes(
                self._api.init_cache(cfg, 1, max_len, device="meta"),
                self._api.init_cache(cfg, 2, max_len, device="meta"))
        self._pool = self._new_pool()
        # the buffers a re-run step must put back first (module docstring)
        self._recurrent = lm.recurrent_state(cfg, self._pool)
        # the pooled step on the card: one graph captured over the pool
        self._graph = (None if eager or self.device.type != "cuda" else
                       CapturedDecode(self._params, self._pool, cfg, n_slots,
                                      device=self.device))
        self._slots: list[_Slot | None] = [None] * n_slots  # guarded-by: _cv
        self._pending: list[_Pending] = []  # guarded-by: _cv
        self._next_id = 0                   # guarded-by: _cv
        self._abort_active = False          # guarded-by: _cv
        self._last_admit_t: float | None = None   # guarded-by: _cv
        # stats (written by the worker under _cv)
        self.steps_run = 0                  # guarded-by: _cv
        self.prefills_run = 0               # guarded-by: _cv
        self.requests_finished = 0          # guarded-by: _cv
        self.peak_active = 0                # guarded-by: _cv
        self.requests_shed = 0              # guarded-by: _cv
        self.requests_expired = 0           # guarded-by: _cv

    # -- model calls ----------------------------------------------------------
    def _new_pool(self):
        return self._api.init_cache(self.cfg, self.n_slots, self.max_len,
                                    paged=self._paged, device=self.device)

    def _prefill_fn(self, params, prompt: np.ndarray):
        tokens = torch.from_numpy(prompt.astype(np.int64)[None, :]).to(
            self.device)
        return self._api.prefill(params, {"tokens": tokens}, self.cfg)

    def _step_fn(self, params, pool, toks: np.ndarray, poss: np.ndarray):
        tok = torch.from_numpy(toks.astype(np.int64))
        pos = torch.from_numpy(poss.astype(np.int64))
        if pool is self._pool and self._graph is not None:
            # the batcher's own pool on the card: copy the vectors into
            # the graph's static buffers and replay
            return self._graph(tok, pos), pool
        return self._api.decode_step(params, pool, tok.to(self.device),
                                     pos.to(self.device), self.cfg)

    def _write_fn(self, pool, cache, slot: int, kv_row=None):
        if self._paged is not None:
            return self._cache_mod.write_slot_paged(pool, cache, slot, kv_row)
        return self._cache_mod.write_slot(pool, cache, slot, self._axes)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: int | None = None,
               deadline_s: float | None = None) -> GenerationHandle:
        """Queue one prompt (1-D int token array).  Returns immediately
        with a :class:`GenerationHandle`; the worker starts lazily.
        ``eos_id`` overrides the batcher default for this request.

        The prompt plus its ``max_new_tokens`` headroom must fit the
        pool's ``max_len`` (a request that would overflow its KV slot
        mid-stream is rejected here with a ``ValueError``).
        ``deadline_s`` bounds the request's total latency — a request
        still queued (or still generating) when its deadline passes
        fails with ``DeadlineExceeded`` (``finish_reason ==
        "deadline"``).  With ``max_pending`` set, a full admission queue
        sheds with ``RejectedError``.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens} = {prompt.size + max_new_tokens} "
                f"exceeds pool max_len {self.max_len}: the request would "
                f"overflow its KV slot mid-stream (shorten the prompt or "
                f"lower max_new_tokens)")
        deadline = None
        if deadline_s is not None:
            if deadline_s <= 0:
                raise ValueError("deadline_s must be > 0 (or None)")
            deadline = time.monotonic() + deadline_s
        with self._cv:
            if self._stopping:
                raise RuntimeError(
                    "batcher is stopping; submit rejected (handle would "
                    "never resolve)")
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                self.requests_shed += 1
                raise RejectedError(
                    f"admission queue full ({len(self._pending)}/"
                    f"{self.max_pending} pending); retry once a slot "
                    "frees", retry_after_s=self.join_deadline_s or 0.05)
            handle = GenerationHandle(self._next_id, int(prompt.size),
                                      max_new_tokens)
            self._next_id += 1
            self._pending.append(_Pending(
                prompt, max_new_tokens,
                self.eos_id if eos_id is None else eos_id, handle,
                deadline))
            if self._worker is None or not self._worker.is_alive():
                self._start_locked()
            self._cv.notify_all()
        return handle

    @property
    def active(self) -> int:
        with self._cv:
            return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    def kv_bytes(self) -> int:
        """Measured bytes of the KV pool as stored — page data + scales
        + tables (paged) or the contiguous slot buffers (dense)."""
        total = 0
        for _, leaf in leaves_with_path(self._pool):
            for t in (leaf.tensors()
                      if isinstance(leaf, self._cache_mod.PagedKV)
                      else (leaf,)):
                total += t.numel() * t.element_size()
        return total

    # -- paged-KV bookkeeping (all under self._cv) ---------------------------
    def _pages_ok_locked(self) -> bool:
        """Can the head pending request reserve its full page budget?"""
        if self._paged is None or not self._pending:
            return True
        req = self._pending[0]
        need = self._paged.pages_for(req.prompt.size + req.max_new_tokens)
        return self._page_pool.available >= need

    def _release_pages_locked(self, slot_idx: int) -> None:
        """Free a retired/failed slot's pages and repoint its page-table
        row at the scratch page, so the pooled decode step's dead write
        for this now-inactive slot cannot land in a page that a new
        request may already own."""
        if self._paged is None:
            return
        pages = self._slot_pages[slot_idx]
        if pages:
            self._page_pool.free(pages)
        self._slot_pages[slot_idx] = None
        self._kv_table[slot_idx, :] = self._cache_mod.SCRATCH_PAGE

    # -- AsyncWorkerLoop hooks ----------------------------------------------
    def _cancel_pending_locked(self) -> None:
        self._abort_active = True
        for p in self._pending:
            p.handle._fail(futures.CancelledError(), reason="cancelled")
        self._pending.clear()

    def _fail_live_locked(self, exc: BaseException) -> None:
        # the worker died: every queued AND active handle gets the
        # failure — result() and the stream iterator must never hang on
        # a dead loop, even mid-generation
        for p in self._pending:
            if not p.handle.done():
                p.handle._fail(exc)
        self._pending.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                self._release_pages_locked(i)
                if not s.handle.done():
                    s.handle._fail(exc)

    def _loop(self) -> None:
        with self._cv:
            self._abort_active = False
        while True:
            # injection site "batcher.worker": fires with no queue or
            # slot state held mid-mutation
            self._fire("batcher.worker")
            with self._cv:
                while not self._stopping:
                    has_free = any(s is None for s in self._slots)
                    n_active = sum(s is not None for s in self._slots)
                    if (self._pending and has_free
                            and self._pages_ok_locked()):
                        break                       # admission work
                    if n_active:
                        # join deadline: a partially-filled pool lingers
                        # briefly after an admission so co-riders can
                        # join the decode batch
                        if (self.join_deadline_s > 0 and has_free
                                and self._last_admit_t is not None):
                            wait = (self._last_admit_t
                                    + self.join_deadline_s
                                    - time.monotonic())
                            if wait > 0:
                                self._cv.wait(wait)
                                continue
                        break                       # decode work
                    self._cv.wait()
                if self._stopping:
                    if self._abort_active:
                        for i, s in enumerate(self._slots):
                            if s is not None:
                                s.handle._fail(futures.CancelledError(),
                                               reason="cancelled")
                                self._slots[i] = None
                                self._release_pages_locked(i)
                        return
                    if (not self._pending
                            and not any(s is not None for s in self._slots)):
                        return                      # drained
                admits: list[tuple[int, _Pending, np.ndarray | None]] = []
                for _ in range(self.prefill_per_step):
                    free = [i for i, s in enumerate(self._slots)
                            if s is None]
                    if not free or not self._pending:
                        break
                    if not self._pages_ok_locked():
                        break      # head request waits for page frees
                    req = self._pending.pop(0)
                    if (req.deadline is not None
                            and time.monotonic() >= req.deadline):
                        # expired while queued: never burn a prefill on
                        # a request nobody is waiting for
                        self.requests_expired += 1
                        req.handle._fail(DeadlineExceeded(
                            "deadline expired before admission"),
                            reason="deadline")
                        continue
                    # reserve the slot (and, paged, its whole page
                    # budget — all-or-nothing, so a request can never
                    # run out of pages mid-stream) under the lock;
                    # prefill happens outside it
                    kv_row = None
                    if self._paged is not None:
                        need = self._paged.pages_for(
                            req.prompt.size + req.max_new_tokens)
                        pages = self._page_pool.alloc(need)
                        assert pages is not None  # _pages_ok_locked held
                        self._slot_pages[free[0]] = pages
                        kv_row = np.full((self._paged.max_pages,),
                                         self._cache_mod.SCRATCH_PAGE,
                                         np.int32)
                        kv_row[:need] = pages
                        self._kv_table[free[0]] = kv_row
                    self._slots[free[0]] = _Slot(
                        req.handle, req.eos_id, last_tok=-1,
                        pos=-1, n_gen=0, deadline=req.deadline)
                    admits.append((free[0], req, kv_row))
            for slot_idx, req, kv_row in admits:
                self._admit(slot_idx, req, kv_row)
            self._decode_active()

    # -- worker internals ---------------------------------------------------
    def _admit(self, slot_idx: int, req: _Pending,
               kv_row: np.ndarray | None = None) -> None:
        """Prefill one request and install it in its reserved slot.  A
        prefill failure releases the slot and fails only this handle,
        after any configured retries (re-running the prefill and the
        slot write overwrites what a failed attempt wrote).  ``kv_row``
        is the page-table row built while the slot was reserved under
        ``_cv`` — passed in so the prefill never reads ``self._kv_table``
        outside the lock."""

        def _attempt():
            self._fire("batcher.prefill")
            logits, cache = self._prefill_fn(self._params, req.prompt)
            self._write_fn(self._pool, cache, slot_idx, kv_row)
            return _host_rows(logits).reshape(-1)

        try:
            row = self._guarded(_attempt)
        except Exception as e:      # noqa: BLE001 — lands on the handle
            with self._cv:
                self._slots[slot_idx] = None
                self._release_pages_locked(slot_idx)
            req.handle._fail(e)
            return
        tok = int(np.argmax(row))
        with self._cv:
            slot = self._slots[slot_idx]
            slot.last_tok = tok
            slot.pos = int(req.prompt.size)
            slot.n_gen = 1
            self.prefills_run += 1
            self._last_admit_t = time.monotonic()
            n_active = sum(s is not None for s in self._slots)
            self.peak_active = max(self.peak_active, n_active)
        req.handle._emit(tok, row if self.record_logits else None)
        self._maybe_retire(slot_idx, tok)

    def _decode_active(self) -> None:
        with self._cv:
            # deadline sweep: a slot whose request expired mid-stream
            # retires NOW — it must not hold a slot for tokens nobody
            # will read
            expired = [(i, s) for i, s in enumerate(self._slots)
                       if s is not None and s.deadline is not None
                       and time.monotonic() >= s.deadline]
            for i, s in expired:
                self._slots[i] = None
                self._release_pages_locked(i)
                self.requests_finished += 1
                self.requests_expired += 1
            if expired:
                for _, s in expired:
                    s.handle._fail(DeadlineExceeded(
                        f"deadline expired after {s.n_gen} token(s)"),
                        reason="deadline")
                self._cv.notify_all()
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
            kv_table = (self._kv_table.copy() if self._paged is not None
                        else None)
        if not active:
            return
        toks = np.zeros((self.n_slots,), np.int32)
        poss = np.zeros((self.n_slots,), np.int32)
        for i, s in active:
            toks[i] = s.last_tok
            poss[i] = s.pos
        # a re-run recomputes the step over the KV rows the failed
        # attempt wrote (the same bits), from the SSM states it started
        # from (module docstring)
        state = (self._recurrent if self._retry_policy is not None
                 or self._supervisor is not None else [])
        saved = [t.clone() for t in state]

        def _attempt():
            for t, before in zip(state, saved):
                t.copy_(before)
            self._fire("batcher.decode")
            logits, _ = self._step_fn(self._params, self._pool, toks, poss)
            return _host_rows(logits)

        t0 = time.monotonic()
        try:
            if kv_table is not None:
                # push the authoritative host page table into the pool
                # (in place, outside the graph): retired slots now point
                # at scratch, fresh admits at their reserved pages
                self._cache_mod.set_tables(self._pool, kv_table)
            rows = self._guarded(_attempt)
        except Exception as e:      # noqa: BLE001 — exactly this batch
            with self._cv:
                for i, s in active:
                    self._slots[i] = None
                    self._release_pages_locked(i)
                    self.requests_finished += 1
                for _, s in active:
                    s.handle._fail(e)
            return
        sup = self._supervisor
        if sup is not None:
            sup.record_latency(time.monotonic() - t0)
        with self._cv:
            self.steps_run += 1
        for i, s in active:
            tok = int(np.argmax(rows[i]))
            s.pos += 1
            s.n_gen += 1
            s.last_tok = tok
            s.handle._emit(tok,
                           rows[i].copy() if self.record_logits else None)
            self._maybe_retire(i, tok)

    def _maybe_retire(self, slot_idx: int, tok: int) -> None:
        with self._cv:
            s = self._slots[slot_idx]
            if s is None:
                return
            reason = None
            if s.eos_id is not None and tok == s.eos_id:
                reason = "eos"
            elif s.n_gen >= s.handle.max_new_tokens:
                reason = "length"
            if reason is None:
                return
            self._slots[slot_idx] = None        # slot → FREE
            self._release_pages_locked(slot_idx)
            self.requests_finished += 1
            self._cv.notify_all()
        s.handle._finish(reason)

    # -- solo oracles -------------------------------------------------------
    def _solo_pool(self, prompt: np.ndarray, total_len: int):
        """A fresh pool (never the batcher's: decode writes in place)
        holding ``prompt``'s prefill in slot 0, and its logits row."""
        pool = self._new_pool()
        logits, cache = self._prefill_fn(self._params, prompt)
        kv_row = None
        if self._paged is not None:
            # deterministic solo allocation: the first pages after
            # scratch.  Physical page ids never enter the math (pages
            # are slot-private, scales per-page), so the pooled run is
            # bit-identical whatever ids its allocator picked
            need = self._paged.pages_for(total_len)
            kv_row = np.full((self._paged.max_pages,),
                             self._cache_mod.SCRATCH_PAGE, np.int32)
            kv_row[:need] = np.arange(1, need + 1)
        self._write_fn(pool, cache, 0, kv_row)
        return pool, _host_rows(logits).reshape(-1)

    def _solo_step(self, pool, tok: int, pos: int) -> np.ndarray:
        tvec = np.zeros((self.n_slots,), np.int32)
        pvec = np.zeros((self.n_slots,), np.int32)
        tvec[0], pvec[0] = tok, pos
        logits, _ = self._step_fn(self._params, pool, tvec, pvec)
        return _host_rows(logits)[0].copy()

    def generate_reference(self, prompt, *, max_new_tokens: int = 16,
                           eos_id: int | None = None,
                           record_logits: bool = False):
        """Solo decode of ``prompt``: a fresh ``n_slots`` pool with only
        slot 0 active, driven by the same prefill/decode functions the
        batcher uses.  This is the bit-identity oracle — any pooled run
        of the same request must emit exactly these tokens (and, with
        ``record_logits``, these logits bits).  Returns ``(tokens,
        logits_rows)``.  Not to be called while the worker computes."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        eos = self.eos_id if eos_id is None else eos_id
        pool, row = self._solo_pool(prompt, prompt.size + max_new_tokens)
        toks: list[int] = []
        rows: list[np.ndarray] = []
        tok, pos = int(np.argmax(row)), int(prompt.size)
        toks.append(tok)
        if record_logits:
            rows.append(row)
        while len(toks) < max_new_tokens and tok != eos:
            r = self._solo_step(pool, tok, pos)
            tok, pos = int(np.argmax(r)), pos + 1
            toks.append(tok)
            if record_logits:
                rows.append(r)
        return toks, rows

    def replay_logits(self, prompt, tokens) -> np.ndarray:
        """Teacher-forced replay: run ``prompt`` then feed the given
        ``tokens`` verbatim (no argmax feedback), returning the
        ``(len(tokens), vocab)`` float32 logits the pipeline produced
        at each step.

        This is the differential-check primitive for lossy KV modes:
        free-running int8 greedy decode legitimately diverges from the
        dense reference after a few near-tied steps, but the *per-step*
        logits under the same forced token stream must stay within the
        int8 quantization floor of the dense run.  Row 0 is the prefill
        logits row (dense compute, paged caches untouched), so it is
        bit-exact across KV modes by construction."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tokens = [int(t) for t in tokens]
        if not tokens:
            return np.zeros((0, self.cfg.vocab_size), np.float32)
        if prompt.size + len(tokens) > self.max_len:
            raise ValueError("prompt + replay tokens exceed max_len")
        pool, row = self._solo_pool(prompt, prompt.size + len(tokens))
        rows = [row]
        pos = int(prompt.size)
        for tok in tokens[:-1]:
            rows.append(self._solo_step(pool, tok, pos))
            pos += 1
        return np.stack(rows)
