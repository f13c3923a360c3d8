"""Spans: the program's own named host-time intervals, kept only while a
``torch.profiler`` session records.

``span(name, **attrs)`` is a context manager.  With no profiler running
it returns one shared null context and records nothing; under a profiler
it appends a :class:`Span` to an in-memory buffer when the block exits.
Stamps come from ``time.time_ns()``, the clock the profiler's host
events are given in, so a span can be laid over a trace by host time.
Spans make no profiler event of their own.

The CNN request path carries seven: ``codr.run`` (``CompiledModel.run``),
``codr.layer`` (each layer, attrs ``name``, ``index``, ``kind``),
``codr.module`` (each branch module, attr ``name``), ``codr.branch``
(each of a module's branches, attrs ``module``, ``index`` and ``kind``:
``1x1``, ``3x3``, ``5x5`` or ``pool``), ``codr.pool`` (each max
pooling, attrs ``window``, ``stride``), ``codr.features`` (the int8
feature path: the ``int8_features`` wrapper on ``smm_kernel``,
``backends._int_activations`` on ``smm``) and ``codr.host_read`` (each
of ``_int_activations``' two reads of a scalar to the host: only the
``smm`` lane reads).  Read them after profiling::

    with torch.profiler.profile(...):
        model.run(x)
    records = spans.spans()
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["Span", "span", "spans", "clear", "MAX_SPANS"]

MAX_SPANS = 1_000_000

_enabled = torch.autograd._profiler_enabled
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """One closed span.  ``parent`` is the enclosing span's id and
    ``request`` the id of the enclosing ``codr.run`` (its own id for a
    ``codr.run``); 0 where there is none."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    thread: int
    attrs: dict


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else 0
        self.request = (self.id if self.name == "codr.run"
                        else outer.request if outer else 0)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        _buffer.append(Span(self.name, self.start, end, self.id, self.parent,
                            self.request, threading.get_ident(), self.attrs))
        return False


def span(name: str, /, **attrs):
    """A span named ``name`` around a block, recorded only while a
    profiler session records."""
    if not _enabled():
        return _NULL
    return _Open(name, attrs)


def spans() -> list[Span]:
    """A copy of the recorded spans, oldest first (at most
    :data:`MAX_SPANS`; the oldest go first)."""
    return list(_buffer)


def clear() -> None:
    """Forget every recorded span."""
    _buffer.clear()
