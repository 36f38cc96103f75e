"""Named spans of the program's layers, forward and backward, and counters.

Every profiler range the port opens goes through :func:`span`: it opens
``torch.profiler.record_function(name)``, so a trace groups the kernels
launched inside it by that name, on the profiler's clock. While spans are
*recording* a span also keeps a :class:`Record` in memory: its name, id,
its parent's id, host start and end (``time.perf_counter_ns``) and, once
CUDA is initialised, a pair of ``torch.cuda.Event``\\ s recorded on the
current stream at entry and exit. The events give the span's device
interval: from when the device reached the span's first work to when it
finished its last (idle time inside the span included).

Recording is on while a ``torch.profiler`` profile is active
(``torch.autograd._profiler_enabled()``), inside :func:`recording`, and
inside any recorded span (so a backward or a recomputation that runs on
autograd's thread records under the step that caused it). With it off a
span costs that check and the ``record_function`` alone: no autograd node,
no CUDA event, no device work.

:func:`backward_span` times a layer's backward pass, which autograd runs
after the forward's spans have closed: two identity autograd nodes, one
on the layer's outputs, whose backward opens ``name + ".bwd"``, and one on
its inputs, whose backward closes it once the last input's gradient is
ready. They save no tensors, so a non-reentrant checkpoint recomputes the
same saved tensors with them or without them, and they pass gradients on
unchanged. A span whose close never fires is closed when its parent
closes, and counted in :func:`unclosed`.

:func:`count` adds to a named counter while recording, on the device where
the value is a tensor (no host sync); :func:`counters` reads them, after
the traced window. :func:`recompute` marks a checkpoint's recomputation: a
``recompute`` span, inside which nothing is counted (the forward already
was).

The store holds the latest recorded stretch: a change from not recording
to recording, seen at a span opened outside any other, clears it (two
profiles with no span opened between them are one stretch), as does
entering :func:`recording`.
:func:`records` and :func:`counters` are what a reader reads. One thread
records at a time (a backward runs while the step that called it waits);
spans of two threads recording at once would take each other's parents.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.profiler import record_function


@dataclass(eq=False)
class Record:
    """One recorded span. ``events``: its CUDA start and end events (None
    where CUDA was not initialised)."""

    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int | None = None
    events: tuple | None = None

    @property
    def host_s(self) -> float | None:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self) -> float | None:
        """Seconds from the device reaching the span's start to its end
        (waits for the end event)."""
        if self.events is None or self.end_ns is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) / 1e3


@dataclass
class _Store:
    records: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    stack: list = field(default_factory=list)  # open records, innermost last
    unclosed: int = 0
    forced: int = 0  # depth of recording() contexts
    was_on: bool = False
    recomputing: int = 0
    next_id: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)

    def clear(self) -> None:
        self.records, self.counters, self.stack = [], {}, []
        self.unclosed = self.next_id = 0


_STORE = _Store()


def on() -> bool:
    """Whether spans record now (see the module docstring)."""
    s = _STORE
    if s.stack:
        return True
    now = s.forced > 0 or torch.autograd._profiler_enabled()
    if now and not s.was_on:
        s.clear()
    s.was_on = now
    return now


def _open(name: str) -> Record:
    s = _STORE
    events = None
    if torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    with s.lock:
        rec = Record(name, s.next_id, s.stack[-1].id if s.stack else None,
                     time.perf_counter_ns(), events=events)
        s.next_id += 1
        s.records.append(rec)
        s.stack.append(rec)
    return rec


def _end(rec: Record) -> None:
    if rec.events is not None:
        rec.events[1].record()
    rec.end_ns = time.perf_counter_ns()


def _close(rec: Record) -> None:
    """Ends ``rec`` and any span still open inside it (each counted as
    unclosed); nothing where a parent closed it already."""
    s = _STORE
    with s.lock:
        if rec not in s.stack:
            return
        at = s.stack.index(rec)
        inner, s.stack = s.stack[at + 1:], s.stack[:at]
        s.unclosed += len(inner)
    for r in reversed(inner):
        _end(r)
    _end(rec)


class span(contextlib.ContextDecorator):
    """``with span(name):`` or ``@span(name)``: a ``record_function``
    range, and a :class:`Record` while recording."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):  # a fresh one each call, as a decorator
        return span(self.name)

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._rec = _open(self.name) if on() else None
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            _close(self._rec)
        self._range.__exit__(*exc)
        return False


class _Cell:
    """What a layer's two markers share: the ``.bwd`` span's name, and its
    range and record once the backward has opened it."""

    def __init__(self, name: str):
        self.name, self.range, self.rec = name, None, None

    def open(self) -> None:
        self.range = record_function(self.name)
        self.range.__enter__()
        self.rec = _open(self.name)

    def close(self) -> None:
        if self.rec is None:
            return
        _close(self.rec)
        self.range.__exit__(None, None, None)
        self.range = self.rec = None


class _Marker(torch.autograd.Function):
    """Identity on tensors; its backward, which runs once every one of
    their gradients is ready, calls ``then`` (a cell's ``open`` on a
    layer's outputs, its ``close`` on its inputs)."""

    @staticmethod
    def forward(ctx, then, *ts):
        ctx.then = then
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.then()
        return (None, *grads)


def _marked(then, items: list) -> list:
    """``items`` with the tensors that require a gradient passed through
    one :class:`_Marker` calling ``then``."""
    at = [i for i, t in enumerate(items) if isinstance(t, torch.Tensor) and t.requires_grad]
    if at:
        for i, t in zip(at, _Marker.apply(then, *(items[i] for i in at))):
            items[i] = t
    return items


def backward_span(name: str, inputs: tuple, fn: Callable[..., Any]):
    """``fn(*inputs)``, its backward pass timed as the span ``name +
    ".bwd"`` while recording (see the module docstring). ``fn`` returns a
    tensor or a tuple of them."""
    if (_STORE.recomputing or not torch.is_grad_enabled()
            or not any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)
            or not on()):  # a recomputation's graph is only unpacked, never run
        return fn(*inputs)
    cell = _Cell(name + ".bwd")
    out = fn(*_marked(cell.close, list(inputs)))
    if isinstance(out, torch.Tensor):
        return _marked(cell.open, [out])[0]
    return type(out)(_marked(cell.open, list(out)))


def count(name: str, value) -> None:
    """Add ``value`` (a number, a tensor, or a callable giving one, called
    only while recording) to the counter ``name``; nothing inside a
    recomputation."""
    s = _STORE
    if s.recomputing or not on():
        return
    v = value() if callable(value) else value
    with s.lock:
        s.counters[name] = s.counters.get(name, 0) + v


@contextlib.contextmanager
def recompute(inner=None):
    """A checkpoint's recomputation context (``context_fn``'s second):
    the span ``recompute``, no counting, and ``inner`` entered inside."""
    s = _STORE
    s.recomputing += 1
    try:
        with span("recompute"), (inner if inner is not None else contextlib.nullcontext()):
            yield
    finally:
        s.recomputing -= 1


@contextlib.contextmanager
def recording():
    """Spans record inside, profiler or not (tests, the cost of tracing).
    The outermost one starts a new stretch unless spans record already; a
    span still open when it ends is closed, as unclosed."""
    s = _STORE
    if not s.forced and not s.stack and not torch.autograd._profiler_enabled():
        s.was_on = False
    s.forced += 1
    on()
    try:
        yield
    finally:
        s.forced -= 1
        if not s.forced and s.stack:
            _close(s.stack[0])
            s.unclosed += 1


def records() -> list[Record]:
    """The latest recorded stretch's spans, in the order they opened."""
    return list(_STORE.records)


def counters() -> dict[str, float]:
    """The latest recorded stretch's counters, read to the host."""
    return {k: float(v) for k, v in _STORE.counters.items()}


def unclosed() -> int:
    """Spans of the latest stretch closed by their parent, not by their own
    close."""
    return _STORE.unclosed
