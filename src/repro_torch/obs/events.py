"""Typed span events and the low-overhead :class:`TraceRecorder`.

A copy of ``repro/obs/events.py``.

The recorder is the single primitive every backend shares: one append-only
buffer of raw span rows stamped from one monotonic clock, materialised
into :class:`SpanEvent`\\ s off the hot path.  The design constraints (in
priority order):

1. **Zero cost when disabled.**  Every hot-path call site guards on
   ``recorder is None`` (or an ``enabled=False`` recorder short-circuits
   before touching the clock), so an untraced run performs no clock
   reads and no allocations on behalf of tracing.
2. **Identical span schemas across backends.**  The recording helpers in
   :mod:`repro_torch.exec.interp` are the only places that decide *what* a
   span for an ``ExecOp``/``SendOp``/``RecvOp`` looks like; a backend
   merely decides *when* to call them (the ``torch`` backend's spans
   match the reference backends' schema).  Differential tests
   compare :meth:`SpanEvent.identity` multisets across backends.
3. **Mergeable across processes.**  Multiprocess workers record against
   ``t_zero=0.0`` (absolute worker-monotonic timestamps), ship drained
   batches over the control pipe, and the coordinator :meth:`absorb`\\ s
   them with the clock offset measured on the ready/go handshake.

Beside the recorders a run is given, one process recorder takes the
program's own spans (kind ``span``: serving steps, MoE stages, the int8
sync, the trainer and its plan) and the ``exec`` spans of runs lowered
without ``trace``, but only while a ``torch.profiler`` records:
:func:`active` returns it then and ``None`` otherwise, and :func:`span` /
:func:`step_span` cost an attribute read and a test when it is off.  Each
profiler session starts it empty, so it holds one session's rows at most.
A span row's ``location`` is the recording thread's native id, the
``tid`` the profiler's trace gives that thread, and the recorder's
``anchor`` maps its raw stamps onto Unix time, the profiler's clock.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from contextvars import ContextVar
from typing import Any, Iterable, NamedTuple

from torch.autograd import profiler as _torch_profiler

__all__ = [
    "STEP_SPANS",
    "SpanEvent",
    "TraceRecorder",
    "active",
    "current_trace_id",
    "payload_nbytes",
    "span",
    "step_span",
    "take",
    "unix_ns",
]

#: Per-request trace id, set by the gateway for the duration of a request
#: so service-level log lines can correlate with the HTTP access log.
current_trace_id: ContextVar[str | None] = ContextVar(
    "repro_trace_id", default=None
)

#: Span kinds.  ``exec``/``send``/``recv`` mirror the three exec-IR op
#: types; ``phase`` covers compile-pipeline stages (trace/schedule/lower/
#: compile) recorded by :mod:`repro_torch.api`; ``span`` a region of the
#: program recorded into the process recorder (:func:`span`).
KINDS = ("exec", "send", "recv", "phase", "span")

#: The program's :func:`step_span` names.  A profiler that records the
#: device also draws each of them on the device's rows (a user annotation
#: over the kernels it launched), which a count of device ops leaves out.
STEP_SPANS = ("serve.prefill", "serve.decode", "train.iteration", "plan.compile")


def payload_nbytes(value: Any) -> int:
    """Best-effort payload size — mirrors ``SizeModel.from_payloads``.

    Sizing runs on the send/recv hot path, so it must never serialize
    the payload: arrays answer via ``nbytes`` (a ``torch.Tensor``'s is
    ``numel × element_size``, views included, read from its metadata: a
    CUDA tensor is never copied to the host or synchronised to be sized), buffer-protocol objects
    (bytes, bytearray, mmap, pickle-5 out-of-band buffers) via a
    zero-copy ``memoryview``, and only opaque Python objects fall back
    to ``sys.getsizeof`` — all O(1) in the payload size.
    """
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            pass
    try:
        with memoryview(value) as mv:
            return mv.nbytes
    except TypeError:
        pass
    return sys.getsizeof(value)


class SpanEvent(NamedTuple):
    """One recorded interval on one location's track.

    ``name`` is the step name for ``exec`` spans, the datum name for
    ``send`` spans, the port name for ``recv`` spans, and the phase label
    for ``phase`` spans.  ``start``/``end`` are seconds relative to the
    recorder's ``t_zero`` (its creation instant, except in multiprocess
    workers which record absolute monotonic time and are realigned at
    coordinator merge).

    A ``NamedTuple`` rather than a frozen dataclass: traced ``run_many``
    batches materialise thousands of these per second and the tuple
    constructor is ~4x cheaper than ``object.__setattr__``-per-field.
    """

    kind: str
    location: str
    name: str
    start: float
    end: float
    src: str | None = None
    dst: str | None = None
    port: str | None = None
    nbytes: int | None = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    def identity(self) -> tuple:
        """Timing-free identity, for cross-backend schema comparison."""
        return (self.kind, self.location, self.name, self.src, self.dst,
                self.port)


def _discard(row: tuple) -> None:
    """``add`` target for a disabled recorder — drops the row."""


class TraceRecorder:
    """One flat append-only span buffer over one monotonic clock.

    Internally the buffer holds plain tuples in :class:`SpanEvent` field
    order, not event instances: a tuple append costs ~0.2µs where the
    event constructor alone costs ~0.7µs, and on a short-step workload
    that difference is the gap between ~5% and ~20% tracing overhead.
    Rows are materialised into :class:`SpanEvent` (and merge-ordered by
    location) only on :meth:`drain` / :meth:`snapshot`, off the hot path.

    The append path is lock-free *and* frame-free: :attr:`add` is the
    buffer list's bound ``append`` — one C call, atomic under the GIL —
    and the hot recording helpers in :mod:`repro_torch.exec.interp` call it
    directly with a pre-built row.  :meth:`span` is the convenience
    wrapper for cold callers.  The extraction methods swap the buffer
    under a lock to exclude each other; a *recording* that races an
    extraction may land in the swapped-out generation and be dropped, so
    extraction is only complete once recording threads have quiesced —
    which every in-tree caller guarantees (the threaded backend drains
    after joining its location threads; a multiprocess worker records
    and flushes on the same thread).
    """

    __slots__ = ("enabled", "t_zero", "add", "anchor", "_lock", "_rows")

    def __init__(self, *, enabled: bool = True, t_zero: float | None = None):
        self.enabled = enabled
        self.t_zero = time.monotonic() if t_zero is None else t_zero
        #: ``(time.monotonic(), time.time_ns())`` read together, or None:
        #: what :func:`unix_ns` maps raw stamps through.
        self.anchor: tuple[float, int] | None = None
        self._lock = threading.Lock()
        # Rows of (kind, location, name, start, end, src, dst, port,
        # nbytes) — exactly SpanEvent field order.
        self._rows: list[tuple] = []
        #: Hot-path entry point: append one raw row (see ``_rows`` above).
        #: ``start``/``end`` are raw ``time.monotonic()`` stamps; ``nbytes``
        #: may be the payload object itself (sized at materialise time).
        self.add = self._rows.append if enabled else _discard

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        """Current instant on the recorder clock (relative to ``t_zero``)."""
        return time.monotonic() - self.t_zero

    def rel(self, t_abs: float) -> float:
        """Convert an absolute ``time.monotonic()`` stamp to recorder time."""
        return t_abs - self.t_zero

    # -- recording -----------------------------------------------------------
    def span(
        self,
        kind: str,
        location: str,
        name: str,
        start: float,
        end: float,
        src: str | None = None,
        dst: str | None = None,
        port: str | None = None,
        nbytes: Any = None,
    ) -> None:
        """Record one span.

        ``start``/``end`` are raw ``time.monotonic()`` stamps — call sites
        read the C clock directly and relativisation against ``t_zero``
        happens once, at :meth:`materialise` (a recorder with
        ``t_zero=0.0`` therefore treats stamps as already-relative).
        ``nbytes`` may be an ``int`` or the payload object itself, which
        is sized lazily at materialise time via :func:`payload_nbytes`.
        """
        if not self.enabled:
            return
        self.add((kind, location, name, start, end, src, dst, port, nbytes))

    def materialise(self, rows: list[tuple]) -> list[SpanEvent]:
        """Turn detached raw rows into merge-ordered :class:`SpanEvent`\\ s
        (sorted by location, recording order preserved within each),
        shifting stamps onto the recorder-relative clock and sizing any
        lazily-held payloads."""
        tz = self.t_zero
        out: list[SpanEvent] = []
        for row in sorted(rows, key=lambda r: r[1]):
            nb = row[8]
            if nb is not None and type(nb) is not int:
                nb = payload_nbytes(nb)
            out.append(
                SpanEvent(row[0], row[1], row[2], row[3] - tz, row[4] - tz,
                          row[5], row[6], row[7], nb)
            )
        return out

    # -- extraction ----------------------------------------------------------
    def detach(self) -> list[tuple]:
        """Remove and return the raw row buffer, unmaterialised.

        The cheap half of :meth:`drain` — callers that only need the spans
        later (e.g. a :class:`~repro_torch.obs.RunProfile` built on the serving
        hot path) keep the raw rows and pay :meth:`materialise` on first
        access instead of per run.
        """
        with self._lock:
            rows, self._rows = self._rows, []
            if self.enabled:
                self.add = self._rows.append
        return rows

    def drain(self) -> list[SpanEvent]:
        """Remove and return everything recorded so far (merge-ordered)."""
        return self.materialise(self.detach())

    def absorb(
        self, events: Iterable[SpanEvent], *, offset: float = 0.0
    ) -> None:
        """Merge spans recorded on another clock, shifted by ``offset``.

        ``offset`` is *their* clock's zero expressed on this recorder's
        clock: a worker span at worker-monotonic ``t`` lands here at
        ``t + offset - self.t_zero``... except workers use ``t_zero=0.0``
        so their ``start`` *is* worker-monotonic, and the coordinator
        passes ``offset = coord_monotonic_at_ready - worker_monotonic_at_
        ready - self.t_zero`` pre-combined.  Callers supply the final
        additive shift; this method just applies it.
        """
        # Rows store raw clock stamps that materialise() shifts by
        # -t_zero, so pre-add t_zero to land at exactly start + offset.
        shift = offset + self.t_zero
        with self._lock:
            self._rows.extend(
                (ev.kind, ev.location, ev.name, ev.start + shift,
                 ev.end + shift, ev.src, ev.dst, ev.port, ev.nbytes)
                for ev in events
            )

    def snapshot(self) -> tuple[SpanEvent, ...]:
        """Everything recorded so far, without clearing the buffer."""
        with self._lock:
            rows = list(self._rows)
        return tuple(self.materialise(rows))

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


# ---------------------------------------------------------------------------
# The process recorder: the program's own spans while a profiler records
# ---------------------------------------------------------------------------

#: Records raw ``time.monotonic()`` stamps (``t_zero`` 0).
_PROCESS = TraceRecorder(t_zero=0.0)


def _anchor() -> None:
    """Drop the process recorder's rows and read its anchor pair anew."""
    _PROCESS.detach()
    _PROCESS.anchor = (time.monotonic(), time.time_ns())


def _on_profiler_start(start=_torch_profiler._run_on_profiler_start) -> None:
    _anchor()
    start()


# torch calls this as every profiler session starts (and sets
# ``_is_profiler_enabled``): a session's rows are never left beside an
# earlier one's that nobody took.
_torch_profiler._run_on_profiler_start = _on_profiler_start


def active() -> TraceRecorder | None:
    """The process recorder while a ``torch.profiler`` records, else None."""
    if not _torch_profiler._is_profiler_enabled:
        return None
    if _PROCESS.anchor is None:  # taken from mid-session, or a session older than this module
        _anchor()
    return _PROCESS


def unix_ns(anchor: tuple[float, int], t_abs: float) -> int:
    """A raw ``time.monotonic()`` stamp as Unix time in ns, through an
    anchor pair."""
    mono, unix = anchor
    return unix + round((t_abs - mono) * 1e9)


def take() -> tuple[tuple[float, int] | None, list[tuple]]:
    """Detach the process recorder's raw rows with the anchor they were
    stamped against.  Call it once the recording threads are quiet (after
    the profiler stops), before the next session starts."""
    anchor, _PROCESS.anchor = _PROCESS.anchor, None
    return anchor, _PROCESS.detach()


#: What a span site returns while no profiler records.
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str, mark):
        self.name, self.mark = name, mark

    def __enter__(self) -> None:
        if self.mark is not None:
            self.mark.__enter__()
        self.t0 = time.monotonic()

    def __exit__(self, et, ev, tb) -> bool:
        t1 = time.monotonic()
        # The thread object's cached id: ``get_native_id()`` is a system call.
        _PROCESS.add(("span", str(threading.current_thread().native_id),
                      self.name, self.t0, t1, None, None, None, None))
        if self.mark is not None:
            self.mark.__exit__(et, ev, tb)
        return False


def _site(name: str, step: bool):
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    active()
    return _Span(name, _torch_profiler.record_function(name) if step else None)


def span(name: str):
    """``with span(name):`` records one ``span`` row on this thread into
    the process recorder while a profiler records; otherwise it reads no
    clock, appends nothing and allocates nothing."""
    return _site(name, False)


def step_span(name: str):
    """:func:`span` of a whole step, also entered as a
    ``torch.profiler.record_function`` range of the same name, so that the
    profiler's own trace shows it."""
    return _site(name, True)
