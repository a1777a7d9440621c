"""The program's own spans on a traced record's clock, for the readers of the
metrics that read them.

While ``torch.profiler`` records, the port writes its spans into one process
recorder (``repro_torch.obs``): the steps (``serve.decode``,
``train.iteration``, ...), the MoE's and the int8 sync's stages
(``model.moe.route``, ``optim.compress``, ...) and the plan's ``exec``
spans.  :func:`program` takes those rows once per record
(``repro_torch.obs.take``) and maps each raw stamp through the recorder's
anchor onto Unix time, then onto the trace's clock: Unix microseconds less
Kineto's base, the Unix time floored to a multiple of 7,889,238 s.

It gives nothing (and each reader ``None``) where the program records no
such spans, where the stretch ran no device operation, and where fewer than
95 % of the stretch's device operations were launched inside a step: on the
launching thread inside a ``serve.decode`` span, or inside a
``train.iteration`` span by any thread that recorded spans (autograd's own
thread launches the backward).  A misaligned clock then reads nothing rather
than a wrong number, and so do launches that the trace gives a thread id
the spans never saw: Kineto keys its map of threads by ``pthread_t``, which
a new thread takes over from one that ended, so in a process's later
profiler sessions a new thread's launches can carry an ended thread's id
(the plan's thread pool is made anew each run).
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from bench.harness.profile import _union

TRIMONTH_S = 7_889_238
ALIGNED = 0.95


class Span(NamedTuple):
    kind: str  # "span" or "exec"
    name: str
    thread: int | str  # the native thread id of a "span"; a location otherwise
    start: float  # us, on the trace's clock
    end: float


def base_ns(unix_ns: int) -> int:
    """Kineto's ``baseTimeNanoseconds`` for a trace taken at ``unix_ns``."""
    return unix_ns // 1_000_000_000 // TRIMONTH_S * TRIMONTH_S * 1_000_000_000


def mapped(anchor: tuple[float, int], rows: list[tuple]) -> list[Span]:
    """Raw recorder rows as spans on the trace's clock."""
    from repro_torch.obs import unix_ns

    base = base_ns(anchor[1])

    def us(t: float) -> float:
        return (unix_ns(anchor, t) - base) * 1e-3

    return [Span(r[0], r[2], int(r[1]) if r[0] == "span" else r[1], us(r[3]), us(r[4])) for r in rows]


_last: tuple[dict, list[Span] | None] | None = None


def taken(record: dict) -> list[Span] | None:
    """The program's spans that lie inside the record's stretch, taken from
    the process recorder at the first call for this record."""
    global _last
    if _last is not None and _last[0] is record:
        return _last[1]
    try:
        from repro_torch.obs import take
    except ImportError:  # a program without a process recorder
        take = None
    out = None
    if take is not None:
        anchor, rows = take()
        if anchor is not None and rows:
            s0, s1 = record["stretch"]
            out = [s for s in mapped(anchor, rows) if s0 <= s.start and s.end <= s1]
    _last = (record, out)
    return out


def step_share(record: dict, spans: list[Span]) -> float:
    """Share of the stretch's device operations launched inside a step, by
    a thread that recorded spans."""
    threads = {s.thread for s in spans if s.kind == "span"}
    decode = by_thread(s for s in spans if s.name == "serve.decode")
    iters = _union([(s.start, s.end) for s in spans if s.name == "train.iteration"])
    inside = 0
    for d in record["device"]:
        got = record["launches"].get(d[3])
        if got is not None and got[0] in threads and (within(decode.get(got[0], []), got[1])
                                                      or within(iters, got[1])):
            inside += 1
    return inside / len(record["device"])


def program(record: dict) -> list[Span] | None:
    """The stretch's program spans, or None (see the module's docstring)."""
    spans = taken(record)
    if not spans or not record["device"] or step_share(record, spans) < ALIGNED:
        return None
    return spans


# -- interval arithmetic ----------------------------------------------------------


def by_thread(spans) -> dict:
    """The union of the spans' intervals, per thread."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.thread, []).append((s.start, s.end))
    return {t: _union(iv) for t, iv in out.items()}


def within(union: list[tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of ``union``'s sorted, disjoint intervals."""
    i = bisect.bisect_right(union, (t, float("inf"))) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def length(union: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in union)


def device_share(record: dict, spans: list[Span], names) -> float | None:
    """Percent of the stretch's device time in operations launched, on the
    span's own thread, inside a span named in ``names``."""
    total = sum(d[2] for d in record["device"])
    if total <= 0:
        return None
    inside_of = by_thread(s for s in spans if s.name in names)
    inside = 0.0
    for _, _, dur, corr in record["device"]:
        got = record["launches"].get(corr)
        if got is not None and within(inside_of.get(got[0], []), got[1]):
            inside += dur
    return 100.0 * inside / total
