"""Chrome trace-event JSON export (Perfetto / ``chrome://tracing``).

A copy of ``repro/obs/export.py``.

One process (``pid=1``) with one thread track per location, named via
``"M"`` metadata events; every span becomes a ``"X"`` complete event with
microsecond ``ts``/``dur``.  Cross-location communication is drawn as
flow arrows: each matched send→recv pair on a ``(src, dst, port)``
channel gets an ``"s"`` (flow start, anchored on the send span) and an
``"f"`` (flow finish, ``bp="e"``, anchored on the recv span) sharing one
flow ``id``.  Compile-pipeline ``phase`` spans land on a separate
``pid=2`` track so run-time and compile-time are visually distinct.

The exporter guarantees monotone non-decreasing ``ts`` within each
``(pid, tid)`` track — the schema test relies on it.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping, Sequence

from repro_torch.obs.events import SpanEvent

__all__ = ["chrome_trace", "validate_chrome_trace", "write_chrome_trace"]

_US = 1e6  # trace-event timestamps are microseconds


def _tracks(spans: Iterable[SpanEvent]) -> dict[str, list[SpanEvent]]:
    by_loc: dict[str, list[SpanEvent]] = {}
    for ev in spans:
        by_loc.setdefault(ev.location, []).append(ev)
    for loc in by_loc:
        by_loc[loc].sort(key=lambda e: (e.start, e.end))
    return by_loc


def chrome_trace(
    spans: Sequence[SpanEvent],
    *,
    phases: Sequence[tuple[str, float]] = (),
) -> dict:
    """Build a trace-event JSON object from recorded spans.

    ``phases`` are ``(label, seconds)`` compile-pipeline timings laid out
    back-to-back on their own track (they have durations but no recorded
    wall-clock placement).
    """
    by_loc = _tracks(s for s in spans if s.kind != "phase")
    events: list[dict] = []
    tids = {loc: i + 1 for i, loc in enumerate(sorted(by_loc))}

    for loc, tid in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": loc},
        })

    # Complete ("X") events, per track in start order → monotone ts.
    for loc, tid in tids.items():
        for ev in by_loc[loc]:
            args: dict = {"kind": ev.kind}
            if ev.src is not None:
                args["src"] = ev.src
            if ev.dst is not None:
                args["dst"] = ev.dst
            if ev.port is not None:
                args["port"] = ev.port
            if ev.nbytes is not None:
                args["nbytes"] = ev.nbytes
            events.append({
                "name": f"{ev.kind}:{ev.name}",
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": round(ev.start * _US, 3),
                "dur": max(round(ev.duration * _US, 3), 0.001),
                "cat": ev.kind,
                "args": args,
            })

    # Flow arrows: pair sends and recvs per (src, dst, port) channel in
    # start order — the exec IR delivers each channel FIFO, so the k-th
    # send on a channel corresponds to the k-th recv.
    sends: dict[tuple, list[SpanEvent]] = {}
    recvs: dict[tuple, list[SpanEvent]] = {}
    for ev in spans:
        if ev.kind == "send" and ev.src != ev.dst:
            sends.setdefault((ev.src, ev.dst, ev.port), []).append(ev)
        elif ev.kind == "recv" and ev.src != ev.dst:
            recvs.setdefault((ev.src, ev.dst, ev.port), []).append(ev)
    flow_id = 0
    for key in sorted(sends, key=str):
        ss = sorted(sends[key], key=lambda e: e.start)
        rr = sorted(recvs.get(key, []), key=lambda e: e.start)
        for s_ev, r_ev in zip(ss, rr):
            flow_id += 1
            events.append({
                "name": f"comm:{s_ev.name}", "ph": "s", "cat": "comm",
                "id": flow_id, "pid": 1, "tid": tids[s_ev.location],
                "ts": round(s_ev.start * _US, 3),
            })
            events.append({
                "name": f"comm:{s_ev.name}", "ph": "f", "cat": "comm",
                "bp": "e", "id": flow_id, "pid": 1,
                "tid": tids[r_ev.location],
                "ts": round(max(r_ev.start, s_ev.start) * _US, 3),
            })

    if phases:
        events.append({
            "name": "thread_name", "ph": "M", "pid": 2, "tid": 1,
            "args": {"name": "compile pipeline"},
        })
        cursor = 0.0
        for label, seconds in phases:
            events.append({
                "name": label, "ph": "X", "pid": 2, "tid": 1,
                "ts": round(cursor * _US, 3),
                "dur": max(round(seconds * _US, 3), 0.001),
                "cat": "phase", "args": {"kind": "phase"},
            })
            cursor += seconds

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str,
    spans: Sequence[SpanEvent],
    *,
    phases: Sequence[tuple[str, float]] = (),
) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(spans, phases=phases), fh)


def validate_chrome_trace(obj: Mapping) -> None:
    """Raise ``ValueError`` unless ``obj`` is schema-valid trace JSON.

    Checks the invariants the exporter promises: required keys per event,
    ``dur`` on complete events, and monotone ``ts`` per ``(pid, tid)``
    track.  Used by tests and available to callers sanity-checking files
    before loading them into Perfetto.
    """
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    last_ts: dict[tuple, float] = {}
    for ev in events:
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event missing {key!r}: {ev}")
        if ev["ph"] == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError(f"complete event missing ts/dur: {ev}")
            track = (ev["pid"], ev["tid"])
            if ev["ts"] < last_ts.get(track, float("-inf")):
                raise ValueError(
                    f"non-monotone ts on track {track}: {ev}"
                )
            last_ts[track] = ev["ts"]
        elif ev["ph"] in ("s", "f") and "id" not in ev:
            raise ValueError(f"flow event missing id: {ev}")
