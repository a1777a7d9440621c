"""The traced stretch: ``torch.profiler`` over a callable, read back from its
Chrome trace into a plain record that the metric readers take.

A record holds

* ``device``: ``(name, start_us, dur_us, correlation)`` of every kernel,
  copy and memset the card ran inside the stretch;
* ``stretch``: ``(start_us, end_us)``, the ``bench.stretch`` range that
  wraps the callable and a final synchronise;
* ``ranges``: ``(name, thread, start_us, end_us)`` of every other host range
  whose name starts with ``bench.``;
* ``launches``: ``{correlation: (thread, ts_us)}`` of the host's runtime
  calls that started device work;
* ``busy_s``: the union of the device intervals; ``window_s``: the stretch;
* ``breakdown``: the device operations that took most time, and the idle
  gaps summed by the host operation that launched the work after each gap.

Timestamps are the profiler's (the host's clock, the device's events
aligned to it by the profiler).
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def profiled(fn, trace_path: Path) -> dict:
    """Run ``fn`` under the profiler and return its record (on a machine
    without a card, a record with no device operations)."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    # Host ops on every thread: the trainer's steps run on a thread pool.
    with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with record_function("bench.stretch"):
            fn()
            sync()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    del prof
    try:
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(trace_path)
    return record_from_events(events)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(host: dict, queries: list[tuple[int, float, int]]) -> dict[int, str]:
    """For each ``(thread, ts, key)``, the name of the shortest host op on
    ``thread`` that contains ``ts`` (ops on a thread nest)."""
    out: dict[int, str] = {}
    by_thread = defaultdict(list)
    for tid, ts, key in queries:
        by_thread[tid].append((ts, key))
    for tid, qs in by_thread.items():
        ops = sorted(host.get(tid, []), key=lambda o: (o[0], -o[1]))
        qs.sort()
        stack: list[tuple[float, float, str]] = []
        i = 0
        for ts, key in qs:
            while i < len(ops) and ops[i][0] <= ts:
                s, e, name = ops[i]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, e, name))
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[key] = stack[-1][2] if stack else "host"
    return out


def record_from_events(events: list[dict]) -> dict:
    """The record of a Chrome trace's events (see the module's docstring)."""
    xs = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in xs if e.get("name") == "bench.stretch" and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no bench.stretch range")
    s0 = float(stretch[0]["ts"])
    s1 = s0 + float(stretch[0]["dur"])
    device, ranges, launches = [], [], {}
    host = defaultdict(list)
    for e in xs:
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            if s0 <= ts < s1:
                device.append((e["name"], ts, min(dur, s1 - ts), corr))
        elif cat in LAUNCH_CATS:
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat == "user_annotation":
            if e["name"].startswith("bench.") and e["name"] != "bench.stretch":
                ranges.append((e["name"], e.get("tid"), ts, ts + dur))
        elif cat == "cpu_op":
            host[e.get("tid")].append((ts, ts + dur, e["name"]))
    device.sort(key=lambda d: d[1])
    busy = _union([(d[1], d[1] + d[2]) for d in device])
    busy_us = sum(e - s for s, e in busy)

    totals: dict[str, float] = defaultdict(float)
    for name, _, dur, _ in device:
        totals[name] += dur * 1e-6
    # Idle gaps, each named by the host op that launched the work after it.
    gaps, ends = [], [s0] + [e for _, e in busy]
    starts = [s for s, _ in busy] + [s1]
    first_after = {}
    dev_starts = [d[1] for d in device]
    for i, (gs, ge) in enumerate(zip(ends, starts)):
        if ge > gs:
            gaps.append((gs, ge, i))
            j = bisect.bisect_left(dev_starts, ge) if i < len(busy) else len(device)
            first_after[i] = device[j][3] if j < len(device) else None
    queries = [(launches[c][0], launches[c][1], i) for i, c in first_after.items() if c in launches]
    names = _innermost(host, queries)
    idle: dict[str, float] = defaultdict(float)
    for gs, ge, i in gaps:
        idle[names.get(i, "host")] += (ge - gs) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "device": device,
        "stretch": (s0, s1),
        "ranges": ranges,
        "launches": launches,
        "busy_s": busy_us * 1e-6,
        "window_s": (s1 - s0) * 1e-6,
        "breakdown": {"device_ops": top(totals), "idle_gaps": top(idle)},
    }
