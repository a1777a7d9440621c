"""``repro_torch.obs`` — execution tracing, run profiles, and service metrics.

A copy of ``repro/obs`` (the port imports nothing of :mod:`repro`).

The observability layer promised by the paper's premise that a workflow's
distributed execution trace is a first-class object:

* :class:`TraceRecorder` / :class:`SpanEvent` — low-overhead span capture
  recorded by the ``torch`` backend (``lower(..., trace=True)``), in
  the reference backends' span schema;
* :func:`active` / :func:`span` / :func:`step_span` / :func:`take` /
  :func:`unix_ns` — the process recorder, which takes the program's own
  spans while a ``torch.profiler`` records, and its clock's map onto the
  profiler's;
* :class:`RunProfile` — the structured artifact on every traced result
  (``result.profile``), exportable as Perfetto-loadable Chrome trace JSON;
* :func:`align` / :class:`ProfileReport` — predicted-vs-actual drift
  against the sched simulator (``Plan.profile(result)``);
* :class:`MetricsRegistry` — the Prometheus text registry (the
  reference's serving gateway exposes it as ``GET /v1/metrics``).
"""

from repro_torch.obs.events import (
    SpanEvent,
    TraceRecorder,
    active,
    current_trace_id,
    payload_nbytes,
    span,
    step_span,
    take,
    unix_ns,
)
from repro_torch.obs.export import (
    chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.profile import ProfileReport, RunProfile, StepDrift, align

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ProfileReport",
    "RunProfile",
    "SpanEvent",
    "StepDrift",
    "TraceRecorder",
    "active",
    "align",
    "chrome_trace",
    "current_trace_id",
    "payload_nbytes",
    "span",
    "step_span",
    "take",
    "unix_ns",
    "validate_chrome_trace",
    "write_chrome_trace",
]
