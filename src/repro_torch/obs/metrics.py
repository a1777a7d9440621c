"""A minimal Prometheus-text-format metrics registry (stdlib only).

A copy of ``repro/obs/metrics.py``.

Just enough of the exposition format (version 0.0.4) for the gateway's
``GET /v1/metrics``: counters, gauges, and cumulative histograms with
label sets, rendered as ``# HELP`` / ``# TYPE`` blocks.  Counters and
gauges support both incremental updates (request counting in the hot
path) and absolute ``set`` (snapshot-sourced values copied out of
``WorkflowService.stats()`` at scrape time).
"""

from __future__ import annotations

import threading
from typing import Mapping, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

#: Default latency buckets (seconds) — tuned for an in-process HTTP
#: gateway where cache-hit runs are sub-millisecond and compiles can
#: take whole seconds.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()

    def render(self) -> list[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels: str) -> None:
        """Absolute update — for snapshot-sourced cumulative totals."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            lines.append(f"{self.name} 0")
        for key, value in items:
            lines.append(
                f"{self.name}{_labels_str(dict(key))} {_fmt_value(value)}"
            )
        return lines


class Gauge(Counter):
    kind = "gauge"

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            keys = sorted(self._counts)
            snap = {
                k: (list(self._counts[k]), self._sums[k], self._totals[k])
                for k in keys
            }
        for key in keys:
            counts, total_sum, total = snap[key]
            base = dict(key)
            for bound, count in zip(self.buckets, counts):
                lines.append(
                    f"{self.name}_bucket"
                    f"{_labels_str({**base, 'le': _fmt_value(bound)})} "
                    f"{count}"
                )
            lines.append(
                f"{self.name}_bucket{_labels_str({**base, 'le': '+Inf'})} "
                f"{total}"
            )
            lines.append(
                f"{self.name}_sum{_labels_str(base)} {_fmt_value(total_sum)}"
            )
            lines.append(f"{self.name}_count{_labels_str(base)} {total}")
        return lines


class MetricsRegistry:
    """Ordered collection of metrics, rendered as one exposition page."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_make(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help_text)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(name, help_text, buckets)
            elif not isinstance(m, Histogram):
                raise TypeError(f"{name} already registered as {m.kind}")
            return m

    def _get_or_make(self, cls, name: str, help_text: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_text)
            elif type(m) is not cls:
                raise TypeError(f"{name} already registered as {m.kind}")
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
