"""Structured run profiles and predicted-vs-actual alignment.

A copy of ``repro/obs/profile.py``.

:class:`RunProfile` is the structured artifact attached to every traced
``run``/``run_many`` result: the recorded spans, the compile-pipeline
phase timings, and exporters (Chrome trace JSON, per-step duration
digests).  :func:`align` closes the loop the sched simulator opened —
replay the plan's predicted per-location timeline, match each predicted
exec against the recorded spans by step name, and report per-step drift
plus achieved-vs-predicted cross-location bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

from repro_torch.obs.events import SpanEvent
from repro_torch.obs.export import chrome_trace, write_chrome_trace

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.api import Plan

__all__ = ["ProfileReport", "RunProfile", "StepDrift", "align"]


class RunProfile:
    """Everything one traced execution recorded.

    Constructed either eagerly (``spans=...``) or from a drained recorder
    (:meth:`from_recorder`), which keeps the recorder's raw rows and
    materialises :class:`SpanEvent`\\ s only on first :attr:`spans` access
    — a traced ``run_many`` batch builds one of these per instance on the
    serving hot path, so construction must cost next to nothing.
    """

    __slots__ = ("backend", "phases", "_spans", "_buffers", "_recorder",
                 "_wall")

    def __init__(
        self,
        backend: str,
        spans: tuple[SpanEvent, ...] = (),
        wall_s: float | None = None,
        phases: tuple[tuple[str, float], ...] = (),
    ):
        self.backend = backend
        #: Compile-pipeline ``(label, seconds)`` timings copied off the plan.
        self.phases = tuple(phases)
        self._spans: tuple[SpanEvent, ...] | None = tuple(spans)
        self._buffers: list[tuple] | None = None
        self._recorder = None
        self._wall = wall_s

    @classmethod
    def from_recorder(
        cls, backend: str, recorder, *, wall_s: float | None = None
    ) -> "RunProfile":
        """Detach ``recorder``'s buffers without materialising spans."""
        prof = cls(backend, wall_s=wall_s)
        prof._spans = None
        prof._buffers = recorder.detach()
        prof._recorder = recorder
        return prof

    @property
    def spans(self) -> tuple[SpanEvent, ...]:
        if self._spans is None:
            buffers, self._buffers = self._buffers, None
            rec, self._recorder = self._recorder, None
            self._spans = tuple(rec.materialise(buffers or []))
        return self._spans

    @property
    def wall_s(self) -> float:
        if self._wall is None:
            spans = self.spans
            self._wall = max((s.end for s in spans), default=0.0) - min(
                (s.start for s in spans), default=0.0
            )
        return self._wall

    def with_phases(
        self, phases: tuple[tuple[str, float], ...]
    ) -> "RunProfile":
        """Return ``self`` with the phase timings replaced (in place —
        the profile rides exactly one result and is stamped once)."""
        self.phases = tuple(phases)
        return self

    # -- digests -------------------------------------------------------------
    def by_location(self) -> dict[str, tuple[SpanEvent, ...]]:
        out: dict[str, list[SpanEvent]] = {}
        for ev in self.spans:
            out.setdefault(ev.location, []).append(ev)
        return {
            loc: tuple(sorted(evs, key=lambda e: (e.start, e.end)))
            for loc, evs in out.items()
        }

    def exec_durations(self) -> dict[str, list[float]]:
        """Measured seconds per step (one sample per exec span)."""
        out: dict[str, list[float]] = {}
        for ev in self.spans:
            if ev.kind == "exec":
                out.setdefault(ev.name, []).append(ev.duration)
        return out

    def cross_bytes(self) -> int:
        """Achieved cross-location bytes (sends whose src != dst)."""
        return sum(
            ev.nbytes or 0
            for ev in self.spans
            if ev.kind == "send" and ev.src != ev.dst
        )

    def span_schema(self) -> tuple[tuple, ...]:
        """Sorted timing-free identity multiset — the differential unit."""
        return tuple(sorted(ev.identity() for ev in self.spans))

    # -- exporters -----------------------------------------------------------
    def chrome_trace(self) -> dict:
        return chrome_trace(self.spans, phases=self.phases)

    def save_chrome_trace(self, path: str) -> None:
        write_chrome_trace(path, self.spans, phases=self.phases)

    def summary(self) -> str:
        locs = sorted({ev.location for ev in self.spans})
        n_exec = sum(1 for ev in self.spans if ev.kind == "exec")
        n_comm = sum(1 for ev in self.spans if ev.kind in ("send", "recv"))
        lines = [
            f"profile[{self.backend}]: {len(self.spans)} spans "
            f"({n_exec} exec, {n_comm} comm) over {len(locs)} location(s)",
        ]
        if self.wall_s:
            lines.append(f"wall: {self.wall_s * 1e3:.2f} ms")
        for label, seconds in self.phases:
            lines.append(f"  {label:<24s} {seconds * 1e3:9.3f} ms")
        return "\n".join(lines)


@dataclass(frozen=True)
class StepDrift:
    """Predicted vs measured timing for one step."""

    step: str
    predicted_start: float
    actual_start: float
    predicted_s: float
    actual_s: float

    @property
    def start_drift(self) -> float:
        return self.actual_start - self.predicted_start

    @property
    def duration_ratio(self) -> float:
        if self.predicted_s <= 0.0:
            return float("inf") if self.actual_s > 0 else 1.0
        return self.actual_s / self.predicted_s


@dataclass(frozen=True)
class ProfileReport:
    """The aligned prediction: per-step drift + aggregate comparisons."""

    backend: str
    predicted_makespan: float
    actual_makespan: float
    drifts: tuple[StepDrift, ...]
    predicted_cross_bytes: int
    actual_cross_bytes: int
    unmatched_predicted: tuple[str, ...] = ()
    unmatched_actual: tuple[str, ...] = ()

    def summary(self) -> str:
        lines = [
            f"predicted vs actual [{self.backend}]",
            f"  makespan: {self.predicted_makespan * 1e3:9.2f} ms predicted"
            f" | {self.actual_makespan * 1e3:9.2f} ms actual",
            f"  cross-location bytes: {self.predicted_cross_bytes} predicted"
            f" | {self.actual_cross_bytes} actual",
            f"  {'step':<16s} {'pred start':>10s} {'act start':>10s} "
            f"{'pred ms':>9s} {'act ms':>9s} {'ratio':>7s}",
        ]
        for d in self.drifts:
            ratio = d.duration_ratio
            lines.append(
                f"  {d.step:<16s} {d.predicted_start * 1e3:9.2f}m "
                f"{d.actual_start * 1e3:9.2f}m "
                f"{d.predicted_s * 1e3:9.3f} {d.actual_s * 1e3:9.3f} "
                f"{ratio:7.2f}"
            )
        if self.unmatched_predicted:
            lines.append(
                "  predicted but never recorded: "
                + ", ".join(self.unmatched_predicted)
            )
        if self.unmatched_actual:
            lines.append(
                "  recorded but never predicted: "
                + ", ".join(self.unmatched_actual)
            )
        return "\n".join(lines)


def align(
    plan: "Plan",
    profile: RunProfile,
    *,
    network: Any | None = None,
    sizes: Any | None = None,
    costs: Any | None = None,
    exec_slots: int | None = None,
) -> ProfileReport:
    """Align recorded spans against the simulator's predicted timeline.

    Runs :func:`repro_torch.sched.simulate` on ``plan.system`` under the given
    models, then matches predicted exec events to recorded exec spans by
    step name.  Actual times are normalised so the earliest recorded span
    starts at 0, mirroring the simulation clock.
    """
    from repro_torch.sched.simulate import simulate

    sim = simulate(
        plan.system,
        network=network,
        sizes=sizes,
        costs=costs,
        exec_slots=exec_slots,
    )

    # Predicted: earliest occurrence + duration per step name.
    pred: dict[str, tuple[float, float]] = {}
    for timeline in sim.timelines.values():
        for ev in timeline:
            if ev.kind != "exec" or ev.name is None:
                continue
            cur = pred.get(ev.name)
            if cur is None or ev.start < cur[0]:
                pred[ev.name] = (ev.start, ev.end - ev.start)

    run_spans = [s for s in profile.spans if s.kind != "phase"]
    t0 = min((s.start for s in run_spans), default=0.0)
    actual: dict[str, tuple[float, float]] = {}
    samples: dict[str, list[float]] = {}
    for s in run_spans:
        if s.kind != "exec":
            continue
        samples.setdefault(s.name, []).append(s.duration)
        cur = actual.get(s.name)
        if cur is None or (s.start - t0) < cur[0]:
            actual[s.name] = (s.start - t0, s.duration)
    for step, (start, _) in actual.items():
        vals = samples[step]
        actual[step] = (start, sum(vals) / len(vals))

    drifts = tuple(
        StepDrift(
            step=step,
            predicted_start=pred[step][0],
            actual_start=actual[step][0],
            predicted_s=pred[step][1],
            actual_s=actual[step][1],
        )
        for step in sorted(set(pred) & set(actual),
                           key=lambda s: pred[s][0])
    )
    actual_makespan = max(
        (s.end - t0 for s in run_spans), default=0.0
    )
    return ProfileReport(
        backend=profile.backend,
        predicted_makespan=sim.makespan,
        actual_makespan=actual_makespan,
        drifts=drifts,
        predicted_cross_bytes=sim.cross_bytes,
        actual_cross_bytes=profile.cross_bytes(),
        unmatched_predicted=tuple(sorted(set(pred) - set(actual))),
        unmatched_actual=tuple(sorted(set(actual) - set(pred))),
    )
