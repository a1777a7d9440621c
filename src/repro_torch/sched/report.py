"""Schedule report — what the placement search chose and what it predicts.

A copy of ``repro/sched/report.py``.

Attached to :class:`repro_torch.api.Plan` by ``Plan.schedule`` /
``Plan.lower(placement="auto")`` and rendered by ``Plan.explain``; also
handed down to every backend as the uniform ``schedule`` lowering option
(the ``torch`` backend maps each network group's locations onto one
contiguous block of devices).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from .network import NetworkModel
from .simulate import Simulation


@dataclass(frozen=True)
class ScheduleReport:
    """Chosen placement + predictions, against the round-robin baseline."""

    objective: str
    network: NetworkModel
    placement: Mapping[str, tuple[str, ...]]
    baseline_placement: Mapping[str, tuple[str, ...]]
    predicted: Simulation
    baseline: Simulation
    search_seconds: float = 0.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "placement", dict(self.placement))
        object.__setattr__(
            self, "baseline_placement", dict(self.baseline_placement)
        )

    @property
    def bytes_saved(self) -> int:
        return self.baseline.cross_bytes - self.predicted.cross_bytes

    @property
    def bytes_saved_frac(self) -> float:
        if self.baseline.cross_bytes == 0:
            return 0.0
        return self.bytes_saved / self.baseline.cross_bytes

    @property
    def makespan_speedup(self) -> float:
        if self.predicted.makespan == 0:
            return 1.0
        return self.baseline.makespan / self.predicted.makespan

    def summary(self) -> str:
        lines = [
            f"objective: {self.objective}   network: {self.network.name}"
            + (f"   search: {self.search_seconds * 1e3:.0f} ms"),
            f"predicted makespan: {self.predicted.makespan * 1e3:.2f} ms "
            f"(round-robin {self.baseline.makespan * 1e3:.2f} ms, "
            f"{self.makespan_speedup:.2f}x)",
            f"cross-location bytes: {self.predicted.cross_bytes} "
            f"(round-robin {self.baseline.cross_bytes}, "
            f"saved {self.bytes_saved_frac * 100:.0f}%)",
        ]
        lines.append("placement (step -> M(s)):")
        for s, locs in sorted(self.placement.items()):
            lines.append(f"    {s:<24} {', '.join(locs)}")
        if self.predicted.critical_path:
            lines.append(
                "critical path: "
                + " -> ".join(self.predicted.critical_path)
            )
        return "\n".join(lines)
