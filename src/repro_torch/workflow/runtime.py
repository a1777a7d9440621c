"""The run records of the SWIRL workflow runtime, copied from ``repro.workflow.runtime``.

The port keeps the three names that :mod:`repro_torch.exec.central` (the
engine of the ``inprocess`` backend) needs: :class:`RunStats`, the counts a
run reports; :class:`Checkpoint`, a consistent snapshot; and
:class:`WorkflowDeadlock`, raised when a run cannot terminate.

Because the runtime state is always a *reachable workflow system* (Def. 13),
a checkpoint is simply ``dumps(state)`` + the payload store — the SWIRL term
is its own program counter.  Restart re-parses the term and resumes reduction;
in-flight steps at crash time are re-executed, which is sound because steps
are pure (the RDD-lineage argument).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

from repro_torch.core.parser import loads
from repro_torch.core.syntax import WorkflowSystem

StepFn = Callable[[Mapping[str, Any]], Mapping[str, Any]]
PayloadKey = tuple[str, str]  # (location, data_name)


class WorkflowDeadlock(RuntimeError):
    pass


@dataclass
class RunStats:
    execs: int = 0
    comms: int = 0
    retries: int = 0
    speculations: int = 0
    timeouts: int = 0
    checkpoints: int = 0
    wall_s: float = 0.0
    exec_log: list[tuple[str, str, float]] = field(default_factory=list)
    # (step, leader location, seconds)


@dataclass
class Checkpoint:
    """A consistent global snapshot: remaining system + payload store."""

    system_text: str
    payloads: dict[PayloadKey, Any]
    completed_execs: frozenset[str]

    def save(self, path: str | Path) -> None:
        Path(path).write_bytes(pickle.dumps(self))

    @staticmethod
    def load(path: str | Path) -> "Checkpoint":
        ckpt = pickle.loads(Path(path).read_bytes())
        if not isinstance(ckpt, Checkpoint):
            raise TypeError(f"{path} is not a workflow checkpoint")
        return ckpt

    @property
    def system(self) -> WorkflowSystem:
        return loads(self.system_text)
