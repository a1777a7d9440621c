"""The parts of ``repro.workflow`` the port needs.

* :mod:`~repro_torch.workflow.fault`   — retry/speculation/heartbeat policies
  (:mod:`repro_torch.exec.policy` builds its retry engine from them);
* :mod:`~repro_torch.workflow.runtime` — the run records of the ``inprocess``
  backend's engine: :class:`RunStats`, :class:`Checkpoint`,
  :class:`WorkflowDeadlock`.
"""

from .runtime import Checkpoint, RunStats, WorkflowDeadlock

__all__ = ["Checkpoint", "RunStats", "WorkflowDeadlock"]
