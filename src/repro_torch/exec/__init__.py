"""``repro_torch.exec`` — the executable program IR, copied from ``repro.exec``.

:func:`lower_system` turns an (optimised) workflow system into an
:class:`ExecProgram`: one :class:`LocationProgram` per location holding a
program-order array of resolved ``SEND``/``RECV``/``EXEC`` ops plus a flat
control skeleton.  The port's ``torch`` backend interprets this one form.
"""

from .program import (
    ExecOp,
    ExecProgram,
    LocationProgram,
    Op,
    RecvOp,
    SendOp,
    lower_flat,
    lower_system,
    to_action,
)
from .interp import Cursor, Deadline, StepGuard
from .policy import FaultPolicy, RunDeadlineExceeded, StepTimeoutError

__all__ = [
    "Deadline",
    "FaultPolicy",
    "RunDeadlineExceeded",
    "StepGuard",
    "StepTimeoutError",
    "ExecOp",
    "SendOp",
    "RecvOp",
    "Op",
    "LocationProgram",
    "ExecProgram",
    "lower_system",
    "lower_flat",
    "to_action",
    "Cursor",
]
