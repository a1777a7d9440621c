"""``repro_torch.exec`` — the executable program IR, copied from ``repro.exec``.

:func:`lower_system` turns an (optimised) workflow system into an
:class:`ExecProgram`: one :class:`LocationProgram` per location holding a
program-order array of resolved ``SEND``/``RECV``/``EXEC`` ops plus a flat
control skeleton.  Every backend of the port interprets this one form,
:mod:`~repro_torch.exec.emit` turns it into standalone per-location Python
source (paper §5), and :mod:`~repro_torch.exec.elastic` renames its
locations in place for the ``multiprocess`` backend's recovery.
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
from .emit import emit_location_source, emit_program_sources
from .elastic import rename_program, resimulate

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
    "emit_location_source",
    "emit_program_sources",
    "rename_program",
    "resimulate",
]
