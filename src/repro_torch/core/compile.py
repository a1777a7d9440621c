"""The step metadata model shared by the whole toolchain.

A copy of the first part of ``repro/core/compile.py``: :data:`StepFn`,
:class:`StepMeta` and :class:`Channel`.  The reference's legacy bundle
layer (``LocationBundle``, ``build_bundles``, the source emitters) is not
carried over: the canonical per-location executable is the
:class:`~repro_torch.exec.program.LocationProgram` of
:mod:`repro_torch.exec`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

# A step function: mapping of input data name -> payload  ->  mapping of
# output data name -> payload.  Pure by contract (same assumption the paper
# inherits from dataflow semantics; it is what makes re-execution-based fault
# tolerance sound).
StepFn = Callable[[Mapping[str, Any]], Mapping[str, Any]]


@dataclass(frozen=True)
class StepMeta:
    """Declarative metadata for one step (the paper's metadata file entry)."""

    fn: StepFn
    inputs: frozenset[str] = frozenset()
    outputs: frozenset[str] = frozenset()
    # Scheduling hints used by the runtime's straggler mitigation:
    expected_seconds: float | None = None
    # Declared byte-size per output datum, for a placement scheduler's
    # payload-size estimator:
    output_bytes: Mapping[str, int] | None = None


@dataclass(frozen=True)
class Channel:
    """A directed (src, dst, port) communication endpoint pair."""

    src: str
    dst: str
    port: str
