"""Bundle compiler — the ``SWIRLCompiler`` layer, copied from ``repro.core.compile``.

A *bundle* is a self-contained, per-location executable: the location's
execution trace plus the metadata the semantics does not model (step
callables / commands, data payload specs, channel endpoints).

Since the execution-IR refactor the canonical per-location executable is
the :class:`~repro_torch.exec.program.LocationProgram` of :mod:`repro_torch.exec`
(program-order op arrays, interpreted by every backend); what remains here
is the **step metadata model** (:class:`StepMeta`, shared by the whole
toolchain) and the legacy bundle layer:

* :class:`LocationBundle` / :func:`build_bundles` — a *view shim* over the
  canonical lowering, feeding the deprecated tree runtimes that are kept
  as differential-test oracles;
* :func:`emit_python_source` / :func:`emit_all` — deprecation shims over
  :mod:`repro_torch.exec.emit` (standalone per-location Python source, now
  generated from the program IR).
"""

from __future__ import annotations

import textwrap
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from .syntax import (
    Exec,
    LocationConfig,
    Recv,
    Send,
    Trace,
    WorkflowSystem,
    actions,
)

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
    # Declared byte-size per output datum, consumed by the placement
    # scheduler's payload-size estimator (repro_torch.sched.SizeModel):
    output_bytes: Mapping[str, int] | None = None


@dataclass(frozen=True)
class Channel:
    """A directed (src, dst, port) communication endpoint pair."""

    src: str
    dst: str
    port: str


@dataclass
class LocationBundle:
    """Self-contained executable for one location."""

    location: str
    initial_data: frozenset[str]
    trace: Trace
    steps: dict[str, StepMeta] = field(default_factory=dict)

    def channels(self) -> list[Channel]:
        """Every channel endpoint this bundle communicates over."""
        chans: set[Channel] = set()
        for a in actions(self.trace):
            if isinstance(a, Send):
                chans.add(Channel(a.src, a.dst, a.port))
            elif isinstance(a, Recv):
                chans.add(Channel(a.src, a.dst, a.port))
        return sorted(chans, key=lambda c: (c.src, c.dst, c.port))

    def exec_steps(self) -> list[str]:
        return [a.step for a in actions(self.trace) if isinstance(a, Exec)]


def build_bundles(
    w: WorkflowSystem,
    step_fns: Mapping[str, StepFn],
    *,
    step_meta: Mapping[str, StepMeta] | None = None,
) -> dict[str, LocationBundle]:
    """Compile a workflow system into one bundle per location.

    ``step_fns`` must cover every step executed anywhere in ``w``; a step
    mapped onto several locations (spatial constraint) receives the same
    callable everywhere — the runtime synchronises the exec like the (EXEC)
    rule does.

    Since the execution-IR refactor this is a *view shim* over the
    canonical lowering (:func:`repro_torch.exec.lower_system`): bundles are
    projected from the per-location programs, and no backend consumes them
    anymore — they feed the legacy tree runtimes kept as reference oracles.
    The legacy name :func:`compile_bundles` additionally warns.
    """
    from repro_torch.exec.program import lower_system

    program = lower_system(w)
    bundles: dict[str, LocationBundle] = {}
    for lp in program.programs:
        local_steps: dict[str, StepMeta] = {}
        for op in lp.exec_ops():
            if op.step not in step_fns:
                raise KeyError(
                    f"no step function registered for {op.step!r}"
                )
            meta = (step_meta or {}).get(op.step)
            local_steps[op.step] = meta or StepMeta(
                fn=step_fns[op.step],
                inputs=frozenset(op.inputs),
                outputs=frozenset(op.outputs),
            )
        bundles[lp.location] = LocationBundle(
            location=lp.location,
            initial_data=lp.data,
            trace=w[lp.location].trace,
            steps=local_steps,
        )
    return bundles


def compile_bundles(
    w: WorkflowSystem,
    step_fns: Mapping[str, StepFn],
    *,
    step_meta: Mapping[str, StepMeta] | None = None,
) -> dict[str, LocationBundle]:
    """Deprecated shim for :func:`build_bundles` (legacy free function)."""
    from repro_torch._compat import warn_legacy

    warn_legacy(
        "repro_torch.core.compile_bundles()",
        'swirl.trace(...).lower("threaded").compile(step_fns)',
    )
    return build_bundles(w, step_fns, step_meta=step_meta)


# ---------------------------------------------------------------------------
# Standalone Python source emission (paper §5's generated bundles)
#
# The generators moved to repro_torch.exec.emit, driven by the per-location
# program IR instead of the trace trees; the two entry points below are
# deprecation shims kept for the legacy bundle workflow.
# ---------------------------------------------------------------------------


def emit_python_source(bundle: LocationBundle) -> str:
    """Deprecated: emit a standalone Python program for one bundle.

    Shim over :func:`repro_torch.exec.emit.emit_location_source` — the bundle's
    trace is lowered to a :class:`~repro_torch.exec.program.LocationProgram` and
    emitted from its op arrays.
    """
    from repro_torch._compat import warn_legacy
    from repro_torch.exec.emit import emit_location_source
    from repro_torch.exec.program import lower_system

    warn_legacy(
        "repro_torch.core.compile.emit_python_source(bundle)",
        "repro_torch.exec.emit_location_source(plan.exec_program()[location])",
    )
    system = WorkflowSystem(
        (
            LocationConfig(
                bundle.location, bundle.initial_data, bundle.trace
            ),
        )
    )
    return emit_location_source(lower_system(system)[bundle.location])


def emit_all(w: WorkflowSystem) -> dict[str, str]:
    """Deprecated: per-location sources for a whole system.

    Shim over :func:`repro_torch.exec.emit.emit_program_sources`.
    """
    from repro_torch._compat import warn_legacy
    from repro_torch.exec.emit import emit_program_sources
    from repro_torch.exec.program import lower_system

    warn_legacy(
        "repro_torch.core.compile.emit_all(system)",
        "repro_torch.exec.emit_program_sources(plan.exec_program())",
    )
    return emit_program_sources(lower_system(w))
