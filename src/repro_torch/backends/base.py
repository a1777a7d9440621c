"""The ``Backend`` protocol every execution target implements.

A copy of ``repro/backends/base.py``.  A backend turns a lowered
:class:`~repro_torch.exec.program.ExecProgram` — the per-location executable
program IR of :mod:`repro_torch.exec` — plus a step registry into a
:class:`BackendProgram`, the backend-specific compiled artifact behind
:class:`repro_torch.api.Executable`.  The port ships two interpreters over that
IR: ``torch`` (:mod:`repro_torch.backends.torch_backend`), which places
each location on a CUDA device, and ``inprocess``
(:mod:`repro_torch.backends.inprocess`), the reference's checkpointable
thread-pool runtime.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

from repro_torch.core.compile import StepMeta
from repro_torch.core.syntax import WorkflowSystem
from repro_torch.exec.program import ExecProgram, ensure_program

PayloadKey = tuple[str, str]  # (location, data element)

#: Default bound on concurrently-executing instances in :meth:`run_many`.
DEFAULT_MAX_CONCURRENT = 8


class BackendCapabilityError(NotImplementedError):
    """The selected backend does not support the requested operation."""


class UnknownBackendError(KeyError):
    """No backend registered under the requested name."""


@dataclass
class ExecutionResult:
    """What one :meth:`repro_torch.api.Executable.run` produced.

    ``data`` maps location → data element → payload: the contents of every
    location's data scope after the system terminated, identical across
    backends for the same plan + steps (the bisimulation guarantee made
    observable).
    """

    backend: str
    data: dict[str, dict[str, Any]]
    stats: Any = None
    #: :class:`repro_torch.obs.RunProfile` when the run was traced
    #: (``lower(..., trace=True)``), else ``None``.
    profile: Any = None

    def payload(self, location: str, data: str) -> Any:
        return self.data[location][data]

    def location_data(self, location: str) -> dict[str, Any]:
        return dict(self.data[location])


@dataclass
class BackendProgram(ABC):
    """A compiled, runnable artifact for one backend.

    Holds the lowered :class:`~repro_torch.exec.program.ExecProgram` the backend
    interprets; ``system`` is the SWIRL term view of the same program
    (reconstructed from the op arrays, cached).  Compiled once, a program
    can be run many times — :meth:`run_many` executes a batch of workflow
    instances against the same lowered artifact with a bounded pool.
    """

    program: ExecProgram
    steps: Mapping[str, StepMeta]
    options: dict[str, Any] = field(default_factory=dict)

    @property
    def system(self) -> WorkflowSystem:
        return self.program.system

    @abstractmethod
    def run(
        self, initial_payloads: Mapping[PayloadKey, Any] | None = None
    ) -> ExecutionResult:
        ...

    # -- compile-once / run-many ---------------------------------------------
    def run_many(
        self,
        inputs: Sequence[Mapping[PayloadKey, Any] | None],
        *,
        max_concurrent: int = DEFAULT_MAX_CONCURRENT,
    ) -> list[ExecutionResult]:
        """Execute one workflow instance per entry of ``inputs``.

        All instances interpret the *same* compiled program (encode /
        rewrite / lower / compile are paid once); at most ``max_concurrent``
        instances are in flight at a time.  Results are returned in input
        order.  Backends override :meth:`_run_instance` when per-instance
        isolation needs care (shared transports, mutable snapshot state).
        """
        inputs = list(inputs)
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}"
            )
        if not inputs:
            return []
        results: list[ExecutionResult | None] = [None] * len(inputs)
        workers = min(max_concurrent, len(inputs))
        with ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="swirl-run-many"
        ) as pool:
            futures = [
                pool.submit(self._run_instance, payloads, str(i))
                for i, payloads in enumerate(inputs)
            ]
            errors: list[BaseException] = []
            for i, fut in enumerate(futures):
                try:
                    results[i] = fut.result()
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
            if errors:
                raise errors[0]
        return results  # type: ignore[return-value]

    def _run_instance(
        self,
        initial_payloads: Mapping[PayloadKey, Any] | None,
        instance_tag: str,
    ) -> ExecutionResult:
        """Run one instance of a :meth:`run_many` batch (override-point)."""
        return self.run(initial_payloads)

    def concurrent_batches(self) -> bool:
        """Whether overlapping whole runs on this one program are safe.

        ``False`` (the default) means a run mutates program-level state —
        snapshot slots, a worker fleet, device buffers — so
        :class:`repro_torch.api.Executable` serialises whole runs behind its
        re-entry guard.  Backends whose runs are fully isolated from each
        other (fresh per-run transports, per-instance endpoint namespaces)
        return ``True`` and one compiled Executable then serves many
        concurrent batches — the serving gateway's cache-hit hot path.
        """
        return False

    # Optional capabilities — backends that support them override.
    def checkpoint(self):
        raise BackendCapabilityError(
            f"backend does not support checkpointing: {type(self).__name__}"
        )

    def restore(self, ckpt) -> None:
        raise BackendCapabilityError(
            f"backend does not support restore: {type(self).__name__}"
        )


class Backend(ABC):
    """Factory for :class:`BackendProgram` instances.

    ``capabilities`` advertises optional features (``"checkpoint"``,
    ``"fault-injection"``, ``"mesh"``); :mod:`repro_torch.api` consults it to fail
    fast instead of deep inside a run.
    """

    name: str = "abstract"
    capabilities: frozenset[str] = frozenset()

    @abstractmethod
    def compile(
        self,
        program: ExecProgram | WorkflowSystem,
        steps: Mapping[str, StepMeta],
        options: Mapping[str, Any],
    ) -> BackendProgram:
        """Compile a lowered program (a bare system is lowered on entry).

        Implementations call :meth:`lower` first so both an
        :class:`~repro_torch.exec.program.ExecProgram` (the staged pipeline) and
        a :class:`WorkflowSystem` (legacy/third-party callers written
        against the PR-1 signature) are accepted.
        """
        ...

    @staticmethod
    def lower(
        program: ExecProgram | WorkflowSystem,
        options: Mapping[str, Any] | None = None,
    ) -> ExecProgram:
        """Coerce a ``compile`` source into the execution IR."""
        return ensure_program(
            program, schedule=(options or {}).get("schedule")
        )

    def validate_options(self, options: Mapping[str, Any]) -> None:
        """Reject unknown lowering options early (override to extend)."""
        unknown = set(options) - self.known_options()
        if unknown:
            raise TypeError(
                f"unknown options for backend {self.name!r}: "
                f"{sorted(unknown)}; supported: {sorted(self.known_options())}"
            )

    def known_options(self) -> frozenset[str]:
        # "schedule" is the uniform hand-down of the placement scheduler's
        # ScheduleReport (repro_torch.sched): Plan.lower attaches it for every
        # backend; backends may consult it (the torch backend maps each
        # network group onto a contiguous device block) or ignore it.
        # "trace" turns on the repro_torch.obs span recorder and attaches a
        # RunProfile to every result.  "policy" is the uniform
        # :class:`repro_torch.exec.policy.FaultPolicy` — every backend honors
        # retry/timeout/deadline through the shared interp helpers.
        return frozenset({"schedule", "trace", "policy"})
