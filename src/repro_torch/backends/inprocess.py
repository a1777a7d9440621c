"""``inprocess`` backend — the centralised, checkpointable dataflow runtime.

A copy of ``repro/backends/inprocess.py`` over the port's own program IR and
:class:`~repro_torch.exec.central.ProgramRuntime`.  It places nothing: a
payload is stored as the step gave it, so tensors stay on the device their
step put them on (the trainer's on the model's).  Interprets the per-location program IR (:mod:`repro_torch.exec`) with the
semantics' enabling rules — matching SEND/RECV pairs fire as (COMM) copies,
EXEC ops fire synchronised across ``M(s)`` — with real effects on a thread
pool.  This is the backend with the richest fault-tolerance story (retry,
straggler speculation, heartbeats, consistent snapshots), so it also
implements the optional ``checkpoint``/``restore`` capability; snapshots
are still reachable SWIRL terms (the remaining term is rebuilt from the
program's completion flags), interchangeable with every other
checkpointing backend.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.core.compile import StepMeta
from repro_torch.core.parser import dumps
from repro_torch.core.syntax import WorkflowSystem
from repro_torch.exec.program import ExecProgram, lower_system

from .base import Backend, BackendProgram, ExecutionResult, PayloadKey


class InprocessProgram(BackendProgram):
    # un-annotated → plain class attributes, not dataclass fields
    _runtime = None
    _pending_ckpt = None

    def _build_runtime(
        self,
        initial_payloads: Mapping[PayloadKey, Any] | None,
        *,
        program: ExecProgram | None = None,
        completed: frozenset[str] = frozenset(),
    ):
        from repro_torch.exec.central import ProgramRuntime

        expected = {
            name: meta.expected_seconds
            for name, meta in self.steps.items()
            if meta.expected_seconds is not None
        }
        kwargs = dict(self.options)
        kwargs.pop("schedule", None)  # placement already baked into the IR
        kwargs.setdefault("expected_s", expected or None)
        if kwargs.pop("trace", False):
            from repro_torch.obs.events import TraceRecorder

            kwargs["recorder"] = TraceRecorder()
        return ProgramRuntime(
            program or self.program,
            dict(self.steps),
            initial_payloads=initial_payloads,
            completed=completed,
            **kwargs,
        )

    def _profile(self, rt, stats):
        if rt.recorder is None:
            return None
        from repro_torch.obs.profile import RunProfile

        # Lazy: spans materialise on first access, not per run.
        return RunProfile.from_recorder(
            "inprocess", rt.recorder,
            wall_s=getattr(stats, "wall_s", 0.0) or None,
        )

    def run(
        self, initial_payloads: Mapping[PayloadKey, Any] | None = None
    ) -> ExecutionResult:
        if self._pending_ckpt is not None:
            ckpt, self._pending_ckpt = self._pending_ckpt, None
            # Resume from the snapshot's remaining term: re-lower it and
            # replay completed steps' recorded outputs instead of redoing.
            payloads = dict(ckpt.payloads)
            payloads.update(initial_payloads or {})
            rt = self._build_runtime(
                payloads,
                program=lower_system(ckpt.system),
                completed=frozenset(ckpt.completed_execs),
            )
        else:
            rt = self._build_runtime(initial_payloads)
        self._runtime = rt
        stats = rt.run()
        return ExecutionResult(
            backend="inprocess", data=self._collect(rt), stats=stats,
            profile=self._profile(rt, stats),
        )

    def _run_instance(
        self,
        initial_payloads: Mapping[PayloadKey, Any] | None,
        instance_tag: str,
    ) -> ExecutionResult:
        # run_many instances each get a pristine runtime; the shared
        # snapshot state (_runtime/_pending_ckpt) is left untouched.
        rt = self._build_runtime(initial_payloads)
        stats = rt.run()
        return ExecutionResult(
            backend="inprocess", data=self._collect(rt), stats=stats,
            profile=self._profile(rt, stats),
        )

    def _collect(self, rt) -> dict[str, dict[str, Any]]:
        data: dict[str, dict[str, Any]] = {
            loc: {} for loc in self.system.locations()
        }
        for (loc, d), v in rt.payloads.items():
            data.setdefault(loc, {})[d] = v
        return data

    def checkpoint(self):
        from repro_torch.workflow.runtime import Checkpoint

        if self._runtime is not None:
            return self._runtime.checkpoint()
        # Pristine snapshot: nothing has run yet.
        return Checkpoint(
            system_text=dumps(self.system),
            payloads={},
            completed_execs=frozenset(),
        )

    def restore(self, ckpt) -> None:
        self._pending_ckpt = ckpt


class InprocessBackend(Backend):
    name = "inprocess"
    capabilities = frozenset({"checkpoint", "retry", "speculation"})

    def known_options(self) -> frozenset[str]:
        return super().known_options() | frozenset(
            {
                "retry",
                "speculation",
                "expected_s",
                "max_workers",
                "checkpoint_every",
                "checkpoint_path",
                "heartbeat",
            }
        )

    def compile(
        self,
        program: ExecProgram | WorkflowSystem,
        steps: Mapping[str, StepMeta],
        options: Mapping[str, Any],
    ) -> InprocessProgram:
        return InprocessProgram(
            program=self.lower(program, options),
            steps=dict(steps),
            options=dict(options),
        )


def factory() -> Backend:
    return InprocessBackend()
