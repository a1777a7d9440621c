"""Centralised dataflow interpreter over the program IR, copied from ``repro.exec.central``.

:class:`ProgramRuntime` is the engine behind the ``inprocess`` backend: it
drives one :class:`~repro_torch.exec.interp.Cursor` per location and repeatedly
fires the ops the SWIRL semantics enables —

* a matching active ``SendOp``/``RecvOp`` pair with the datum resident at
  the source fires as a (COMM)/(L-COMM) copy;
* an ``ExecOp`` whose occurrence is active on *every* location of ``M(s)``
  with ``In^D(s)`` resident fires the step body once (on the leader) and
  stores ``Out^D(s)`` everywhere —

with real effects on a thread pool, per-step retry, straggler speculation
and heartbeats exactly like the reference's legacy reduction runtime
(``repro.workflow.runtime.Runtime``, which the port does not copy).  Because op completion flags are a structured program counter,
checkpoints are still *reachable SWIRL terms*: the remaining system is
rebuilt from the not-yet-done ops
(:meth:`~repro_torch.exec.program.ExecProgram.remaining_system`), so snapshots
stay interchangeable with every other checkpointing backend.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    wait,
)
from pathlib import Path
from typing import Any, Mapping

from repro_torch.core.compile import StepMeta
from repro_torch.core.parser import dumps
from repro_torch.obs.events import active

from .interp import (
    Cursor,
    Deadline,
    call_with_timeout,
    enabled_exec_picks,
    first_enabled_comm,
    record_comm_fire,
    record_exec_fire,
    record_policy_fire,
)
from .policy import FaultPolicy, StepTimeoutError
from .program import ExecOp, ExecProgram

PayloadKey = tuple[str, str]  # (location, data_name)

__all__ = ["ProgramRuntime"]

_MISSING = object()


class ProgramRuntime:
    """Fault-tolerant, checkpointable executor over an :class:`ExecProgram`.

    Parameters mirror the legacy reduction runtime; ``completed`` names
    steps already finished in a restored snapshot — their recorded outputs
    (harvested from ``initial_payloads``) are replayed instead of
    re-executing the step body.

    Spans go to ``recorder``; a run given none records its ``exec`` spans
    (no comm or policy rows) into the process recorder while a
    ``torch.profiler`` records (:func:`repro_torch.obs.active`), and its
    result has no profile.
    """

    def __init__(
        self,
        program: ExecProgram,
        steps: Mapping[str, StepMeta],
        *,
        initial_payloads: Mapping[PayloadKey, Any] | None = None,
        expected_s: Mapping[str, float] | None = None,
        retry=None,
        speculation=None,
        max_workers: int = 8,
        checkpoint_every: int = 0,
        checkpoint_path: str | Path | None = None,
        heartbeat=None,
        completed: frozenset[str] = frozenset(),
        recorder=None,
        policy: FaultPolicy | None = None,
    ):
        from repro_torch.workflow.fault import (
            HeartbeatMonitor,
            RetryPolicy,
            SpeculationPolicy,
        )
        from repro_torch.workflow.runtime import RunStats

        self.program = program
        self.steps = dict(steps)
        self.payloads: dict[PayloadKey, Any] = dict(initial_payloads or {})
        self.expected_s = dict(expected_s or {})
        # A uniform FaultPolicy constructs the engines unless the caller
        # passed explicit ones (explicit beats policy beats defaults).
        self.policy = policy
        if policy is not None:
            retry = retry or policy.retry_policy()
            speculation = speculation or policy.speculation_policy()
            heartbeat = heartbeat or policy.heartbeat_monitor()
        self.retry = retry or RetryPolicy()
        self.speculation = speculation or SpeculationPolicy(enabled=False)
        self.max_workers = max_workers
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        # Satellite fix: the documented default now lives in ONE place
        # (fault.DEFAULT_HEARTBEAT_TIMEOUT_S) instead of a 5s dataclass
        # default silently overridden to 60s here.
        self.heartbeat = heartbeat or HeartbeatMonitor()
        self.stats = RunStats()
        self.recorder = recorder
        # Where the exec spans go: the run's own recorder, or (set by
        # ``run``) the process recorder while a profiler records.
        self._exec_spans = recorder
        self.completed_execs: set[str] = set(completed)
        self._replayable = frozenset(completed)
        self._lock = threading.Lock()
        self.cursors: dict[str, Cursor] = {}
        self.data: dict[str, set[str]] = {}
        for lp in program.programs:
            for op in lp.exec_ops():
                if op.step not in self.steps:
                    raise KeyError(
                        f"no step function registered for {op.step!r}"
                    )
            self.cursors[lp.location] = Cursor(lp)
            self.data[lp.location] = set(lp.data)
            self.heartbeat.register(lp.location)
        # Outputs recoverable for replayed (already-completed) steps.
        self._recorded = self._recorded_outputs()

    # -- checkpointing -------------------------------------------------------
    def checkpoint(self):
        from repro_torch.workflow.runtime import Checkpoint

        with self._lock:
            remaining = self.program.remaining_system(
                {l: c.done_flags() for l, c in self.cursors.items()},
                {l: frozenset(d) for l, d in self.data.items()},
            )
            return Checkpoint(
                system_text=dumps(remaining),
                payloads=dict(self.payloads),
                completed_execs=frozenset(self.completed_execs),
            )

    def _recorded_outputs(self) -> dict[str, dict[str, Any]]:
        recorded: dict[str, dict[str, Any]] = {}
        if not self._replayable:
            return recorded
        by_datum: dict[str, Any] = {}
        for (_, d), v in self.payloads.items():
            by_datum.setdefault(d, v)
        for lp in self.program.programs:
            for op in lp.exec_ops():
                if op.step in recorded or op.step not in self._replayable:
                    continue
                out: dict[str, Any] = {}
                complete = True
                for d in op.outputs:
                    hit = next(
                        (
                            self.payloads[(l, d)]
                            for l in sorted(op.locations)
                            if (l, d) in self.payloads
                        ),
                        by_datum.get(d, _MISSING),
                    )
                    if hit is _MISSING:
                        complete = False
                        break
                    out[d] = hit
                if complete:
                    recorded[op.step] = out
        return recorded

    # -- enabled-op matching ---------------------------------------------------
    def _apply_comms(self) -> int:
        """Fire every currently enabled communication (fixpoint)."""
        n = 0
        with self._lock:
            while True:
                hit = first_enabled_comm(self.cursors, self.data)
                if hit is None:
                    return n
                op, src, i, j = hit
                self.cursors[src].complete(i)
                self.cursors[op.dst].complete(j)
                self.data[op.dst].add(op.data)
                payload = self.payloads[(op.src, op.data)]
                self.payloads[(op.dst, op.data)] = payload
                self.stats.comms += 1
                if self.recorder is not None:
                    t = time.monotonic()
                    record_comm_fire(self.recorder, op, t, t, payload)
                n += 1

    def _enabled_execs(self) -> list[tuple[ExecOp, tuple[tuple[str, int], ...]]]:
        """(EXEC)-enabled ops: active on all of ``M(s)``, inputs resident."""
        with self._lock:
            return enabled_exec_picks(self.cursors, self.data)

    # -- effects ---------------------------------------------------------------
    def _run_exec(self, op: ExecOp, pool: ThreadPoolExecutor) -> dict[str, Any]:
        leader = min(op.locations)
        if op.step in self._replayable and op.step in self._recorded:
            # Restored snapshot: replay the recorded outputs, don't redo.
            for l in op.locations:
                self.heartbeat.beat(l)
            return dict(self._recorded[op.step])
        inputs = {d: self.payloads[(leader, d)] for d in op.inputs}
        fn = self.steps[op.step].fn
        timeout_s = self.policy.timeout_s if self.policy is not None else None

        def attempt() -> Mapping[str, Any]:
            if timeout_s is None:
                return fn(inputs)
            try:
                return call_with_timeout(
                    lambda: fn(inputs), timeout_s, op.step
                )
            except StepTimeoutError:
                with self._lock:
                    self.stats.timeouts += 1
                if self.recorder is not None:
                    t = time.monotonic()
                    record_policy_fire(
                        self.recorder, "timeout", leader, op.step,
                        t - timeout_s, t,
                    )
                raise

        def with_retry() -> Mapping[str, Any]:
            return self.retry.run(
                attempt, on_retry=lambda n, e: self._count_retry()
            )

        t0 = time.monotonic()
        out, speculated = self.speculation.run(
            with_retry, self.expected_s.get(op.step), pool
        )
        dt = time.monotonic() - t0
        if speculated:
            with self._lock:
                self.stats.speculations += 1
        missing = set(op.outputs) - set(out)
        if missing:
            raise RuntimeError(
                f"step {op.step!r} did not produce outputs {sorted(missing)}"
            )
        with self._lock:
            self.stats.exec_log.append((op.step, leader, dt))
        if self._exec_spans is not None:
            record_exec_fire(self._exec_spans, op, t0, t0 + dt)
        for l in op.locations:
            self.heartbeat.beat(l)
        return {d: out[d] for d in op.outputs}

    def _apply_exec(
        self,
        op: ExecOp,
        picks: tuple[tuple[str, int], ...],
        outputs: dict[str, Any],
    ) -> None:
        with self._lock:
            for l, i in picks:
                self.cursors[l].complete(i)
                self.data[l].update(op.outputs)
                for d, v in outputs.items():
                    self.payloads[(l, d)] = v
            self.stats.execs += 1
            self.completed_execs.add(op.step)

    def _count_retry(self) -> None:
        with self._lock:
            self.stats.retries += 1

    # -- main loop --------------------------------------------------------------
    def run(self, *, max_rounds: int = 1_000_000):
        from repro_torch.workflow.runtime import WorkflowDeadlock

        t_start = time.monotonic()
        if self.recorder is None:
            self._exec_spans = active()
        since_ckpt = 0
        deadline = Deadline(
            self.policy.deadline_s if self.policy is not None else None
        )
        pool = ThreadPoolExecutor(max_workers=self.max_workers)
        try:
            inflight: dict[tuple, tuple[ExecOp, tuple, Future]] = {}
            for _ in range(max_rounds):
                if deadline.expired():
                    if self.recorder is not None:
                        t = time.monotonic()
                        record_policy_fire(
                            self.recorder, "deadline", "-", "run", t, t
                        )
                    deadline.check()  # raises RunDeadlineExceeded
                progressed = self._apply_comms() > 0

                for op, picks in self._enabled_execs():
                    key = (op.step, op.inputs, op.outputs, op.locations)
                    if key not in inflight:
                        inflight[key] = (
                            op,
                            picks,
                            pool.submit(self._run_exec, op, pool),
                        )
                        progressed = True

                if not inflight:
                    if progressed:
                        continue
                    break  # terminated or deadlocked

                done, _ = wait(
                    [f for _, _, f in inflight.values()],
                    timeout=deadline.remaining(),
                    return_when=FIRST_COMPLETED,
                )
                for key in [
                    k for k, (_, _, f) in inflight.items() if f in done
                ]:
                    op, picks, fut = inflight.pop(key)
                    self._apply_exec(op, picks, fut.result())
                    since_ckpt += 1
                    if (
                        self.checkpoint_every
                        and self.checkpoint_path
                        and since_ckpt >= self.checkpoint_every
                    ):
                        self.checkpoint().save(self.checkpoint_path)
                        self.stats.checkpoints += 1
                        since_ckpt = 0
        finally:
            # Do not block on abandoned speculation losers — they are pure
            # and their results are discarded.
            pool.shutdown(wait=False, cancel_futures=True)

        self.stats.wall_s = time.monotonic() - t_start
        if not all(c.finished() for c in self.cursors.values()):
            remaining = self.program.remaining_system(
                {l: c.done_flags() for l, c in self.cursors.items()},
                {l: frozenset(d) for l, d in self.data.items()},
            )
            raise WorkflowDeadlock(
                "workflow did not terminate; remaining system:\n"
                + remaining.pretty()
            )
        return self.stats

    # -- results -------------------------------------------------------------
    def payload(self, location: str, data: str) -> Any:
        return self.payloads[(location, data)]

    def location_data(self, location: str) -> dict[str, Any]:
        return {
            d: v for (l, d), v in self.payloads.items() if l == location
        }
