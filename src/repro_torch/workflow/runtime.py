"""The SWIRL workflow runtime — execution *is* reduction.

A copy of ``repro/workflow/runtime.py``.  :class:`RunStats`,
:class:`Checkpoint` and :class:`WorkflowDeadlock` are the run records of the
``inprocess`` backend's engine (:mod:`repro_torch.exec.central`); the
reduction :class:`Runtime` itself is deprecated and kept, as in the
reference, as an oracle for the program-IR interpreters.

The runtime interprets a :class:`~repro_torch.core.syntax.WorkflowSystem` by
repeatedly applying the paper's reduction rules (Fig. 3) with real effects:

* an (EXEC) transition runs the registered step function (once, on the
  lexicographically-first location of ``M(s)`` — the *leader*) and stores the
  produced payloads on **every** location of ``M(s)``, exactly like the rule
  adds ``Out^D(s)`` to every ``D_i``;
* a (COMM)/(L-COMM) transition copies the payload from source to destination.

Because the runtime state is always a *reachable workflow system* (Def. 13),
a checkpoint is simply ``dumps(state)`` + the payload store — the SWIRL term
is its own program counter.  Restart re-parses the term and resumes reduction;
in-flight steps at crash time are re-executed, which is sound because steps
are pure (the RDD-lineage argument).

Enabled exec transitions run concurrently on a thread pool (Church–Rosser,
Lemma 1, guarantees any completion order converges), with per-step retry and
straggler speculation from :mod:`repro_torch.workflow.fault`.
"""

from __future__ import annotations

import pickle
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

from repro_torch.core.parser import dumps, loads
from repro_torch.core.semantics import (
    CommTransition,
    ExecTransition,
    enabled_transitions,
)
from repro_torch.core.semantics import apply_transition
from repro_torch.core.syntax import Exec, WorkflowSystem
from .fault import HeartbeatMonitor, RetryPolicy, SpeculationPolicy

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


class Runtime:
    """Reduction-driven executor with fault tolerance.

    Parameters
    ----------
    system:
        The (optimised) workflow system to execute.
    step_fns:
        ``step name -> pure function`` registry.
    expected_s:
        Optional per-step expected durations for straggler speculation.
    initial_payloads:
        Payloads for the data elements already resident per location
        (must cover each location's ``D`` set).
    """

    def __init__(
        self,
        system: WorkflowSystem,
        step_fns: Mapping[str, StepFn],
        *,
        initial_payloads: Mapping[PayloadKey, Any] | None = None,
        expected_s: Mapping[str, float] | None = None,
        retry: RetryPolicy | None = None,
        speculation: SpeculationPolicy | None = None,
        max_workers: int = 8,
        checkpoint_every: int = 0,
        checkpoint_path: str | Path | None = None,
        heartbeat: HeartbeatMonitor | None = None,
    ):
        from repro_torch._compat import warn_legacy

        warn_legacy(
            "constructing repro_torch.workflow.Runtime directly",
            'swirl.trace(...).lower("inprocess").compile(step_fns)',
        )
        self.state = system
        self.step_fns = dict(step_fns)
        self.payloads: dict[PayloadKey, Any] = dict(initial_payloads or {})
        self.expected_s = dict(expected_s or {})
        self.retry = retry or RetryPolicy()
        self.speculation = speculation or SpeculationPolicy(enabled=False)
        self.max_workers = max_workers
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        self.heartbeat = heartbeat or HeartbeatMonitor(timeout_s=60.0)
        self.stats = RunStats()
        self.completed_execs: set[str] = set()
        self._lock = threading.Lock()
        # Validate coverage: every exec action must have a registered fn.
        from repro_torch.core.syntax import actions

        for cfg in system.configs:
            for a in actions(cfg.trace):
                if isinstance(a, Exec) and a.step not in self.step_fns:
                    raise KeyError(f"no step function registered for {a.step!r}")
            self.heartbeat.register(cfg.location)

    # -- checkpointing -------------------------------------------------------
    def checkpoint(self) -> Checkpoint:
        with self._lock:
            return Checkpoint(
                system_text=dumps(self.state),
                payloads=dict(self.payloads),
                completed_execs=frozenset(self.completed_execs),
            )

    @classmethod
    def restore(
        cls, ckpt: Checkpoint, step_fns: Mapping[str, StepFn], **kwargs
    ) -> "Runtime":
        rt = cls(ckpt.system, step_fns, initial_payloads=ckpt.payloads, **kwargs)
        rt.completed_execs = set(ckpt.completed_execs)
        return rt

    # -- effects -------------------------------------------------------------
    def _run_exec(self, act: Exec, pool: ThreadPoolExecutor) -> dict[str, Any]:
        """Run the step function for one exec action; returns its outputs."""
        leader = sorted(act.locations)[0]
        inputs = {d: self.payloads[(leader, d)] for d in sorted(act.inputs)}
        fn = self.step_fns[act.step]

        def attempt() -> Mapping[str, Any]:
            return fn(inputs)

        def with_retry() -> Mapping[str, Any]:
            return self.retry.run(
                attempt, on_retry=lambda n, e: self._count_retry()
            )

        t0 = time.monotonic()
        out, speculated = self.speculation.run(
            with_retry, self.expected_s.get(act.step), pool
        )
        dt = time.monotonic() - t0
        if speculated:
            with self._lock:
                self.stats.speculations += 1
        missing = act.outputs - set(out)
        if missing:
            raise RuntimeError(
                f"step {act.step!r} did not produce outputs {sorted(missing)}"
            )
        with self._lock:
            self.stats.exec_log.append((act.step, leader, dt))
        for l in act.locations:
            self.heartbeat.beat(l)
        return {d: out[d] for d in act.outputs}

    def _apply_exec(self, act: Exec, outputs: dict[str, Any]) -> None:
        """Apply the (EXEC) reduction for ``act`` to the current state."""
        with self._lock:
            for t in enabled_transitions(self.state):
                if isinstance(t, ExecTransition) and t.action == act:
                    self.state = apply_transition(self.state, t)
                    for l in act.locations:
                        for d, v in outputs.items():
                            self.payloads[(l, d)] = v
                    self.stats.execs += 1
                    self.completed_execs.add(act.step)
                    return
            raise RuntimeError(
                f"exec {act.pretty()} no longer enabled — state diverged"
            )

    def _apply_comms(self) -> int:
        """Apply every currently enabled communication, one at a time."""
        n = 0
        while True:
            with self._lock:
                comm = next(
                    (
                        t
                        for t in enabled_transitions(self.state)
                        if isinstance(t, CommTransition)
                    ),
                    None,
                )
                if comm is None:
                    return n
                s = comm.send
                self.state = apply_transition(self.state, comm)
                self.payloads[(s.dst, s.data)] = self.payloads[(s.src, s.data)]
                self.stats.comms += 1
                n += 1

    def _count_retry(self) -> None:
        with self._lock:
            self.stats.retries += 1

    # -- main loop -----------------------------------------------------------
    def run(self, *, max_rounds: int = 1_000_000) -> RunStats:
        t_start = time.monotonic()
        since_ckpt = 0
        pool = ThreadPoolExecutor(max_workers=self.max_workers)
        try:
            inflight: dict[Exec, Future] = {}
            for _ in range(max_rounds):
                progressed = self._apply_comms() > 0

                # Submit every enabled exec that is not already running.
                with self._lock:
                    enabled = [
                        t
                        for t in enabled_transitions(self.state)
                        if isinstance(t, ExecTransition)
                    ]
                for t in enabled:
                    if t.action not in inflight:
                        inflight[t.action] = pool.submit(
                            self._run_exec, t.action, pool
                        )
                        progressed = True

                if not inflight:
                    if progressed:
                        continue
                    break  # terminated or deadlocked

                done, _ = wait(
                    list(inflight.values()), return_when=FIRST_COMPLETED
                )
                for act in [a for a, f in inflight.items() if f in done]:
                    fut = inflight.pop(act)
                    self._apply_exec(act, fut.result())
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
        if not self.state.is_terminated():
            raise WorkflowDeadlock(
                "workflow did not terminate; remaining system:\n"
                + self.state.pretty()
            )
        return self.stats

    # -- results -------------------------------------------------------------
    def payload(self, location: str, data: str) -> Any:
        return self.payloads[(location, data)]

    def location_data(self, location: str) -> dict[str, Any]:
        return {
            d: v for (l, d), v in self.payloads.items() if l == location
        }
