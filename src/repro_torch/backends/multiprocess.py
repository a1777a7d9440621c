"""``multiprocess`` backend — one OS process per SWIRL location (group).

A copy of ``repro/backends/multiprocess.py``.  It differs from the
reference's in one point besides imports and docstrings: payloads cross
process boundaries framed with plain pickle, as the transports frame
theirs.  ``import torch`` registers tensor reductions with
multiprocessing's ``ForkingPickler``, which ``Connection.send`` and a
spawned process's arguments use: a CPU tensor would go by file-descriptor
passing and a CUDA tensor by CUDA IPC.  Both need the sending process alive
while the receiver holds the tensor (a worker exits right after its
``done``), and CUDA IPC is refused outright for memory from expandable
segments on a kernel without ``pidfd_open``.  So the control messages a
worker sends its coordinator go through :func:`_send_msg` /
:func:`_recv_msg` (in parts when long, as the socket wire's frames), and
the step bodies, initial payloads and recorded
outputs in a pickled worker configuration (spawn, forkserver) through
:class:`_HostFramed`.  A CUDA tensor (a payload, or one a step body holds)
then goes through the host and is rebuilt on its device at the receiver.

This is the paper's deployment model made real inside one machine: every
location's lowered program (:class:`~repro_torch.exec.program.LocationProgram` —
the self-contained, picklable op array shipped to the worker) runs in its
*own operating-system process* and
COMM messages cross a genuine transport boundary (the ``socket`` transport
of :mod:`repro_torch.workflow.transport` — ``multiprocessing.connection`` sockets
with pickle framing, per-message acks, and resend on ack timeout).  There
is no shared memory between locations: everything a location learns, it
learns through its trace's recvs, exactly like the generated TCP bundles.

Topology
--------
A lightweight coordinator (the calling process) spawns one worker process
per *location group* and never touches payload routing — data flows
worker-to-worker.  Groups exist for two reasons:

* **spatial constraints** — a step with ``|M(s)| > 1`` synchronises through
  an in-process exec barrier, so its locations must share a process;
* **schedule pinning** — when a :class:`repro_torch.sched.ScheduleReport` is
  handed down (``Plan.lower(..., placement="auto")``), locations in the
  same network group are pinned to the same worker process, mirroring the
  cost model's "cheap intra-rack links" assumption; an explicit
  ``workers=N`` option additionally packs groups onto ``N`` processes.

Fault surface
-------------
A worker that raises or dies (``SIGKILL`` included) is surfaced as a typed
:class:`WorkerFailedError` carrying the failed location and the step it was
executing; all sibling workers are torn down before the error propagates,
so no orphan processes remain.

Checkpointing
-------------
Workers stream per-step output deltas to the coordinator, which merges them
into a global payload store; :meth:`MultiprocessProgram.checkpoint` snapshots
that store as a standard :class:`repro_torch.workflow.runtime.Checkpoint` (the
store is consistent mid-run because SWIRL payloads are immutable and the
completed-exec set only grows).  ``restore`` seeds the next run with the
snapshot: completed steps replay their recorded outputs instead of
re-executing, and the at-least-once transport makes the replayed sends
harmless.

Requirements: the default start method is ``fork`` (closures and lambdas
work as step functions); with ``start_method="spawn"`` every step function
and payload must be picklable.  A forked child cannot use a CUDA context its
parent has initialised, so on the card step bodies that touch CUDA need
``start_method="spawn"``; a forked worker that touches CUDA fails its step,
and the run raises :class:`WorkerFailedError` naming the location and step.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import signal
import tempfile
import threading
import time
import warnings
from dataclasses import replace
from types import SimpleNamespace
from typing import Any, Mapping, Sequence

from repro_torch.core.compile import StepMeta
from repro_torch.core.parser import dumps
from repro_torch.core.syntax import Exec, WorkflowSystem, actions
from repro_torch.exec.program import ExecProgram, LocationProgram

from .base import Backend, BackendProgram, ExecutionResult, PayloadKey

DEFAULT_TIMEOUT_S = 120.0


class WorkerFailedError(RuntimeError):
    """A worker process crashed or raised while executing its locations.

    ``location`` names the failed location, ``step`` the step it was
    executing when it died (``None`` if it failed outside a step, e.g.
    while waiting on a recv).
    """

    def __init__(
        self,
        location: str | None,
        step: str | None = None,
        *,
        worker_id: int | None = None,
        exitcode: int | None = None,
        reason: str = "",
    ):
        self.location = location
        self.step = step
        self.worker_id = worker_id
        self.exitcode = exitcode
        self.reason = reason
        at = f" in step {step!r}" if step else ""
        why = reason or (
            f"killed (exit code {exitcode})"
            if exitcode is not None
            else "crashed"
        )
        super().__init__(
            f"worker for location {location!r} failed{at}: {why}"
        )


# ---------------------------------------------------------------------------
# Location → worker-process assignment
# ---------------------------------------------------------------------------


def assign_workers(
    system: ExecProgram | WorkflowSystem,
    *,
    workers: int | None = None,
    schedule: Any = None,
) -> list[tuple[str, ...]]:
    """Group locations into worker processes (deterministically).

    Locations sharing a spatially-constrained step (``|M(s)| > 1``) are
    always co-resident (the exec barrier is in-process).  When a
    ``ScheduleReport`` is given, locations in the same network group are
    pinned together.  ``workers=N`` then packs the groups onto ``N``
    processes, largest-first onto the least-loaded process.

    Accepts the lowered :class:`~repro_torch.exec.program.ExecProgram` (the
    backend path, read straight off the op arrays) or a bare
    :class:`WorkflowSystem` (legacy callers).
    """
    if isinstance(system, ExecProgram):
        locs = sorted(system.locations())
        spatial = [
            tuple(sorted(ls))
            for ls in system.placement().values()
            if len(ls) > 1
        ]
    else:
        locs = sorted(system.locations())
        spatial = [
            tuple(sorted(a.locations))
            for cfg in system.configs
            for a in actions(cfg.trace)
            if isinstance(a, Exec) and len(a.locations) > 1
        ]
    parent = {l: l for l in locs}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: str, b: str) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            # Deterministic root: keep the lexicographically smaller.
            lo, hi = sorted((ra, rb))
            parent[hi] = lo

    for group in spatial:
        first, *rest = group
        for other in rest:
            union(first, other)

    network = getattr(schedule, "network", None)
    if network is not None:
        by_group: dict[str, list[str]] = {}
        for l in locs:
            g = network.group_of(l)
            if g is not None:
                by_group.setdefault(g, []).append(l)
        for members in by_group.values():
            first, *rest = members
            for other in rest:
                union(first, other)

    units: dict[str, list[str]] = {}
    for l in locs:
        units.setdefault(find(l), []).append(l)
    groups = sorted(tuple(sorted(v)) for v in units.values())
    if workers is None or workers >= len(groups):
        return groups
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    bins: list[list[str]] = [[] for _ in range(workers)]
    sizes = [0] * workers
    for unit in sorted(groups, key=lambda u: (-len(u), u)):
        i = min(range(workers), key=lambda j: (sizes[j], j))
        bins[i].extend(unit)
        sizes[i] += len(unit)
    return sorted(tuple(sorted(b)) for b in bins if b)


def _recorded_outputs(program: ExecProgram, ckpt: Any) -> dict[str, dict]:
    """Per-step output payloads recoverable from a checkpoint's store."""
    recorded: dict[str, dict] = {}
    payloads: Mapping[PayloadKey, Any] = ckpt.payloads
    for lp in program.programs:
        for op in lp.exec_ops():
            if op.step in recorded:
                continue
            if op.step not in ckpt.completed_execs:
                continue
            out, missing = {}, False
            for d in op.outputs:
                for l in sorted(op.locations):
                    if (l, d) in payloads:
                        out[d] = payloads[(l, d)]
                        break
                else:
                    # The datum may only survive where a comm moved it.
                    hit = next(
                        (v for (l, dd), v in payloads.items() if dd == d),
                        _MISSING,
                    )
                    if hit is _MISSING:
                        missing = True
                        break
                    out[d] = hit
            if not missing:
                recorded[op.step] = out
    return recorded


_MISSING = object()


def _send_msg(conn, msg: tuple) -> None:
    """Send one worker control message, framed with plain pickle (see the
    module doc: never ``ForkingPickler``'s tensor reductions) as the
    socket wire frames its messages, in parts when it is long."""
    from repro_torch.workflow.transport import send_pickled

    send_pickled(conn, pickle.dumps(msg, pickle.HIGHEST_PROTOCOL))


def _recv_msg(conn) -> tuple:
    """Receive one control message sent by :func:`_send_msg`."""
    from repro_torch.workflow.transport import recv_pickled

    return recv_pickled(conn)


class _HostFramed:
    """Step bodies or payloads of a worker configuration that
    multiprocessing pickles (spawn, forkserver), as plain-pickle bytes (see
    the module doc).  The worker loads them in :func:`_worker_main`, not
    while multiprocessing unpickles the configuration: the coordinator
    writes it to each new process in turn and waits until the process has
    read it, so loading there (importing torch, making a CUDA context)
    would start the workers one at a time."""

    def __init__(self, mapping: Mapping):
        self.frame = pickle.dumps(mapping, pickle.HIGHEST_PROTOCOL)

    def load(self) -> Mapping:
        return pickle.loads(self.frame)


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _worker_main(cfg: dict) -> None:
    """Entry point of one worker: run my locations' bundles to completion.

    Control-plane protocol (worker → coordinator over the duplex pipe):
    ``("ready", wid, pid, monotonic)`` → *waits for* ``("go",)`` → then any
    number of ``("exec", wid, loc, step)`` / ``("delta", loc, step,
    outputs)`` / ``("spans", wid, events)`` / finally one of
    ``("done", wid, data)`` or ``("error", wid, loc, step, reason)``.

    The worker's ``time.monotonic()`` rides on the ready message so the
    coordinator can align span timestamps recorded on this process's
    clock (workers record absolute monotonic time via ``t_zero=0.0``);
    span batches are flushed incrementally — before each step body and
    before done/error — so a SIGKILLed worker's earlier spans survive up
    to the last coordinator merge.
    """
    ctl = cfg["ctl"]
    wid = cfg["worker_id"]
    transport = None
    ctl_lock = threading.Lock()

    def tell(msg: tuple) -> None:
        with ctl_lock:
            try:
                _send_msg(ctl, msg)
            except (OSError, BrokenPipeError, ValueError):
                pass  # coordinator is gone; nothing left to report to

    # Uniform fault policy: per-step retry + timeout run *inside* the
    # control-protocol wrapper, around the raw step body — a retried
    # transient failure must never reach the coordinator as an "error"
    # (which would tear the fleet down before the retry could succeed).
    # Each policy outcome is reported upstream so the coordinator can
    # count it; the messages double as progress heartbeats.
    policy = cfg.get("policy")
    guard = None
    if policy is not None and (
        policy.max_retries or policy.timeout_s is not None
    ):
        from repro_torch.exec.interp import StepGuard

        guard = StepGuard(
            policy,
            on_retry=lambda step, n, e: tell(("retry", wid, step)),
            on_timeout=lambda step: tell(("step_timeout", wid, step)),
        )

    recorder = None
    if cfg.get("trace"):
        from repro_torch.obs.events import TraceRecorder

        recorder = TraceRecorder(t_zero=0.0)

    def flush_spans() -> None:
        if recorder is not None and len(recorder):
            tell(("spans", wid, recorder.drain()))

    try:
        from repro_torch.workflow.threaded import ThreadedProgramRuntime
        from repro_torch.workflow.transport import HybridTransport, get_transport

        for key in ("steps", "initial", "recorded"):
            if isinstance(cfg[key], _HostFramed):
                cfg[key] = cfg[key].load()
        transport_cls = get_transport(cfg["transport"])
        transport = transport_cls(
            cfg["addresses"],
            serve=cfg["locations"],
            authkey=cfg["authkey"],
            ack_timeout=cfg["ack_timeout"],
            connect_timeout=cfg["timeout_s"],
        )
        if len(cfg["locations"]) > 1:
            # Co-resident locations (schedule pinning / workers= packing)
            # talk in memory instead of through socket loopback.
            transport = HybridTransport(transport, cfg["locations"])
        tell(("ready", wid, os.getpid(), time.monotonic()))
        if ctl.recv() != ("go",):  # coordinator aborted startup
            return

        programs: Mapping[str, LocationProgram] = cfg["programs"]
        metas: Mapping[str, StepMeta] = cfg["steps"]
        completed: frozenset[str] = cfg["completed"]
        recorded: Mapping[str, dict] = cfg["recorded"]
        kill_at = cfg.get("kill_at_step")
        current: dict[str, str] = {}

        def wrap(loc: str, step: str, fn):
            def run(inputs, _loc=loc, _step=step, _fn=fn):
                current[_loc] = _step
                flush_spans()  # ship earlier ops' spans before this step
                tell(("exec", wid, _loc, _step))
                if kill_at is not None and _step == kill_at:
                    os.kill(os.getpid(), signal.SIGKILL)  # fault injection
                if _step in completed and _step in recorded:
                    out = dict(recorded[_step])  # resume: replay, don't redo
                else:
                    try:
                        if guard is not None:
                            out = dict(
                                guard.fire(_step, lambda: _fn(inputs))
                            )
                        else:
                            out = dict(_fn(inputs))
                    except BaseException as e:  # noqa: BLE001
                        tell(
                            (
                                "error",
                                wid,
                                _loc,
                                _step,
                                f"{type(e).__name__}: {e}",
                            )
                        )
                        raise
                tell(("delta", _loc, _step, dict(out)))
                current.pop(_loc, None)
                return out

            return run

        local_steps = {
            loc: {
                s: replace(metas[s], fn=wrap(loc, s, metas[s].fn))
                for s in lp.exec_step_names()
            }
            for loc, lp in programs.items()
        }
        init = {
            (l, d): v
            for (l, d), v in cfg["initial"].items()
            if l in programs
        }
        rt = ThreadedProgramRuntime(
            programs,
            local_steps,
            initial_payloads=init,
            transport=transport,
            timeout_s=cfg["timeout_s"],
            recorder=recorder,
        )
        try:
            data = rt.run()
        except BaseException as e:  # noqa: BLE001
            loc, err = (rt.errors or [(cfg["locations"][0], e)])[0]
            flush_spans()
            tell(
                (
                    "error",
                    wid,
                    loc,
                    current.get(loc),
                    f"{type(err).__name__}: {err}",
                )
            )
            return
        flush_spans()
        tell(("done", wid, {l: dict(d) for l, d in data.items()}))
    except BaseException as e:  # noqa: BLE001
        loc = cfg["locations"][0] if cfg["locations"] else None
        tell(("error", wid, loc, None, f"{type(e).__name__}: {e}"))
    finally:
        if transport is not None:
            transport.close()


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


class MultiprocessProgram(BackendProgram):
    # un-annotated → plain class attributes, not dataclass fields
    _store = None  # merged (location, datum) -> payload
    _completed = None  # set of completed step names
    _pending_ckpt = None
    #: ``(attempt, worker id) -> OS pid`` across every fleet the last run
    #: spawned (one entry per worker per recovery attempt; never mutated).
    last_pids = {}
    #: RunProfile of the last traced run — set even when the run raised
    #: (e.g. a SIGKILLed worker), holding every span merged before the
    #: failure.  ``None`` when the last run was untraced.
    last_profile = None

    def _run_instance(
        self,
        initial_payloads: Mapping[PayloadKey, Any] | None,
        instance_tag: str,
    ) -> ExecutionResult:
        # run() spawns a full worker-process fleet and mutates the shared
        # snapshot state (_pending_ckpt swap, _store/_completed) — batch
        # instances are serialised rather than racing a process fleet per
        # pool thread.  run_many still amortises lowering/compilation.
        lock = self.__dict__.setdefault("_instance_lock", threading.Lock())
        with lock:
            return self.run(initial_payloads)

    def run(
        self, initial_payloads: Mapping[PayloadKey, Any] | None = None
    ) -> ExecutionResult:
        from repro_torch.workflow.transport import get_transport

        opts = dict(self.options)
        schedule = opts.pop("schedule", None)
        workers = opts.pop("workers", None)
        zero_copy = bool(opts.pop("zero_copy", False))
        transport_name = opts.pop("transport", None)
        if transport_name is None:
            transport_name = "shm" if zero_copy else "socket"
        elif zero_copy and transport_name != "shm":
            raise ValueError(
                f"zero_copy=True requires the shared-memory transport; "
                f"got transport={transport_name!r}"
            )
        start_method = opts.pop("start_method", None)
        timeout_s = float(opts.pop("timeout_s", DEFAULT_TIMEOUT_S))
        ack_timeout = float(opts.pop("ack_timeout", 1.0))
        kill_at = opts.pop("_kill_at_step", None)
        tracing = bool(opts.pop("trace", False))
        policy = opts.pop("policy", None)
        recover = str(opts.pop("recover", "off"))
        if recover not in ("off", "spare", "fold"):
            raise ValueError(
                f'recover must be "off", "spare" or "fold", got {recover!r}'
            )
        spares = list(opts.pop("spares", ()) or ())
        max_recoveries = int(opts.pop("max_recoveries", 8))
        recorder = None
        offsets: dict[int, float] = {}  # wid -> additive clock shift
        if tracing:
            from repro_torch.obs.events import TraceRecorder

            recorder = TraceRecorder()
        self.last_profile = None

        transport_cls = get_transport(transport_name)
        if not getattr(transport_cls, "crosses_processes", False):
            raise ValueError(
                f"transport {transport_name!r} cannot cross process "
                "boundaries; the multiprocess backend needs one that can "
                '(e.g. "socket")'
            )
        if start_method is None:
            start_method = (
                "fork"
                if "fork" in mp.get_all_start_methods()
                else "spawn"
            )

        completed: set[str] = set()
        recorded: dict[str, dict] = {}
        store: dict[PayloadKey, Any] = {}
        if self._pending_ckpt is not None:
            ckpt, self._pending_ckpt = self._pending_ckpt, None
            store.update(ckpt.payloads)
            completed |= set(ckpt.completed_execs)
            recorded = _recorded_outputs(self.program, ckpt)
        if initial_payloads:
            store.update(initial_payloads)
        self._store, self._completed = store, completed

        from repro_torch.exec.interp import Deadline

        ctx = mp.get_context(start_method)
        program = self.program
        recoveries: list[dict] = []
        all_pids: dict[tuple[int, int], int] = {}
        fatal: tuple | None = None
        attempt = 0
        deadline = Deadline(
            policy.deadline_s if policy is not None else None
        )
        policy_counts = {"retries": 0, "timeouts": 0, "heartbeat_deaths": 0}
        while True:
            groups = assign_workers(
                program,
                workers=workers,
                # A stale schedule speaks pre-rename location names; its
                # network pinning only applies to the fleet it planned.
                schedule=schedule if attempt == 0 else None,
            )
            hb_before = policy_counts["heartbeat_deaths"]
            rem = deadline.remaining()
            failure, finals, pids = self._attempt(
                program,
                store,
                completed,
                recorded,
                groups=groups,
                ctx=ctx,
                transport_name=transport_name,
                timeout_s=(
                    timeout_s if rem is None
                    else max(min(timeout_s, rem), 0.01)
                ),
                ack_timeout=ack_timeout,
                kill_at=kill_at,
                tracing=tracing,
                recorder=recorder,
                offsets=offsets,
                policy=policy,
                policy_counts=policy_counts,
            )
            for wid, pid in pids.items():
                all_pids[(attempt, wid)] = pid
            self.last_pids = dict(all_pids)
            if failure is None:
                break
            if failure[0] == "timeout" and deadline.expired():
                deadline.check()  # the run deadline, not the step timeout
            # Only process *death* is recoverable — a deterministic step
            # exception ("error") would just re-raise on the replacement,
            # and a timeout already tore the whole fleet down.
            if (
                failure[0] != "crash"
                or recover == "off"
                or len(recoveries) >= max_recoveries
            ):
                fatal = failure
                break
            t0 = time.monotonic()
            wid = failure[1]
            dead = sorted(groups[wid])
            live = [
                l for l in program.locations() if l not in set(dead)
            ]
            from repro_torch.exec.elastic import rename_program, resimulate
            from repro_torch.workflow.elastic import fold_payloads, plan_recovery

            try:
                ren = plan_recovery(
                    live, dead, spares if recover == "spare" else []
                )
            except RuntimeError:
                fatal = failure  # nothing to recover onto
                break
            spares = [s for s in spares if s not in set(ren.values())]
            program = rename_program(program, ren)
            store = fold_payloads(store, ren)
            # The resume point: everything the coordinator merged before
            # the crash, folded under the substitution.  Completed steps
            # replay these recorded outputs — their bodies never re-run.
            resume = SimpleNamespace(
                payloads=store, completed_execs=frozenset(completed)
            )
            recorded = _recorded_outputs(program, resume)
            self._store = store
            kill_at = None  # the injected fault fires once
            event = {
                "attempt": len(recoveries) + 1,
                "mode": recover,
                "worker_id": wid,
                "failed_step": failure[3],
                "dead": list(dead),
                "renaming": dict(ren),
                "completed_steps": len(completed),
            }
            if policy_counts["heartbeat_deaths"] > hb_before:
                # The worker was not SIGKILLed from outside — the policy's
                # progress heartbeat declared the straggler dead.
                event["declared_by"] = "heartbeat"
            if schedule is not None:
                try:
                    event["predicted_makespan_s"] = resimulate(
                        program
                    ).makespan
                except Exception:  # noqa: BLE001 - prediction is best-effort
                    pass
            recoveries.append(event)
            if recorder is not None:
                t1 = time.monotonic()
                for d in dead:
                    recorder.span(
                        "phase",
                        ren[d],
                        f"recover:{recover}",
                        t0,
                        t1,
                        src=d,
                        dst=ren[d],
                    )
            attempt += 1

        profile = None
        if recorder is not None:
            from repro_torch.obs.profile import RunProfile

            profile = RunProfile.from_recorder("multiprocess", recorder)
            # Survives even a failed run: everything merged before the
            # worker died is inspectable post-mortem.
            self.last_profile = profile

        if fatal is not None:
            if fatal[0] == "timeout":
                raise TimeoutError(
                    f"multiprocess run exceeded {timeout_s}s; "
                    "workers terminated"
                )
            kind, wid, loc, step, info = fatal
            raise WorkerFailedError(
                loc,
                step,
                worker_id=wid,
                exitcode=info if kind == "crash" else None,
                reason=info if kind == "error" else "",
            )

        data: dict[str, dict[str, Any]] = {
            loc: {} for loc in program.locations()
        }
        for wid in sorted(finals):
            for loc, local in finals[wid].items():
                data[loc].update(local)
                for d, v in local.items():
                    store[(loc, d)] = v
        stats = {
            "workers": len(groups),
            "groups": {i: list(g) for i, g in enumerate(groups)},
            "pids": dict(pids),
            "transport": transport_name,
            "start_method": start_method,
            "recoveries": recoveries,
        }
        if policy is not None:
            stats["policy"] = dict(policy_counts)
        return ExecutionResult(
            backend="multiprocess",
            data=data,
            stats=stats,
            profile=profile,
        )

    def _attempt(
        self,
        program: ExecProgram,
        store: dict[PayloadKey, Any],
        completed: set[str],
        recorded: Mapping[str, dict],
        *,
        groups: list[tuple[str, ...]],
        ctx,
        transport_name: str,
        timeout_s: float,
        ack_timeout: float,
        kill_at: str | None,
        tracing: bool,
        recorder,
        offsets: dict[int, float],
        policy=None,
        policy_counts: dict[str, int] | None = None,
    ) -> tuple[tuple | None, dict, dict[int, int]]:
        """Spawn one worker fleet for ``program`` and drive it to done/fail.

        Each attempt binds a *fresh* set of transport endpoints (its own
        socket directory + authkey) — after a recovery renaming this is
        what rebinds the renamed locations' channels; ``HybridTransport``
        pinning for co-resident groups happens inside the workers.
        Mutates ``store``/``completed`` in place as deltas arrive (the
        coordinator-merged checkpoint the recovery path resumes from) and
        returns ``(failure, finals, pids)`` with every worker torn down.
        """
        from multiprocessing import connection as mpc

        from repro_torch.workflow.transport import get_transport, socket_addresses

        tmpdir = tempfile.mkdtemp(prefix="swirl-mp-")
        addresses = socket_addresses(program.locations(), base_dir=tmpdir)
        authkey = os.urandom(16)

        procs: list = []
        parent_conns: list = []
        pids: dict[int, int] = {}
        last_exec: dict[int, tuple[str, str]] = {}
        finals: dict[int, dict[str, dict[str, Any]]] = {}
        failure: tuple | None = None
        counts = policy_counts if policy_counts is not None else {}
        #: Progress heartbeat: every control message from a worker is a
        #: beat.  A worker *inside a step* (an un-matched "exec") that
        #: stays silent past the policy's heartbeat deadline is a
        #: straggler — declared dead below, which maps it onto the same
        #: ("crash", ...) path a SIGKILL takes, so elastic recovery fires
        #: without waiting for the process to actually die.
        hb_timeout = (
            policy.heartbeat_timeout_s if policy is not None else None
        )
        last_progress: dict[int, float] = {}

        def handle(msg: tuple, wid: int) -> tuple | None:
            """Apply one worker message; return a failure record or None."""
            nonlocal started
            last_progress[wid] = time.monotonic()
            kind = msg[0]
            if kind == "retry":
                counts["retries"] = counts.get("retries", 0) + 1
                if recorder is not None:
                    t = time.monotonic()
                    recorder.add(
                        ("policy", groups[wid][0], f"retry:{msg[2]}",
                         t, t, None, None, None, None)
                    )
                return None
            if kind == "step_timeout":
                counts["timeouts"] = counts.get("timeouts", 0) + 1
                return None
            if kind == "ready":
                ready.add(wid)
                pids[wid] = msg[2]
                if recorder is not None and len(msg) > 3:
                    # Clock alignment piggybacked on the handshake: the
                    # worker's monotonic instant maps to "now" here, so a
                    # worker-absolute span time t lands on this recorder's
                    # clock at t + offset.
                    offsets[wid] = (
                        time.monotonic() - msg[3] - recorder.t_zero
                    )
                if not started and len(ready) == len(procs):
                    started = True
                    for c in list(live_conns):
                        try:
                            c.send(("go",))
                        except (OSError, BrokenPipeError):
                            pass
            elif kind == "exec":
                last_exec[wid] = (msg[2], msg[3])
            elif kind == "delta":
                _, loc, step, out = msg
                for d, v in out.items():
                    store[(loc, d)] = v
                completed.add(step)
                if last_exec.get(wid) == (loc, step):
                    # The step finished — a later crash while e.g. blocked
                    # on a recv must not be pinned on it (step=None then).
                    del last_exec[wid]
            elif kind == "spans":
                if recorder is not None:
                    recorder.absorb(msg[2], offset=offsets.get(wid, 0.0))
            elif kind == "done":
                finals[wid] = msg[2]
                pending.discard(wid)
            elif kind == "error":
                return ("error", wid, msg[2], msg[3], msg[4])
            return None

        def drain(conn, wid: int) -> tuple | None:
            """Consume every buffered message on one control pipe."""
            first_failure = None
            while True:
                try:
                    if not conn.poll(0):
                        break
                    msg = _recv_msg(conn)
                except (EOFError, OSError):
                    live_conns.pop(conn, None)
                    break
                err = handle(msg, wid)
                if err is not None and first_failure is None:
                    first_failure = err
            return first_failure

        # A forked worker inherits its configuration; any other start
        # method pickles it, and then the step bodies and payloads go as
        # plain pickle.
        framed = _HostFramed if ctx.get_start_method() != "fork" else dict
        try:
            for wid, group in enumerate(groups):
                parent, child = ctx.Pipe()
                cfg = dict(
                    worker_id=wid,
                    locations=group,
                    programs={loc: program[loc] for loc in group},
                    steps=framed(self.steps),
                    addresses=addresses,
                    authkey=authkey,
                    transport=transport_name,
                    ctl=child,
                    initial=framed({
                        k: v for k, v in store.items() if k[0] in group
                    }),
                    completed=frozenset(completed),
                    recorded=framed(recorded),
                    timeout_s=timeout_s,
                    ack_timeout=ack_timeout,
                    kill_at_step=kill_at,
                    trace=tracing,
                    policy=policy,
                )
                proc = ctx.Process(
                    target=_worker_main,
                    args=(cfg,),
                    name=f"swirl-worker-{wid}",
                    daemon=True,
                )
                with warnings.catch_warnings():
                    # Forking a process that runs threads (torch's pools,
                    # the caller's) warns; a forked worker runs the step
                    # bodies it was given, and one that touches CUDA fails
                    # (a forked child cannot use its parent's context).
                    warnings.simplefilter("ignore")
                    proc.start()
                child.close()
                procs.append(proc)
                parent_conns.append(parent)

            ready: set[int] = set()
            started = False
            pending = set(range(len(procs)))
            live_conns = {parent_conns[i]: i for i in range(len(procs))}
            sentinels = {procs[i].sentinel: i for i in range(len(procs))}
            deadline = time.monotonic() + timeout_s

            while pending and failure is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    failure = ("timeout",)
                    break
                wait_timeout = remaining
                if hb_timeout is not None:
                    # Wake often enough to notice a silent straggler well
                    # within one heartbeat window.
                    wait_timeout = min(remaining, max(hb_timeout / 4, 0.05))
                objs = list(live_conns) + [
                    procs[i].sentinel for i in pending
                ]
                for obj in mpc.wait(objs, timeout=wait_timeout):
                    if obj in live_conns:
                        wid = live_conns[obj]
                        try:
                            msg = _recv_msg(obj)
                        except (EOFError, OSError):
                            del live_conns[obj]
                            continue
                        failure = handle(msg, wid) or failure
                        if failure is not None:
                            break
                    else:
                        wid = sentinels.get(obj)
                        if wid is None or wid not in pending:
                            continue
                        # Harvest everything already in flight (deltas,
                        # done/error reports) before declaring a crash.
                        for conn in list(live_conns):
                            failure = (
                                failure or drain(conn, live_conns[conn])
                            )
                        if wid in pending and failure is None:
                            loc, step = last_exec.get(
                                wid, (groups[wid][0], None)
                            )
                            # The sentinel fires when the child exits, but
                            # the exit *code* is only available once the
                            # child is reaped — join first or a killed
                            # worker races to exitcode=None.
                            procs[wid].join(5)
                            failure = (
                                "crash",
                                wid,
                                loc,
                                step,
                                procs[wid].exitcode,
                            )
                        break
                if failure is None and hb_timeout is not None and started:
                    now = time.monotonic()
                    for wid in sorted(pending):
                        if wid not in last_exec:
                            # Blocked on a recv/barrier — waiting on a peer
                            # is not straggling; only a worker silent *inside
                            # a step* can be declared.
                            continue
                        if now - last_progress.get(wid, now) <= hb_timeout:
                            continue
                        loc, step = last_exec[wid]
                        counts["heartbeat_deaths"] = (
                            counts.get("heartbeat_deaths", 0) + 1
                        )
                        if recorder is not None:
                            recorder.add(
                                ("policy", loc,
                                 f"heartbeat_death:{step or '-'}",
                                 now, now, None, None, None, None)
                            )
                        # Declare the straggler dead: terminate it and
                        # surface the same ("crash", ...) record a real
                        # process death produces — the elastic recovery
                        # path (spare/fold) takes over from there.
                        procs[wid].terminate()
                        procs[wid].join(5)
                        if procs[wid].is_alive():
                            procs[wid].kill()
                            procs[wid].join(5)
                        failure = (
                            "crash", wid, loc, step, procs[wid].exitcode
                        )
                        break
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
            for proc in procs:
                proc.join(5)
                if proc.is_alive():
                    proc.kill()
                    proc.join(5)
            for conn in parent_conns:
                try:
                    conn.close()
                except OSError:
                    pass
            shutil.rmtree(tmpdir, ignore_errors=True)
            # A worker killed mid-send cannot reclaim its shared-memory
            # segments; the coordinator sweeps the attempt's namespace
            # (derived from this attempt's authkey) so a crashed fleet
            # never leaks /dev/shm entries.
            sweep = getattr(get_transport(transport_name), "sweep", None)
            if sweep is not None:
                sweep(authkey)
        return failure, finals, pids

    # -- checkpoint capability ----------------------------------------------

    def checkpoint(self):
        """Snapshot the coordinator's merged store (consistent mid-run)."""
        from repro_torch.workflow.runtime import Checkpoint

        return Checkpoint(
            system_text=dumps(self.system),
            payloads=dict(self._store or {}),
            completed_execs=frozenset(self._completed or ()),
        )

    def restore(self, ckpt) -> None:
        self._pending_ckpt = ckpt


class MultiprocessBackend(Backend):
    name = "multiprocess"
    capabilities = frozenset(
        {"checkpoint", "distributed", "fault-injection", "elastic-recovery"}
    )

    def known_options(self) -> frozenset[str]:
        return super().known_options() | frozenset(
            {
                "workers",
                "transport",
                "zero_copy",
                "start_method",
                "timeout_s",
                "ack_timeout",
                "_kill_at_step",
                "recover",
                "spares",
                "max_recoveries",
            }
        )

    def compile(
        self,
        program: ExecProgram | WorkflowSystem,
        steps: Mapping[str, StepMeta],
        options: Mapping[str, Any],
    ) -> MultiprocessProgram:
        return MultiprocessProgram(
            program=self.lower(program, options),
            steps=dict(steps),
            options=dict(options),
        )


def factory() -> Backend:
    return MultiprocessBackend()
