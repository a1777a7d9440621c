"""Decentralised threaded runtime — one thread per location, no orchestrator.

:class:`ThreadedProgramRuntime` executes per-location programs of the
execution IR (:mod:`repro_torch.exec.program`) the way the paper's generated TCP
programs do: every location interprets *only its own op array* against real
channels, with no shared scheduler state.  Spatial constraints (one step on
many locations) synchronise through per-exec barriers, matching the (EXEC)
rule's synchronised reduction.  An ``instance_tag`` namespaces every channel
endpoint, which is what lets :meth:`repro_torch.api.Executable.run_many` drive
many workflow instances through one shared transport concurrently.

This is the back-end used by the 1000 Genomes evaluation.  The historical
tree-walking interpreter (:class:`ThreadedRuntime`, over compiled
``LocationBundle``s) is kept verbatim as a deprecated reference oracle —
``tests/test_torch_threaded.py`` checks flat-program execution against it.

A copy of ``repro/workflow/threaded.py``.  It moves no payload: a step's
outputs are stored as the step returned them, so CUDA tensors stay on their
device and cross locations as the same objects.  Every location thread
launches on its current stream, the shared default one, so a tensor handed
to another location needs no event.  One point differs from the reference:
with a recorder, an exec span ends only after the device work behind the
step's tensor outputs is done (:func:`_settle_outputs`), as the ``torch``
backend's spans do; untraced runs never synchronise.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from time import monotonic as _mono
from typing import Any, Mapping

from repro_torch.core.compile import LocationBundle, StepMeta
from repro_torch.core.syntax import Exec, Nil, Par, Recv, Send, Seq, Trace
from repro_torch.exec.interp import (
    Cursor,
    Deadline,
    StepGuard,
    record_exec_fire,
    record_policy_fire,
    record_recv_fire,
    record_send_fire,
)
from repro_torch.exec.program import (
    K_ACT,
    K_PAR,
    K_SEQ,
    LocationProgram,
    RecvOp,
    SendOp,
)


from .channels import ChannelRegistry
from .transport import InMemoryTransport, Transport


class _BranchAborted(RuntimeError):
    """A Par branch gave up because a *sibling* poisoned the location.

    Never the root cause — error-reporting sites prefer any other
    exception over this one (see :func:`_first_real`).
    """


def _first_real(errs: list[BaseException]) -> BaseException:
    """The first non-:class:`_BranchAborted` error, else the first error."""
    for e in errs:
        if not isinstance(e, _BranchAborted):
            return e
    return errs[0]


def _settle_outputs(out: Mapping[str, Any], names) -> None:
    """Wait for the device work behind a traced step's tensor outputs.

    Each CUDA device that holds one of the outputs ``names`` is
    synchronised, so the exec span that ends next measures the work and not
    its enqueue.  On the shared stream this also waits for work that other
    locations queued before it.  Without torch imported no output can be a
    tensor, so the module imports none.
    """
    torch = sys.modules.get("torch")
    if torch is None:
        return
    devices = {
        v.device
        for d in names
        if isinstance(v := out.get(d), torch.Tensor) and v.device.type == "cuda"
    }
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)


def total_par_branches(programs: Mapping[str, "LocationProgram"]) -> int:
    """Static upper bound on concurrently-live parallel branches.

    The sum of every ``Par`` node's branch count across all location
    programs — what one in-flight instance can demand from a shared branch
    pool at worst (all pars active at once).  ``run_many`` sizes its pool
    as ``lanes × total_par_branches`` so pooled branches can never starve
    each other into deadlock.
    """
    n = 0
    for lp in programs.values():
        spec = lp.control()
        for nid, kind in enumerate(spec.kind):
            if kind == K_PAR:
                n += len(spec.children[nid])
    return n


@dataclass
class _ExecBarrier:
    """Synchronises one exec predicate across its ``M(s)`` locations.

    The first arriving location is the leader: it runs the step function and
    publishes the outputs; everyone waits on the event, then copies the
    outputs into their local data scope (Out^D(s) added to every D_i).
    """

    n: int
    outputs: dict[str, Any] = field(default_factory=dict)
    _arrived: int = 0
    _done: threading.Event = field(default_factory=threading.Event)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _leader_claimed: bool = False
    error: BaseException | None = None

    def arrive_and_maybe_lead(self) -> bool:
        with self._lock:
            lead = not self._leader_claimed
            self._leader_claimed = True
            self._arrived += 1
            return lead

    def publish(self, outputs: Mapping[str, Any]) -> None:
        self.outputs.update(outputs)
        self._done.set()

    def fail(self, e: BaseException) -> None:
        self.error = e
        self._done.set()

    def wait(self, timeout: float = 60.0) -> dict[str, Any]:
        if not self._done.wait(timeout):
            raise TimeoutError("exec barrier timed out")
        if self.error is not None:
            raise self.error
        return self.outputs


class ThreadedProgramRuntime:
    """Run one thread per location; each interprets only its own program.

    ``programs`` maps location → :class:`~repro_torch.exec.program.LocationProgram`
    and ``steps`` maps location → step name → :class:`StepMeta` (per-location
    registries so callers — e.g. the multiprocess worker — can wrap step
    bodies per location).  ``instance_tag`` suffixes every channel endpoint's
    port, isolating concurrent workflow instances on one shared transport.
    """

    def __init__(
        self,
        programs: Mapping[str, LocationProgram],
        steps: Mapping[str, Mapping[str, StepMeta]],
        *,
        initial_payloads: Mapping[tuple[str, str], Any] | None = None,
        transport: Transport | None = None,
        timeout_s: float = 60.0,
        instance_tag: str | None = None,
        branch_pool=None,
        validate: bool = True,
        recorder=None,
        policy=None,
    ):
        self.programs = dict(programs)
        self.steps = {loc: dict(metas) for loc, metas in steps.items()}
        if validate:
            for loc, lp in self.programs.items():
                local = self.steps.get(loc, {})
                for op in lp.exec_ops():
                    if op.step not in local:
                        raise KeyError(
                            f"no step function registered for {op.step!r}"
                        )
        #: Optional shared executor for parallel branches: run_many reuses
        #: one pool across the whole batch instead of spawning fresh threads
        #: per Par node per instance (the pool is sized by the static branch
        #: count so blocked branches can never starve each other).
        self._branch_pool = branch_pool
        self.recorder = recorder
        self.transport = transport or InMemoryTransport(ChannelRegistry())
        self.timeout_s = timeout_s
        self.instance_tag = instance_tag
        self._barriers: dict[tuple, _ExecBarrier] = {}
        self._barrier_lock = threading.Lock()
        self.data: dict[str, dict[str, Any]] = {
            loc: {} for loc in self.programs
        }
        # Per-location condition: writes notify; execs wait on In^D(s) ⊆ D_l
        # (the (EXEC) rule's premise — after optimisation a datum may arrive
        # via a *sibling* parallel branch's recv, so exec must block on it).
        self._cond: dict[str, threading.Condition] = {
            loc: threading.Condition() for loc in self.programs
        }
        #: A failed parallel branch poisons its location so sibling branches
        #: blocked in ``_wait_data`` or ``_recv`` abort at once instead of
        #: burning ``timeout_s`` — the location thread then reports the root
        #: cause promptly (and, under a fault policy, crash-recovery replay
        #: starts while the run-level join still has budget left).
        self._poison: dict[str, BaseException | None] = {
            loc: None for loc in self.programs
        }
        for (l, d), v in (initial_payloads or {}).items():
            if l in self.data:
                self.data[l][d] = v
        self.errors: list[tuple[str, BaseException]] = []
        #: Uniform FaultPolicy (repro_torch.exec.policy): a shared StepGuard wraps
        #: every step fire with timeout + retry, and a per-location op log
        #: (completed op indices, completion order) enables crash recovery —
        #: a died location thread is replayed from its cursor.  The log is
        #: only kept under a policy, so the policy-free hot path is unchanged.
        self.policy = policy
        self._guard: StepGuard | None = None
        self._op_log: dict[str, list[int]] | None = None
        self.recoveries: list[dict[str, Any]] = []
        if policy is not None:
            self._guard = StepGuard(
                policy,
                on_retry=lambda step, n, e: record_policy_fire(
                    self.recorder, "retry", "-", step, _mono(), _mono()
                ),
                on_timeout=lambda step: record_policy_fire(
                    self.recorder, "timeout", "-", step, _mono(), _mono()
                ),
            )
            self._op_log = {loc: [] for loc in self.programs}

    def _endpoint(self, op: SendOp | RecvOp) -> tuple[str, str, str]:
        if self.instance_tag is None:
            return op.endpoint
        return (op.src, op.dst, f"{op.port}#{self.instance_tag}")

    def _put_data(self, loc: str, items: Mapping[str, Any]) -> None:
        with self._cond[loc]:
            self.data[loc].update(items)
            self._cond[loc].notify_all()

    def _wait_data(self, loc: str, names) -> dict[str, Any]:
        with self._cond[loc]:
            self._cond[loc].wait_for(
                lambda: self._poison[loc] is not None
                or all(d in self.data[loc] for d in names),
                timeout=self.timeout_s,
            )
            if not all(d in self.data[loc] for d in names):
                poison = self._poison[loc]
                if poison is not None:
                    raise _BranchAborted(
                        f"{loc} branch aborted: a sibling failed with "
                        f"{poison!r}"
                    )
                missing = sorted(d for d in names if d not in self.data[loc])
                raise TimeoutError(f"{loc} never received {missing}")
            return {d: self.data[loc][d] for d in names}

    def _recv(self, loc: str, op: RecvOp):
        """``transport.recv``, abortable by a sibling branch's poison.

        A blocked receive cannot be woken through the location's data
        condition, so it polls in short slices and checks the poison flag
        between them — a crashed sibling must not leave this branch pinned
        for the full ``timeout_s`` (the run must report the root cause
        while the run-level join still has budget, and a crash-recovery
        replay needs that budget).  The unconsumed message, if it ever
        arrives, stays queued for the replay's own receive.
        """
        endpoint = self._endpoint(op)
        deadline = _mono() + self.timeout_s
        while True:
            if self._poison[loc] is not None:
                raise _BranchAborted(
                    f"{loc} recv aborted: a sibling failed with "
                    f"{self._poison[loc]!r}"
                )
            remaining = deadline - _mono()
            if remaining <= 0:
                raise TimeoutError(
                    f"{loc} never received on {endpoint}"
                )
            try:
                return self.transport.recv(
                    endpoint, timeout=min(remaining, 0.05)
                )
            except TimeoutError:
                continue

    def _poison_location(self, loc: str, exc: BaseException) -> None:
        """Abort the location's blocked data-waits and receives."""
        with self._cond[loc]:
            if self._poison[loc] is None:
                self._poison[loc] = exc
            self._cond[loc].notify_all()

    def _clear_poison(self, loc: str) -> None:
        with self._cond[loc]:
            self._poison[loc] = None

    # -- barrier registry ------------------------------------------------------
    def _barrier_for(self, op) -> _ExecBarrier:
        key = (op.step, op.inputs, op.outputs, op.locations)
        with self._barrier_lock:
            if key not in self._barriers:
                self._barriers[key] = _ExecBarrier(n=len(op.locations))
            return self._barriers[key]

    # -- per-location interpreter ----------------------------------------------
    def _fire(self, loc: str, op, meta, inputs):
        """One step-body call, under the fault policy's guard when present."""
        if self._guard is None:
            return meta.fn(inputs)
        return self._guard.fire(op.step, lambda: meta.fn(inputs))

    def _run_op(self, loc: str, op, index: int | None = None) -> None:
        """Interpret one op; log its index on success for crash replay."""
        self._run_op_inner(loc, op)
        if index is not None and self._op_log is not None:
            # list.append is atomic under the GIL; one writer per location
            # in normal runs, one per parallel branch inside a Par — either
            # way the log records a valid completion order for this loc.
            self._op_log[loc].append(index)

    def _run_op_inner(self, loc: str, op) -> None:
        rec = self.recorder
        if isinstance(op, SendOp):
            # The datum may be produced by a sibling branch — wait for it.
            payload = self._wait_data(loc, (op.data,))[op.data]
            if rec is None:
                self.transport.send(self._endpoint(op), op.data, payload)
            else:
                t0 = _mono()
                self.transport.send(self._endpoint(op), op.data, payload)
                record_send_fire(rec, op, t0, _mono(), payload)
            return
        if isinstance(op, RecvOp):
            t0 = _mono()
            msg = self._recv(loc, op)
            if rec is not None:
                record_recv_fire(rec, op, t0, _mono(), msg.payload)
            self._put_data(loc, {msg.data_name: msg.payload})
            return
        # ExecOp
        meta = self.steps[loc][op.step]
        if not op.is_spatial:
            inputs = self._wait_data(loc, op.inputs)
            if rec is None:
                out = self._fire(loc, op, meta, inputs)
            else:
                t0 = _mono()
                out = self._fire(loc, op, meta, inputs)
                _settle_outputs(out, op.outputs)
                record_exec_fire(rec, op, t0, _mono(), (loc,))
            self._put_data(loc, {d: out[d] for d in op.outputs})
            return
        # Spatial constraint: the op's pre-resolved leader flag elects who
        # runs the step body; everyone else synchronises on the barrier
        # (the (EXEC) rule's "Out^D(s) added to every D_i").
        barrier = self._barrier_for(op)
        t0 = _mono() if rec is not None else 0.0
        if op.leader:
            try:
                inputs = self._wait_data(loc, op.inputs)
                out = self._fire(loc, op, meta, inputs)
                if rec is not None:
                    _settle_outputs(out, op.outputs)
                barrier.publish({d: out[d] for d in op.outputs})
            except BaseException as e:  # noqa: BLE001
                barrier.fail(e)
                raise
        outputs = barrier.wait(self.timeout_s)
        if rec is not None:
            record_exec_fire(rec, op, t0, _mono(), (loc,))
        self._put_data(loc, dict(outputs))

    def _run_node(self, loc: str, spec, nid: int) -> None:
        kind = spec.kind[nid]
        if kind == K_ACT:
            i = spec.instr[nid]
            self._run_op(loc, self.programs[loc].ops[i], i)
            return
        if kind == K_SEQ:
            for child in spec.children[nid]:
                self._run_node(loc, spec, child)
            return
        # K_PAR — parallel branches become threads, like the generated
        # multithreaded bundles of the reference implementation.  With a
        # shared branch pool (run_many batches) the threads are reused
        # across instances instead of spawned per Par node; provably
        # non-blocking send-only branches run inline first (a schedule the
        # (L-PAR) congruence already allows), and the last blocking branch
        # runs on the current thread — only true concurrency pays for a
        # thread handoff.
        if self._branch_pool is not None:
            from concurrent.futures import wait as _fwait

            safe = self.programs[loc].inline_send_branches().get(
                nid, frozenset()
            )
            rest = []
            batch: list[tuple] = []
            for c in spec.children[nid]:
                if c in safe:
                    acts = self._collect_send_acts(loc, spec, c)
                    if acts is None:
                        self._run_node(loc, spec, c)
                    else:
                        batch.extend(acts)
                else:
                    rest.append(c)
            if batch:
                self._fire_send_batch(loc, batch)
            if not rest:
                return
            futures = [
                self._branch_pool.submit(self._run_branch, loc, spec, c)
                for c in rest[:-1]
            ]
            self._run_branch(loc, spec, rest[-1])
            _, not_done = _fwait(futures, timeout=self.timeout_s)
            if not_done:
                for f in not_done:
                    f.cancel()
                # A failed sibling usually *caused* the stuck branch (its
                # send never happened) — report the root cause, not the
                # orphaned receiver.
                errs = [
                    f.exception()
                    for f in futures
                    if f.done() and not f.cancelled() and f.exception()
                ]
                real = [e for e in errs if not isinstance(e, _BranchAborted)]
                if real or errs:
                    raise (real or errs)[0]
                raise TimeoutError(f"parallel branch stuck on {loc}")
            for f in futures:
                f.result()  # propagate the first branch failure
            return
        errs: list[BaseException] = []

        def branch(child: int) -> None:
            try:
                self._run_branch(loc, spec, child)
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [
            threading.Thread(target=branch, args=(c,), daemon=True)
            for c in spec.children[nid]
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(self.timeout_s)
            if th.is_alive():
                if errs:
                    # The failed sibling is why this branch is stuck —
                    # surface the root cause.
                    raise _first_real(errs)
                raise TimeoutError(f"parallel branch stuck on {loc}")
        if errs:
            raise _first_real(errs)

    def _collect_send_acts(
        self, loc: str, spec, nid: int
    ) -> "list[tuple] | None":
        """Flatten a send-only inline branch into its (op, index) acts.

        Returns ``None`` when the subtree holds anything but sequential
        SendOps — the caller falls back to per-op interpretation.
        """
        kind = spec.kind[nid]
        if kind == K_ACT:
            i = spec.instr[nid]
            op = self.programs[loc].ops[i]
            if isinstance(op, SendOp):
                return [(op, i)]
            return None
        if kind == K_SEQ:
            acts: list[tuple] = []
            for child in spec.children[nid]:
                sub = self._collect_send_acts(loc, spec, child)
                if sub is None:
                    return None
                acts.extend(sub)
            return acts
        return None

    def _fire_send_batch(self, loc: str, acts: "list[tuple]") -> None:
        """Fire a rank's worth of sends as one fan-out exchange.

        Grouping consecutive ready sends by destination lets the
        transport amortise framing and the ack round trip over the whole
        burst (``scatter``/``send_many``) instead of paying them per
        message — on the zero-copy path a broadcast payload is also
        written to shared memory once, not once per destination.  Batch
        order preserves per-endpoint program order, so the FIFO delivery
        contract is unchanged; op indices are only logged after the
        whole exchange is acknowledged, so a crash replays the entire
        batch (exactly the all-or-nothing semantics crash replay already
        assumes for an unlogged op).
        """
        payloads = [
            self._wait_data(loc, (op.data,))[op.data] for op, _ in acts
        ]
        groups: dict[tuple, list] = {}
        for (op, _), payload in zip(acts, payloads):
            groups.setdefault(self._endpoint(op), []).append(
                (op.data, payload)
            )
        rec = self.recorder
        t0 = _mono() if rec is not None else 0.0
        self.transport.scatter(list(groups.items()))
        t1 = _mono() if rec is not None else 0.0
        for (op, i), payload in zip(acts, payloads):
            if rec is not None:
                record_send_fire(rec, op, t0, t1, payload)
            if self._op_log is not None:
                self._op_log[loc].append(i)

    def _run_branch(self, loc: str, spec, nid: int) -> None:
        """One Par branch; a failure poisons the location's data waits."""
        try:
            self._run_node(loc, spec, nid)
        except BaseException as e:  # noqa: BLE001
            self._poison_location(loc, e)
            raise

    def _run_location(self, loc: str) -> None:
        try:
            spec = self.programs[loc].control()
            if spec.root is not None:
                self._run_node(loc, spec, spec.root)
        except BaseException as e:  # noqa: BLE001
            if self._op_log is not None and not isinstance(e, TimeoutError):
                # Crash recovery: the location thread died mid-program.
                # Steps are pure and every completed op index is logged, so
                # the location can be replayed from its cursor — completed
                # ops skipped, the rest re-interpreted (same lineage
                # argument as elastic worker recovery).  Timeouts are
                # excluded: peer data that never arrived will not arrive
                # on replay either, it would just block another timeout_s.
                try:
                    done = len(self._op_log[loc])
                    self._replay_location(loc)
                except BaseException as replay_err:  # noqa: BLE001
                    self.errors.append((loc, e))
                    self.errors.append((loc, replay_err))
                else:
                    self.recoveries.append(
                        {
                            "mode": "replay",
                            "location": loc,
                            "completed_ops": done,
                            "error": repr(e),
                        }
                    )
                    t = _mono()
                    record_policy_fire(
                        self.recorder, "replay", loc, "-", t, t
                    )
                return
            self.errors.append((loc, e))

    def _replay_location(self, loc: str) -> None:
        """Re-interpret one location from its logged completion cursor.

        A fresh :class:`Cursor` is advanced through the logged indices (the
        recorded order was a real execution order, so each is enabled when
        completed), then the remaining ops run to termination.  Enabled ops
        are scheduled *dynamically*: each completion immediately launches
        whatever it newly enabled.  A lockstep frontier barrier would
        deadlock here — e.g. ``{exec v, recv dv}`` can both be enabled while
        ``recv dv`` waits on ``send dv``, which only becomes enabled once
        ``exec v`` completes.
        """
        self._clear_poison(loc)
        lp = self.programs[loc]
        cur = Cursor(lp)
        for i in self._op_log[loc]:
            cur.complete(i)
        if cur.finished():
            return
        cond = threading.Condition()
        errs: list[BaseException] = []
        running: set[int] = set()

        def one(i: int) -> None:
            try:
                self._run_op(loc, lp.ops[i], i)
            except BaseException as e:  # noqa: BLE001
                with cond:
                    errs.append(e)
                    running.discard(i)
                    cond.notify_all()
                return
            with cond:
                cur.complete(i)
                running.discard(i)
                if not errs:
                    launch_enabled()
                cond.notify_all()

        def launch_enabled() -> None:
            # Caller holds ``cond``.
            for j in cur.enabled_ops():
                if j not in running:
                    running.add(j)
                    threading.Thread(
                        target=one, args=(j,), daemon=True
                    ).start()

        deadline = _mono() + self.timeout_s
        with cond:
            launch_enabled()
            while not cur.finished() and not errs:
                remaining = deadline - _mono()
                if remaining <= 0 or not cond.wait(remaining):
                    raise TimeoutError(f"replay stuck on {loc}")
            if errs:
                raise errs[0]

    def run(self) -> dict[str, dict[str, Any]]:
        deadline = Deadline(
            self.policy.deadline_s if self.policy is not None else None
        )
        threads = [
            threading.Thread(target=self._run_location, args=(loc,), daemon=True)
            for loc in sorted(self.programs)
        ]
        for th in threads:
            th.start()
        for th in threads:
            rem = deadline.remaining()
            th.join(
                self.timeout_s if rem is None else min(self.timeout_s, max(rem, 0.0))
            )
            if th.is_alive():
                # The run deadline beats the per-thread diagnosis: abandon
                # the daemon location threads (pure steps — sound) and
                # surface the typed overrun.
                deadline.check()
                # A peer's failure (e.g. a sender exhausting channel
                # retries) leaves blocked receivers behind — report the
                # root cause, not the stuck thread it orphaned.
                self._raise_first_error()
                raise TimeoutError("a location thread did not finish")
        self._raise_first_error()
        return self.data

    def _raise_first_error(self) -> None:
        if self.errors:
            loc, err = self.errors[0]
            raise RuntimeError(f"location {loc} failed: {err!r}") from err


class ThreadedRuntime:
    """Run one thread per location; each interprets only its own bundle.

    Deprecated tree-walking reference oracle — the staged pipeline's
    ``threaded`` backend interprets the execution IR via
    :class:`ThreadedProgramRuntime` instead.
    """

    def __init__(
        self,
        bundles: Mapping[str, LocationBundle],
        *,
        initial_payloads: Mapping[tuple[str, str], Any] | None = None,
        channels: ChannelRegistry | None = None,
        transport: Transport | None = None,
        timeout_s: float = 60.0,
    ):
        from repro_torch._compat import warn_legacy

        warn_legacy(
            "constructing repro_torch.workflow.ThreadedRuntime directly",
            'swirl.trace(...).lower("threaded").compile(step_fns)',
        )
        if transport is not None and channels is not None:
            raise TypeError("pass either transport= or channels=, not both")
        if transport is None:
            # The historical in-memory queues, behind the Transport API.
            transport = InMemoryTransport(channels or ChannelRegistry())
        self.bundles = dict(bundles)
        self.transport = transport
        # Back-compat: the wrapped registry, when the transport has one.
        self.channels = getattr(transport, "registry", None)
        self.timeout_s = timeout_s
        self._barriers: dict[Exec, _ExecBarrier] = {}
        self._barrier_lock = threading.Lock()
        self.data: dict[str, dict[str, Any]] = {
            loc: {} for loc in self.bundles
        }
        # Per-location condition: writes notify; execs wait on In^D(s) ⊆ D_l
        # (the (EXEC) rule's premise — after optimisation a datum may arrive
        # via a *sibling* parallel branch's recv, so exec must block on it).
        self._cond: dict[str, threading.Condition] = {
            loc: threading.Condition() for loc in self.bundles
        }
        for (l, d), v in (initial_payloads or {}).items():
            self.data[l][d] = v
        self.errors: list[tuple[str, BaseException]] = []

    def _put_data(self, loc: str, items: Mapping[str, Any]) -> None:
        with self._cond[loc]:
            self.data[loc].update(items)
            self._cond[loc].notify_all()

    def _wait_data(self, loc: str, names: frozenset[str]) -> dict[str, Any]:
        with self._cond[loc]:
            ok = self._cond[loc].wait_for(
                lambda: all(d in self.data[loc] for d in names),
                timeout=self.timeout_s,
            )
            if not ok:
                missing = sorted(d for d in names if d not in self.data[loc])
                raise TimeoutError(f"{loc} never received {missing}")
            return {d: self.data[loc][d] for d in names}

    # -- barrier registry -----------------------------------------------------
    def _barrier_for(self, act: Exec) -> _ExecBarrier:
        with self._barrier_lock:
            if act not in self._barriers:
                self._barriers[act] = _ExecBarrier(n=len(act.locations))
            return self._barriers[act]

    # -- per-location interpreter ----------------------------------------------
    def _interp(self, loc: str, t: Trace) -> None:
        if isinstance(t, Nil):
            return
        if isinstance(t, Seq):
            for item in t.items:
                self._interp(loc, item)
            return
        if isinstance(t, Par):
            errs: list[BaseException] = []

            def branch(b: Trace) -> None:
                try:
                    self._interp(loc, b)
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            threads = [
                threading.Thread(target=branch, args=(b,), daemon=True)
                for b in t.branches
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(self.timeout_s)
                if th.is_alive():
                    raise TimeoutError(f"parallel branch stuck on {loc}")
            if errs:
                raise errs[0]
            return
        if isinstance(t, Send):
            # The datum may be produced by a sibling branch — wait for it.
            payload = self._wait_data(loc, frozenset([t.data]))[t.data]
            self.transport.send((t.src, t.dst, t.port), t.data, payload)
            return
        if isinstance(t, Recv):
            msg = self.transport.recv(
                (t.src, t.dst, t.port), timeout=self.timeout_s
            )
            self._put_data(loc, {msg.data_name: msg.payload})
            return
        if isinstance(t, Exec):
            bundle = self.bundles[loc]
            meta = bundle.steps[t.step]
            if len(t.locations) == 1:
                inputs = self._wait_data(loc, t.inputs)
                out = meta.fn(inputs)
                self._put_data(loc, {d: out[d] for d in t.outputs})
                return
            barrier = self._barrier_for(t)
            if barrier.arrive_and_maybe_lead():
                try:
                    inputs = self._wait_data(loc, t.inputs)
                    out = meta.fn(inputs)
                    barrier.publish({d: out[d] for d in t.outputs})
                except BaseException as e:  # noqa: BLE001
                    barrier.fail(e)
                    raise
            outputs = barrier.wait(self.timeout_s)
            self._put_data(loc, dict(outputs))
            return
        raise TypeError(f"not a trace: {t!r}")

    def _run_location(self, loc: str) -> None:
        try:
            self._interp(loc, self.bundles[loc].trace)
        except BaseException as e:  # noqa: BLE001
            self.errors.append((loc, e))

    def run(self) -> dict[str, dict[str, Any]]:
        threads = [
            threading.Thread(target=self._run_location, args=(loc,), daemon=True)
            for loc in sorted(self.bundles)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(self.timeout_s)
            if th.is_alive():
                # A peer's failure (e.g. a sender exhausting channel
                # retries) leaves blocked receivers behind — report the
                # root cause, not the stuck thread it orphaned.
                self._raise_first_error()
                raise TimeoutError("a location thread did not finish")
        self._raise_first_error()
        return self.data

    def _raise_first_error(self) -> None:
        if self.errors:
            loc, err = self.errors[0]
            raise RuntimeError(f"location {loc} failed: {err!r}") from err
