"""Interpretation machinery over the program IR.

:class:`Cursor` is a *structured program counter* for one
:class:`~repro_torch.exec.program.LocationProgram`: it maintains the set of op
indices that are active **now** (not guarded by an unfinished sequential
prefix — exactly the ``active_occurrences`` notion of
:mod:`repro_torch.core.semantics`, computed incrementally over the flat skeleton
instead of by tree traversal).  Completing an op advances sequence pointers
and parallel join counters in O(depth); the enabled set is always available
in O(1).

The port's one interpreter, the deterministic reducer of the ``torch``
backend, drives one cursor per location and fires matching ops.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping

# .policy is imported lazily inside the helpers below, as in the reference
# (whose workflow package imports this module back, closing a cycle).
if TYPE_CHECKING:  # pragma: no cover - typing only
    from .policy import FaultPolicy

from .program import (
    K_ACT,
    K_PAR,
    K_SEQ,
    ExecOp,
    LocationProgram,
    RecvOp,
    SendOp,
)

__all__ = [
    "Cursor",
    "Deadline",
    "StepGuard",
    "call_with_timeout",
    "first_enabled_comm",
    "enabled_exec_picks",
    "record_comm_fire",
    "record_exec_fire",
    "record_policy_fire",
    "record_recv_fire",
    "record_send_fire",
]


class Cursor:
    """Incremental enabled-set tracker over one location program."""

    __slots__ = (
        "program",
        "_spec",
        "enabled",
        "_op_done",
        "_seq_ptr",
        "_par_left",
        "_finished",
    )

    def __init__(self, program: LocationProgram):
        self.program = program
        spec = program.control()
        self._spec = spec
        self.enabled: set[int] = set()
        self._op_done = [False] * len(program.ops)
        self._seq_ptr = [0] * len(spec.kind)
        self._par_left = [0] * len(spec.kind)
        self._finished = False
        if spec.root is None:
            self._finished = True
        else:
            self._enter(spec.root)

    # -- state --------------------------------------------------------------
    def finished(self) -> bool:
        return self._finished

    def done_flags(self) -> list[bool]:
        """Per-op completion flags (for remaining-term reconstruction)."""
        return list(self._op_done)

    def enabled_ops(self) -> list[int]:
        """Active op indices in program order (deterministic iteration)."""
        return sorted(self.enabled)

    # -- transitions ---------------------------------------------------------
    def complete(self, op_index: int) -> None:
        """Mark one *enabled* op as executed; exposes its successors."""
        if op_index not in self.enabled:
            raise ValueError(
                f"op {op_index} is not active on {self.program.location!r}"
            )
        self.enabled.discard(op_index)
        self._op_done[op_index] = True
        self._node_done(self._spec.leaf_node[op_index])

    # -- internals -----------------------------------------------------------
    def _enter(self, nid: int) -> None:
        spec = self._spec
        kind = spec.kind[nid]
        if kind == K_ACT:
            self.enabled.add(spec.instr[nid])
            return
        kids = spec.children[nid]
        if not kids:  # cannot happen for compacted programs; be safe
            self._node_done(nid)
            return
        if kind == K_SEQ:
            self._seq_ptr[nid] = 0
            self._enter(kids[0])
        else:  # K_PAR
            self._par_left[nid] = len(kids)
            for k in kids:
                self._enter(k)

    def _node_done(self, nid: int) -> None:
        spec = self._spec
        while True:
            parent = spec.parent[nid]
            if parent < 0:
                self._finished = True
                return
            if spec.kind[parent] == K_SEQ:
                self._seq_ptr[parent] += 1
                kids = spec.children[parent]
                if self._seq_ptr[parent] < len(kids):
                    self._enter(kids[self._seq_ptr[parent]])
                    return
                nid = parent
            else:  # K_PAR
                self._par_left[parent] -= 1
                if self._par_left[parent] > 0:
                    return
                nid = parent


# ---------------------------------------------------------------------------
# Shared enablement matching — one semantics core for every centralised
# interpreter (the inprocess dataflow runtime, the deterministic jax
# reducer).  The predicates here ARE the Fig. 3 premises over cursors.
# ---------------------------------------------------------------------------


def first_enabled_comm(
    cursors: Mapping[str, Cursor],
    data: Mapping[str, set],
    order: Iterable[str] | None = None,
) -> tuple[SendOp, str, int, int] | None:
    """First (COMM)/(L-COMM)-enabled pair, scanning ``order``.

    A send is enabled when active with its datum resident at the source;
    it matches the first active recv on the same ``(port, src, dst)`` at
    the destination (never itself, for local comms).  Returns
    ``(send_op, src_location, send_index, recv_index)`` or ``None``.
    """
    for loc in order if order is not None else cursors:
        cur = cursors[loc]
        for i in cur.enabled_ops():
            op = cur.program.ops[i]
            if not isinstance(op, SendOp):
                continue
            if op.src != loc or op.data not in data[loc]:
                continue
            dst = cursors.get(op.dst)
            if dst is None:
                continue
            for j in dst.enabled_ops():
                r = dst.program.ops[j]
                if (
                    isinstance(r, RecvOp)
                    and r.port == op.port
                    and r.src == op.src
                    and r.dst == op.dst
                    and not (op.src == op.dst and j == i)
                ):
                    return op, loc, i, j
    return None


def enabled_exec_picks(
    cursors: Mapping[str, Cursor],
    data: Mapping[str, set],
    order: Iterable[str] | None = None,
) -> list[tuple[ExecOp, tuple[tuple[str, int], ...]]]:
    """(EXEC)-enabled ops with their per-location occurrence picks.

    An exec fires when every location of ``M(s)`` has an active occurrence
    of the same predicate *and* ``In^D(s)`` is resident on each; the first
    active occurrence per location is picked (occurrences of one predicate
    are interchangeable).  Returns ``[(op, ((location, op_index), ...))]``
    in discovery order — callers impose their own firing order.
    """
    sites: dict[tuple, dict[str, int]] = {}
    for loc in order if order is not None else cursors:
        cur = cursors[loc]
        for i in cur.enabled_ops():
            op = cur.program.ops[i]
            if isinstance(op, ExecOp):
                key = (op.step, op.inputs, op.outputs, op.locations)
                sites.setdefault(key, {}).setdefault(loc, i)
    out: list[tuple[ExecOp, tuple[tuple[str, int], ...]]] = []
    for key, by_loc in sites.items():
        _, inputs, _, locations = key
        if not all(l in by_loc for l in locations):
            continue
        if not all(set(inputs) <= data[l] for l in locations):
            continue
        picks = tuple((l, by_loc[l]) for l in locations)
        op = cursors[picks[0][0]].program.ops[picks[0][1]]
        assert isinstance(op, ExecOp)
        out.append((op, picks))
    return out


# ---------------------------------------------------------------------------
# Shared span recording — the ONE place that decides what a span for an op
# firing looks like, so every backend (centralised or decentralised) emits
# an identical schema for the same program.  Call sites guard on
# ``recorder is None`` themselves, keeping the untraced hot path free of
# function calls; these helpers additionally no-op on None so defensive
# callers pay only the call.
# ---------------------------------------------------------------------------


def record_send_fire(recorder, op, t0: float, t1: float,
                     nbytes=None) -> None:
    """One send span at ``op.src``, named after the datum.

    ``t0``/``t1`` are raw ``time.monotonic()`` stamps; ``nbytes`` is an
    ``int`` or the payload object itself (sized lazily off the hot path).
    The helpers append raw rows via ``TraceRecorder.add`` — the bound
    ``list.append`` fast path — rather than the ``span()`` wrapper; the
    row layout is :class:`~repro_torch.obs.events.SpanEvent` field order."""
    if recorder is None:
        return
    recorder.add(("send", op.src, op.data, t0, t1,
                  op.src, op.dst, op.port, nbytes))


def record_recv_fire(recorder, op, t0: float, t1: float,
                     nbytes=None) -> None:
    """One recv span at ``op.dst``, named after the port."""
    if recorder is None:
        return
    recorder.add(("recv", op.dst, op.port, t0, t1,
                  op.src, op.dst, op.port, nbytes))


def record_comm_fire(recorder, op: SendOp, t0: float, t1: float,
                     nbytes=None) -> None:
    """Record one atomic comm firing (centralised interpreters): the send
    span at ``op.src`` and the matching recv span at ``op.dst`` share the
    interval.  Decentralised interpreters record the two halves
    separately via :func:`record_send_fire` / :func:`record_recv_fire` —
    the identity schema is the same either way."""
    if recorder is None:
        return
    add = recorder.add
    add(("send", op.src, op.data, t0, t1, op.src, op.dst, op.port, nbytes))
    add(("recv", op.dst, op.port, t0, t1, op.src, op.dst, op.port, nbytes))


def record_exec_fire(recorder, op: ExecOp, t0: float, t1: float,
                     locations: Iterable[str] | None = None) -> None:
    """Record one exec firing: one span per location of ``M(s)`` (the
    (EXEC) rule reduces all of them synchronously)."""
    if recorder is None:
        return
    for loc in locations if locations is not None else op.locations:
        recorder.add(("exec", loc, op.step, t0, t1, None, None, None, None))


def record_policy_fire(recorder, kind: str, location: str, step: str,
                       t0: float, t1: float) -> None:
    """One policy-outcome span (``kind`` ∈ retry/timeout/speculation/
    heartbeat_death/deadline), named ``"<kind>:<step>"`` so Perfetto rows
    group by mechanism.  Same None fast-path contract as the fire helpers."""
    if recorder is None:
        return
    recorder.add(("policy", location, f"{kind}:{step}",
                  t0, t1, None, None, None, None))


# ---------------------------------------------------------------------------
# Shared fault-policy enforcement — the ONE implementation of per-step
# timeout + retry + run deadline that every backend wires around its step
# fires (the same single-home pattern as the span helpers above), so the
# conformance suite can demand identical policy semantics from interpreters
# with wildly different architectures.
# ---------------------------------------------------------------------------


def call_with_timeout(fn: Callable[[], Any], timeout_s: float | None,
                      step: str) -> Any:
    """Run ``fn()`` bounded by ``timeout_s`` wall-clock seconds.

    The attempt runs on a fresh daemon thread; on overrun the thread is
    **abandoned** (not killed — Python cannot) and :class:`StepTimeoutError`
    is raised.  Abandonment is sound for SWIRL steps: they are pure, so a
    late-finishing orphan has no observable effect — its result is simply
    never read.
    """
    from .policy import StepTimeoutError

    if timeout_s is None:
        return fn()
    box: list[tuple[str, Any]] = []

    def target() -> None:
        try:
            box.append(("ok", fn()))
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box.append(("err", e))

    t = threading.Thread(target=target, daemon=True, name=f"step-{step}")
    t.start()
    t.join(timeout_s)
    if not box:
        raise StepTimeoutError(step, timeout_s)
    kind, value = box[0]
    if kind == "err":
        raise value
    return value


class StepGuard:
    """Wraps step fires with one :class:`FaultPolicy`'s timeout + retry.

    Thread-safe (location threads and speculation pools share one guard);
    counts outcomes for ``result.stats`` and invokes optional callbacks so
    backends can emit spans / protocol messages per retry or timeout.
    """

    __slots__ = ("policy", "retry", "retries", "timeouts",
                 "_on_retry", "_on_timeout", "_lock")

    def __init__(self, policy: FaultPolicy, *, rng: Any = None,
                 on_retry: Callable[[str, int, Exception], None] | None = None,
                 on_timeout: Callable[[str], None] | None = None):
        self.policy = policy
        self.retry = policy.retry_policy(rng)
        self.retries = 0
        self.timeouts = 0
        self._on_retry = on_retry
        self._on_timeout = on_timeout
        self._lock = threading.Lock()

    def fire(self, step: str, fn: Callable[[], Any]) -> Any:
        """Run one step body under the policy; raises what the policy lets
        escape (:class:`TransientError` after the retry budget,
        :class:`~repro_torch.workflow.fault.PermanentError` immediately)."""
        from .policy import StepTimeoutError

        timeout_s = self.policy.timeout_s

        def attempt() -> Any:
            if timeout_s is None:
                return fn()
            try:
                return call_with_timeout(fn, timeout_s, step)
            except StepTimeoutError:
                with self._lock:
                    self.timeouts += 1
                if self._on_timeout is not None:
                    self._on_timeout(step)
                raise

        if self.retry is None:
            return attempt()

        def note(n: int, e: Exception) -> None:
            with self._lock:
                self.retries += 1
            if self._on_retry is not None:
                self._on_retry(step, n, e)

        return self.retry.run(attempt, on_retry=note)

    def counts(self) -> dict[str, int]:
        """Snapshot for ``result.stats["policy"]``."""
        with self._lock:
            return {"retries": self.retries, "timeouts": self.timeouts}


class Deadline:
    """Whole-run wall-clock budget; inert when ``deadline_s`` is ``None``."""

    __slots__ = ("deadline_s", "_t0", "_clock")

    def __init__(self, deadline_s: float | None,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self._clock = clock
        self._t0 = clock()

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float | None:
        """Seconds left (may be ≤ 0), or ``None`` when unbounded — feed it
        straight into a blocking wait's ``timeout=``."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - self.elapsed()

    def expired(self) -> bool:
        return self.deadline_s is not None and self.elapsed() > self.deadline_s

    def check(self) -> None:
        if self.expired():
            from .policy import RunDeadlineExceeded

            raise RunDeadlineExceeded(self.deadline_s, elapsed_s=self.elapsed())
