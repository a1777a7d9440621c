"""Per-location executable program IR + the lowering that produces it.

A :class:`LocationProgram` is the unit every backend interprets: the
location's predicates resolved into executable ops —

* :class:`SendOp` / :class:`RecvOp` with their ``(src, dst, port)`` channel
  endpoint resolved,
* :class:`ExecOp` with sorted input/output bindings, the full ``M(s)``
  membership and a pre-computed *leader* flag (the lexicographically first
  location of ``M(s)`` runs the step body; the others synchronise),

stored as a **program-order array** (``ops``) plus a flat preorder control
skeleton (``structure``, the opcodes of :mod:`repro_torch.core.flat`) describing
how the ops compose sequentially/in parallel.  The IR is self-contained and
picklable — the multiprocess backend ships bare ``LocationProgram``s to its
workers — and lossless: :func:`to_action` reconstructs the exact source
predicate of every op, so :meth:`LocationProgram.to_trace` and
:meth:`ExecProgram.system` recover the SWIRL term (used by checkpointing,
which snapshots the *remaining* term by flipping done-flags).

Lowering (:func:`lower_system`) goes through the flat IR of
:mod:`repro_torch.core.flat` — ``tree → FlatSystem → compact() → programs`` — so
it is linear in action count and never re-walks trees per backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Iterator, Mapping, Sequence, Union

from repro_torch.core.flat import OP_ACT, OP_NIL, OP_PAR, OP_SEQ, FlatSystem, FlatTrace
from repro_torch.core.syntax import (
    Action,
    Exec,
    LocationConfig,
    Recv,
    Send,
    WorkflowSystem,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.sched.report import ScheduleReport

__all__ = [
    "Endpoint",
    "ExecOp",
    "SendOp",
    "RecvOp",
    "Op",
    "LocationProgram",
    "ExecProgram",
    "ControlSpec",
    "lower_system",
    "lower_flat",
    "to_action",
]

Endpoint = tuple[str, str, str]  # (src, dst, port)


# ---------------------------------------------------------------------------
# Ops — resolved SEND / RECV / EXEC instructions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SendOp:
    """``send(d ↣ p, l, l')`` with its channel endpoint resolved."""

    data: str
    port: str
    src: str
    dst: str

    @property
    def endpoint(self) -> Endpoint:
        return (self.src, self.dst, self.port)

    @property
    def is_local(self) -> bool:
        return self.src == self.dst


@dataclass(frozen=True)
class RecvOp:
    """``recv(p, l, l')`` with its channel endpoint resolved."""

    port: str
    src: str
    dst: str

    @property
    def endpoint(self) -> Endpoint:
        return (self.src, self.dst, self.port)

    @property
    def is_local(self) -> bool:
        return self.src == self.dst


@dataclass(frozen=True)
class ExecOp:
    """``exec(s, F(s), M(s))`` with bindings and leadership resolved.

    ``inputs``/``outputs`` are sorted tuples (deterministic binding order
    for interpreters and emitted source); ``locations`` keeps the source
    predicate's ``M(s)`` tuple verbatim so :func:`to_action` is exact.
    ``leader`` is true on the location whose program this op belongs to iff
    that location is the lexicographically first of ``M(s)`` — the one that
    runs the step body under the (EXEC) rule's synchronised reduction.
    """

    step: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    locations: tuple[str, ...]
    leader: bool

    @property
    def is_spatial(self) -> bool:
        return len(self.locations) > 1


Op = Union[ExecOp, SendOp, RecvOp]


def to_action(op: Op) -> Action:
    """Reconstruct the exact source predicate of ``op``."""
    if isinstance(op, ExecOp):
        return Exec(
            step=op.step,
            inputs=frozenset(op.inputs),
            outputs=frozenset(op.outputs),
            locations=op.locations,
        )
    if isinstance(op, SendOp):
        return Send(data=op.data, port=op.port, src=op.src, dst=op.dst)
    if isinstance(op, RecvOp):
        return Recv(port=op.port, src=op.src, dst=op.dst)
    raise TypeError(f"not a program op: {op!r}")


def _resolve(action: Action, location: str) -> Op:
    if isinstance(action, Exec):
        return ExecOp(
            step=action.step,
            inputs=tuple(sorted(action.inputs)),
            outputs=tuple(sorted(action.outputs)),
            locations=action.locations,
            leader=location == min(action.locations),
        )
    if isinstance(action, Send):
        return SendOp(
            data=action.data, port=action.port, src=action.src, dst=action.dst
        )
    if isinstance(action, Recv):
        return RecvOp(port=action.port, src=action.src, dst=action.dst)
    raise TypeError(f"not an action: {action!r}")


# ---------------------------------------------------------------------------
# Control skeleton — parsed once per program, shared by every interpreter
# ---------------------------------------------------------------------------

K_ACT = 0
K_SEQ = 1
K_PAR = 2


@dataclass(frozen=True)
class ControlSpec:
    """Immutable node table over one program's control skeleton.

    ``kind[n]``/``children[n]``/``parent[n]`` describe node ``n``;
    ``instr[n]`` is the op index of an ``K_ACT`` leaf (−1 otherwise) and
    ``leaf_node[i]`` the node id of op ``i``.  ``root`` is ``None`` for an
    empty program.  :class:`~repro_torch.exec.interp.Cursor` layers mutable
    per-run state on top; the threaded interpreter recurses over it.
    """

    kind: tuple[int, ...]
    children: tuple[tuple[int, ...], ...]
    parent: tuple[int, ...]
    instr: tuple[int, ...]
    leaf_node: tuple[int, ...]
    root: int | None


def _parse_control(
    structure: Sequence[tuple[int, int]], n_ops: int
) -> ControlSpec:
    kind: list[int] = []
    children: list[tuple[int, ...]] = []
    parent: list[int] = []
    instr: list[int] = []
    leaf_node: list[int] = [-1] * n_ops

    def build(pos: int) -> tuple[int | None, int]:
        code, arg = structure[pos]
        pos += 1
        if code == OP_NIL:
            return None, pos
        nid = len(kind)
        kind.append(K_ACT if code == OP_ACT else K_SEQ if code == OP_SEQ else K_PAR)
        children.append(())
        parent.append(-1)
        instr.append(-1)
        if code == OP_ACT:
            instr[nid] = arg
            leaf_node[arg] = nid
            return nid, pos
        if code not in (OP_SEQ, OP_PAR):
            raise ValueError(f"unknown structure opcode {code}")
        kids: list[int] = []
        for _ in range(arg):
            child, pos = build(pos)
            if child is not None:
                kids.append(child)
                parent[child] = nid
        children[nid] = tuple(kids)
        return nid, pos

    root, end = build(0)
    if end != len(structure):
        raise ValueError("trailing structure ops — corrupt program skeleton")
    return ControlSpec(
        kind=tuple(kind),
        children=tuple(children),
        parent=tuple(parent),
        instr=tuple(instr),
        leaf_node=tuple(leaf_node),
        root=root,
    )


# ---------------------------------------------------------------------------
# LocationProgram / ExecProgram
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LocationProgram:
    """One location's executable program: op array + control skeleton."""

    location: str
    data: frozenset[str]
    structure: tuple[tuple[int, int], ...]
    ops: tuple[Op, ...]

    def control(self) -> ControlSpec:
        spec = self.__dict__.get("_control")
        if spec is None:
            spec = _parse_control(self.structure, len(self.ops))
            self.__dict__["_control"] = spec
        return spec

    def inline_send_branches(self) -> Mapping[int, frozenset[int]]:
        """Per ``Par`` node: branches provably safe to run inline-first.

        A branch qualifies when every op under it is a :class:`SendOp`
        whose datum is *statically available* before the ``Par`` starts —
        initial data or an output of an exec completed earlier in program
        order.  Such a branch never blocks on local progress (its
        ``_wait_data`` is already satisfied and transport acceptance does
        not depend on the peer's workflow progress), so interpreting it
        sequentially before the blocking branches is one of the schedules
        the (L-PAR) congruence already allows — no thread needed.

        Keys are control-node ids of ``Par`` nodes with at least one safe
        branch; values are the safe child node ids.  Cached per program.
        """
        cached = self.__dict__.get("_inline_sends")
        if cached is not None:
            return cached
        spec = self.control()
        ops = self.ops
        result: dict[int, frozenset[int]] = {}

        def produced(nid: int) -> set[str]:
            if spec.kind[nid] == K_ACT:
                op = ops[spec.instr[nid]]
                if isinstance(op, ExecOp):
                    return set(op.outputs)
                return set()  # a recv's datum name is not known statically
            out: set[str] = set()
            for child in spec.children[nid]:
                out |= produced(child)
            return out

        def send_only(nid: int, avail: frozenset[str]) -> bool:
            if spec.kind[nid] == K_ACT:
                op = ops[spec.instr[nid]]
                return isinstance(op, SendOp) and op.data in avail
            return all(
                send_only(child, avail) for child in spec.children[nid]
            )

        def visit(nid: int, avail: frozenset[str]) -> None:
            kind = spec.kind[nid]
            if kind == K_ACT:
                return
            if kind == K_SEQ:
                for child in spec.children[nid]:
                    visit(child, avail)
                    avail = avail | frozenset(produced(child))
                return
            safe = frozenset(
                child
                for child in spec.children[nid]
                if send_only(child, avail)
            )
            if safe:
                result[nid] = safe
            for child in spec.children[nid]:
                visit(child, avail)

        if spec.root is not None:
            visit(spec.root, frozenset(self.data))
        self.__dict__["_inline_sends"] = result
        return result

    # -- views --------------------------------------------------------------
    def exec_ops(self) -> Iterator[ExecOp]:
        for op in self.ops:
            if isinstance(op, ExecOp):
                yield op

    def exec_step_names(self) -> tuple[str, ...]:
        return tuple(op.step for op in self.exec_ops())

    def channels(self) -> tuple[Endpoint, ...]:
        """Every channel endpoint this program communicates over, sorted."""
        return tuple(
            sorted(
                {
                    op.endpoint
                    for op in self.ops
                    if isinstance(op, (SendOp, RecvOp))
                }
            )
        )

    # -- bridges back to the syntax layer ------------------------------------
    def to_trace(self):
        """The SWIRL trace this program lowers (normal-form reconstruction)."""
        return FlatTrace(
            list(self.structure), [to_action(op) for op in self.ops]
        ).rebuild()

    def __len__(self) -> int:
        return len(self.ops)


@dataclass(frozen=True, eq=False)
class ExecProgram:
    """A whole lowered system: one :class:`LocationProgram` per location.

    Carries the placement/schedule metadata resolved at lowering time
    (``schedule`` is the :class:`~repro_torch.sched.ScheduleReport` when the plan
    went through the placement scheduler).  Compile once, interpret — and
    with :meth:`repro_torch.api.Executable.run_many`, run — many times.
    """

    programs: tuple[LocationProgram, ...]
    schedule: "ScheduleReport | None" = field(default=None, repr=False)

    def __post_init__(self) -> None:
        names = [p.location for p in self.programs]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate location program: {names}")

    # -- accessors ----------------------------------------------------------
    @property
    def by_location(self) -> Mapping[str, LocationProgram]:
        cached = self.__dict__.get("_by_location")
        if cached is None:
            cached = {p.location: p for p in self.programs}
            self.__dict__["_by_location"] = cached
        return cached

    def __getitem__(self, location: str) -> LocationProgram:
        return self.by_location[location]

    def locations(self) -> tuple[str, ...]:
        return tuple(p.location for p in self.programs)

    def placement(self) -> dict[str, tuple[str, ...]]:
        """Step → ``M(s)`` as resolved in the program ops."""
        cached = self.__dict__.get("_placement")
        if cached is None:
            cached = {}
            for p in self.programs:
                for op in p.exec_ops():
                    cached[op.step] = tuple(sorted(op.locations))
            self.__dict__["_placement"] = cached
        return dict(cached)

    def step_names(self) -> frozenset[str]:
        return frozenset(self.placement())

    def channels(self) -> tuple[Endpoint, ...]:
        return tuple(sorted({ep for p in self.programs for ep in p.channels()}))

    def total_ops(self) -> int:
        return sum(len(p) for p in self.programs)

    # -- syntax bridge -------------------------------------------------------
    @property
    def system(self) -> WorkflowSystem:
        """The SWIRL system this program lowers (cached reconstruction)."""
        cached = self.__dict__.get("_system")
        if cached is None:
            cached = WorkflowSystem(
                tuple(
                    LocationConfig(p.location, p.data, p.to_trace())
                    for p in self.programs
                )
            )
            self.__dict__["_system"] = cached
        return cached

    def remaining_system(
        self,
        done: Mapping[str, Sequence[bool]],
        data: Mapping[str, frozenset[str]] | None = None,
    ) -> WorkflowSystem:
        """The SWIRL term left after the ``done`` ops were consumed.

        ``done[location][i]`` marks op ``i`` of that location's program as
        executed; ``data`` optionally overrides each location's (grown)
        data scope.  This is what makes program-IR checkpoints speak the
        same language as the reduction runtime: the remaining term *is* the
        program counter.
        """
        configs = []
        for p in self.programs:
            flags = done.get(p.location)
            alive = (
                [True] * len(p.ops)
                if flags is None
                else [not f for f in flags]
            )
            trace = FlatTrace(
                list(p.structure),
                [to_action(op) for op in p.ops],
                alive,
            ).rebuild()
            scope = (data or {}).get(p.location, p.data)
            configs.append(LocationConfig(p.location, scope, trace))
        return WorkflowSystem(tuple(configs))


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


def lower_flat(
    fs: FlatSystem,
    *,
    schedule: "ScheduleReport | None" = None,
    system: WorkflowSystem | None = None,
) -> ExecProgram:
    """Lower a (possibly rewritten-in-place) :class:`FlatSystem`.

    Dead slots are dropped and the skeleton normalised by
    :meth:`FlatTrace.compact`; no tree is ever rebuilt on this path.  When
    the originating ``system`` is known, it seeds the program's cached
    ``.system`` so checkpoint paths skip the reconstruction.
    """
    programs = []
    for cfg in fs.configs:
        flat = cfg.trace.compact()
        programs.append(
            LocationProgram(
                location=cfg.location,
                data=cfg.data,
                structure=tuple(flat.ops),
                ops=tuple(_resolve(a, cfg.location) for a in flat.actions),
            )
        )
    program = ExecProgram(programs=tuple(programs), schedule=schedule)
    if system is not None:
        program.__dict__["_system"] = system
    return program


def lower_system(
    system: WorkflowSystem, *, schedule: "ScheduleReport | None" = None
) -> ExecProgram:
    """Lower a workflow system to per-location executable programs."""
    return lower_flat(
        FlatSystem.from_system(system), schedule=schedule, system=system
    )


def ensure_program(
    source: "ExecProgram | WorkflowSystem", *, schedule: Any = None
) -> ExecProgram:
    """Coerce a backend ``compile`` source into an :class:`ExecProgram`.

    The staged pipeline always hands backends an already-lowered program;
    a bare :class:`WorkflowSystem` (legacy callers, third-party backends
    written against the PR-1 signature) is lowered here.
    """
    if isinstance(source, ExecProgram):
        return source
    if isinstance(source, WorkflowSystem):
        sched = schedule if _is_schedule(schedule) else None
        return lower_system(source, schedule=sched)
    raise TypeError(
        f"cannot lower {type(source).__name__}; expected an ExecProgram "
        "or a WorkflowSystem"
    )


def _is_schedule(obj: Any) -> bool:
    return obj is not None and hasattr(obj, "placement") and hasattr(obj, "network")
