"""Elastic recovery on the execution IR — renaming without a tree round-trip.

A copy of ``repro/exec/elastic.py``, over the port's ``FlatTrace``,
``exec/program`` and ``sched/simulate``.

SWIRL's semantics is invariant under location renaming (names are opaque in
Figs. 2-3), and :mod:`repro_torch.workflow.elastic` exploits that at the *tree*
level: rename the checkpointed term, re-encode, resume.  Every backend now
interprets the flat per-location :class:`~repro_torch.exec.program.ExecProgram`,
so a live executor recovering from a dead worker should not detour through
tree reconstruction at all.  This module applies the same substitution
**directly on the op arrays**:

* :func:`rename_program` maps every ``SendOp``/``RecvOp`` endpoint, every
  ``ExecOp`` location set (canonicalised to a sorted, duplicate-free
  tuple), and re-elects every leader flag against the renamed ``M(s)``;
* a *surjective* renaming (fold — scale-down onto a survivor) merges the
  collapsed programs under one parallel root by splicing their flat
  skeletons, exactly what ``par`` does to the tree form, and is then
  normalised by :meth:`~repro_torch.core.flat.FlatTrace.compact`;
* when a fold collapses several locations of one spatial step onto the
  same name, the synchronised occurrences become redundant copies at one
  location — all but the first are dropped.  That weakening is sound: it
  only *adds* interleavings the (L-PAR) congruence already allows, and
  every consumer of the step's outputs is guarded by data residency, not
  by control order.

The resume point is reconstructed from a coordinator-merged checkpoint:
``completed_execs`` says which step bodies must *never* re-run (they replay
recorded outputs instead), and :func:`repro_torch.workflow.elastic.fold_payloads`
moves the payload store under the substitution with the deterministic
survivor-wins precedence.  The tree-level module stays in place as the
semantics oracle — ``rename_program(lower(w)).system`` must agree with
``rename_locations(w)`` — which is exactly what the property tests check.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping

from repro_torch.core.flat import OP_ACT, OP_NIL, OP_PAR, FlatTrace
from repro_torch.core.syntax import Action, Exec, Recv, Send

from .program import (
    ExecOp,
    ExecProgram,
    LocationProgram,
    Op,
    RecvOp,
    SendOp,
    _resolve,
    to_action,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.sched.simulate import Simulation

__all__ = ["rename_program", "resimulate"]


def _rename_op(op: Op, ren: Mapping[str, str], location: str) -> Op:
    """One op under the substitution, leadership re-elected."""
    r = ren.get
    if isinstance(op, ExecOp):
        locs = tuple(sorted({r(l, l) for l in op.locations}))
        return ExecOp(
            step=op.step,
            inputs=op.inputs,
            outputs=op.outputs,
            locations=locs,
            leader=location == locs[0],
        )
    if isinstance(op, SendOp):
        return SendOp(
            data=op.data, port=op.port, src=r(op.src, op.src),
            dst=r(op.dst, op.dst),
        )
    if isinstance(op, RecvOp):
        return RecvOp(port=op.port, src=r(op.src, op.src), dst=r(op.dst, op.dst))
    raise TypeError(f"not a program op: {op!r}")


def _rename_action(a: Action, ren: Mapping[str, str]) -> Action:
    """The action view of :func:`_rename_op` (for the fold/merge path)."""
    r = ren.get
    if isinstance(a, Exec):
        return Exec(
            step=a.step,
            inputs=a.inputs,
            outputs=a.outputs,
            locations=tuple(sorted({r(l, l) for l in a.locations})),
        )
    if isinstance(a, Send):
        return Send(
            data=a.data, port=a.port, src=r(a.src, a.src), dst=r(a.dst, a.dst)
        )
    if isinstance(a, Recv):
        return Recv(port=a.port, src=r(a.src, a.src), dst=r(a.dst, a.dst))
    raise TypeError(f"not an action: {a!r}")


def _is_empty(p: LocationProgram) -> bool:
    return not p.ops and all(code == OP_NIL for code, _ in p.structure)


def _merge_group(
    location: str, group: list[LocationProgram], ren: Mapping[str, str]
) -> LocationProgram:
    """Fold ≥2 collapsed programs onto one location, skeleton-spliced.

    The merged skeleton is one ``PAR`` over the member skeletons with the
    leaf slots re-based onto the concatenated action array — the flat
    analogue of ``par(prev.trace, new_trace)`` — then normalised by
    :meth:`FlatTrace.compact` (nested ``Par`` flattened, units dropped).
    Duplicate occurrences of one step (a spatial ``M(s)`` collapsing onto
    this location) keep only their first copy; see the module docstring
    for why that is sound.
    """
    members = [p for p in group if not _is_empty(p)]
    data = frozenset().union(*(p.data for p in group))
    if not members:
        return LocationProgram(
            location=location,
            data=data,
            structure=((OP_NIL, 0),),
            ops=(),
        )
    skeleton: list[tuple[int, int]] = [(OP_PAR, len(members))]
    actions: list[Action] = []
    for p in members:
        base = len(actions)
        skeleton.extend(
            (code, arg + base) if code == OP_ACT else (code, arg)
            for code, arg in p.structure
        )
        actions.extend(_rename_action(to_action(op), ren) for op in p.ops)
    alive = [True] * len(actions)
    seen_steps: set[str] = set()
    for i, a in enumerate(actions):
        if isinstance(a, Exec):
            if a.step in seen_steps:
                alive[i] = False
            else:
                seen_steps.add(a.step)
    flat = FlatTrace(skeleton, actions, alive).compact()
    return LocationProgram(
        location=location,
        data=data,
        structure=tuple(flat.ops),
        ops=tuple(_resolve(a, location) for a in flat.actions),
    )


def rename_program(
    program: ExecProgram, ren: Mapping[str, str]
) -> ExecProgram:
    """Apply a location substitution to a lowered program, in the arrays.

    Bijective renamings (dead → spare) rewrite each program's op array in
    place-shape — same skeleton, renamed endpoints, re-elected leaders.
    Surjective renamings (fold/scale-down) additionally merge the
    collapsed programs via :func:`_merge_group`.  The attached schedule
    report is dropped: its placement speaks the old location names (use
    :func:`resimulate` for a fresh prediction of the renamed plan).
    """
    groups: dict[str, list[LocationProgram]] = {}
    for p in program.programs:
        groups.setdefault(ren.get(p.location, p.location), []).append(p)
    renamed: list[LocationProgram] = []
    for location in sorted(groups):
        group = groups[location]
        if len(group) == 1:
            p = group[0]
            renamed.append(
                LocationProgram(
                    location=location,
                    data=p.data,
                    structure=p.structure,
                    ops=tuple(_rename_op(op, ren, location) for op in p.ops),
                )
            )
        else:
            renamed.append(_merge_group(location, group, ren))
    return ExecProgram(programs=tuple(renamed), schedule=None)


def resimulate(program: ExecProgram, **kwargs) -> "Simulation":
    """Re-simulate a (renamed) program against the scheduling cost model.

    Recovery changes the location set under a running plan, so any
    makespan the original :class:`~repro_torch.sched.ScheduleReport` predicted
    is stale; this replays the renamed program's term through
    :func:`repro_torch.sched.simulate.simulate` (uniform network unless given)
    so recovery events can report the folded plan's predicted cost.
    """
    from repro_torch.sched.simulate import simulate

    return simulate(program.system, **kwargs)
