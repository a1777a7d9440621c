"""A copy of ``repro/core/semantics.py``.

SWIRL reduction semantics — Figs. 2 and 3 of the paper.

The semantics is implemented as an explicit labelled transition system over
:class:`~repro_torch.core.syntax.WorkflowSystem` states:

* ``(EXEC)``   — synchronised execution of a step across all of ``M(s)``;
  enabled when every involved location has an *active* ``exec(s, ...)``
  occurrence and ``In^D(s) ⊆ D_i`` on each.  Adds ``Out^D(s)`` everywhere.
* ``(COMM)``   — matching active ``send(d↣p,l,l')`` / ``recv(p,l,l')`` with
  ``d ∈ D_l``; *copies* ``d`` into ``D_{l'}`` (data is never consumed).
* ``(L-COMM)`` — the ``l = l'`` case of the above.
* ``(L-PAR) / (SEQ) / (PAR) / (CONGR)`` — realised structurally by the notion
  of *active occurrence*: an action is active iff it is not guarded by an
  unfinished sequential prefix.  This is exactly the closure of the four
  context rules over the congruence of Fig. 2.

Transitions carry labels used by the bisimulation checker: ``exec`` labels
are observable barbs ``ν``; communications are silent ``τ`` actions (Sec. 4).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from .syntax import (
    NIL,
    Action,
    Exec,
    LocationConfig,
    Nil,
    Par,
    Recv,
    Send,
    Seq,
    Trace,
    WorkflowSystem,
    is_action,
    normalize,
    par,
    seq,
)

# An *occurrence* of an active action inside a trace: the action itself plus
# a rebuild function that returns the whole trace with this occurrence
# replaced by an arbitrary sub-trace (``NIL`` to consume it).
Occurrence = tuple[Action, Callable[[Trace], Trace]]


def active_occurrences(t: Trace) -> list[Occurrence]:
    """All action occurrences executable *now* (not sequentially guarded)."""
    if is_action(t):
        act: Action = t  # type: ignore[assignment]
        return [(act, lambda new: new)]
    if isinstance(t, Nil):
        return []
    if isinstance(t, Seq):
        if not t.items:
            return []
        head, rest = t.items[0], t.items[1:]
        out: list[Occurrence] = []
        for act, rebuild in active_occurrences(head):
            out.append(
                (act, lambda new, rb=rebuild: seq(rb(new), *rest))
            )
        return out
    if isinstance(t, Par):
        out = []
        for i, b in enumerate(t.branches):
            others_before = t.branches[:i]
            others_after = t.branches[i + 1 :]
            for act, rebuild in active_occurrences(b):
                out.append(
                    (
                        act,
                        lambda new, rb=rebuild, ob=others_before, oa=others_after: par(
                            *ob, rb(new), *oa
                        ),
                    )
                )
        return out
    raise TypeError(f"not a trace: {t!r}")


# ---------------------------------------------------------------------------
# Transitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExecTransition:
    """(EXEC): one active ``exec(s,...)`` occurrence per involved location."""

    step: str
    action: Exec
    # location -> index into active_occurrences of that location's trace
    picks: tuple[tuple[str, int], ...]

    @property
    def label(self) -> tuple:
        return ("exec", self.action.step, self.action.inputs, self.action.outputs,
                self.action.locations)

    @property
    def is_tau(self) -> bool:
        return False


@dataclass(frozen=True)
class CommTransition:
    """(COMM)/(L-COMM): matching send/recv occurrence pair."""

    send: Send
    src_pick: int  # occurrence index in the source location's trace
    dst_pick: int  # occurrence index in the destination location's trace

    @property
    def label(self) -> tuple:
        return ("tau", self.send.data, self.send.port, self.send.src, self.send.dst)

    @property
    def is_tau(self) -> bool:
        return True


Transition = ExecTransition | CommTransition


def enabled_transitions(w: WorkflowSystem) -> list[Transition]:
    """Enumerate every transition enabled in ``w`` (Fig. 3 premises)."""
    occs = {c.location: active_occurrences(c.trace) for c in w.configs}
    data = {c.location: c.data for c in w.configs}
    out: list[Transition] = []

    # (EXEC) — for each step with an active exec occurrence somewhere, check
    # every location of M(s) has one and the input data is resident.
    exec_sites: dict[tuple[str, Exec], dict[str, list[int]]] = {}
    for l, lst in occs.items():
        for i, (act, _) in enumerate(lst):
            if isinstance(act, Exec):
                exec_sites.setdefault((act.step, act), {}).setdefault(l, []).append(i)
    for (step, act), sites in exec_sites.items():
        locs = act.locations
        if not all(l in sites for l in locs):
            continue  # some involved location is not ready to synchronise
        if not all(act.inputs <= data[l] for l in locs):
            continue  # In^D(s) ⊄ D_i
        # Pick the first active occurrence on each location (other picks lead
        # to congruent states because occurrences of the same exec predicate
        # are interchangeable).
        picks = tuple((l, sites[l][0]) for l in locs)
        out.append(ExecTransition(step, act, picks))

    # (COMM) / (L-COMM) — match send with a recv on (port, src, dst).
    for l, lst in occs.items():
        for i, (act, _) in enumerate(lst):
            if not isinstance(act, Send):
                continue
            if act.data not in data[l] or act.src != l:
                continue
            dst_list = occs.get(act.dst, [])
            for j, (ract, _) in enumerate(dst_list):
                if (
                    isinstance(ract, Recv)
                    and ract.port == act.port
                    and ract.src == act.src
                    and ract.dst == act.dst
                ):
                    out.append(CommTransition(act, i, j))
                    break  # matching any one recv occurrence is enough
    return out


def apply_transition(w: WorkflowSystem, t: Transition) -> WorkflowSystem:
    """Apply one reduction ``W → W'``."""
    occs = {c.location: active_occurrences(c.trace) for c in w.configs}
    if isinstance(t, ExecTransition):
        new = w
        for l, idx in t.picks:
            act, rebuild = occs[l][idx]
            assert isinstance(act, Exec) and act == t.action
            cfg = new[l]
            new = new.replace(
                l, data=cfg.data | t.action.outputs, trace=rebuild(NIL)
            )
        return new
    if isinstance(t, CommTransition):
        s = t.send
        if s.src == s.dst:
            # (L-COMM): consume both occurrences within the same location.
            lst = occs[s.src]
            sact, srebuild = lst[t.src_pick]
            # Rebuild send first, then locate the recv in the *new* trace.
            trace1 = srebuild(NIL)
            lst1 = active_occurrences(trace1)
            # find matching recv occurrence again
            for ract, rrebuild in lst1:
                if (
                    isinstance(ract, Recv)
                    and ract.port == s.port
                    and ract.src == s.src
                    and ract.dst == s.dst
                ):
                    cfg = w[s.src]
                    return w.replace(s.src, data=cfg.data | {s.data},
                                     trace=rrebuild(NIL))
            raise RuntimeError("L-COMM recv occurrence vanished")
        # (COMM)
        sact, srebuild = occs[s.src][t.src_pick]
        ract, rrebuild = occs[s.dst][t.dst_pick]
        new = w.replace(s.src, trace=srebuild(NIL))
        dst_cfg = w[s.dst]
        new = new.replace(
            s.dst, data=dst_cfg.data | {s.data}, trace=rrebuild(NIL)
        )
        return new
    raise TypeError(f"not a transition: {t!r}")


# ---------------------------------------------------------------------------
# Execution drivers
# ---------------------------------------------------------------------------


@dataclass
class RunResult:
    final: WorkflowSystem
    events: list[tuple]  # transition labels in firing order
    deadlocked: bool

    @property
    def exec_events(self) -> list[tuple]:
        return [e for e in self.events if e[0] == "exec"]

    @property
    def comm_events(self) -> list[tuple]:
        return [e for e in self.events if e[0] == "tau"]


def run(
    w: WorkflowSystem,
    *,
    rng: Optional[random.Random] = None,
    max_steps: int = 100_000,
    prefer_comm: bool = False,
) -> RunResult:
    """Reduce ``w`` to completion under a (possibly random) scheduler.

    Every schedule of an encoded system reaches the same final state up to
    congruence (Lemma 1, Church–Rosser) — the random scheduler is how the
    property tests exercise that claim.
    """
    events: list[tuple] = []
    for _ in range(max_steps):
        ts = enabled_transitions(w)
        if not ts:
            return RunResult(w, events, deadlocked=not w.is_terminated())
        if rng is None:
            t = ts[0]
        else:
            if prefer_comm:
                comms = [t for t in ts if t.is_tau]
                t = rng.choice(comms or ts)
            else:
                t = rng.choice(ts)
        events.append(t.label)
        w = apply_transition(w, t)
    raise RuntimeError(f"did not terminate within {max_steps} reductions")


def reachable_states(
    w: WorkflowSystem, *, max_states: int = 20_000
) -> dict[str, list[tuple[tuple, str]]]:
    """Explicit LTS: canonical state -> [(label, canonical successor)].

    Used by the bisimulation checker; raises if the state space exceeds
    ``max_states`` (keep the property-test instances small).
    """
    lts: dict[str, list[tuple[tuple, str]]] = {}
    index: dict[str, WorkflowSystem] = {w.canonical(): w}
    frontier = [w]
    while frontier:
        cur = frontier.pop()
        key = cur.canonical()
        if key in lts:
            continue
        succ: list[tuple[tuple, str]] = []
        for t in enabled_transitions(cur):
            nxt = apply_transition(cur, t)
            nkey = nxt.canonical()
            succ.append((t.label, nkey))
            if nkey not in index:
                index[nkey] = nxt
                frontier.append(nxt)
                if len(index) > max_states:
                    raise RuntimeError("state space too large for exploration")
        lts[key] = succ
    return lts


def barbs(w: WorkflowSystem) -> frozenset[tuple]:
    """Strong barbs ``W ↓_ν``: the observable exec predicates enabled now."""
    return frozenset(
        t.label for t in enabled_transitions(w) if isinstance(t, ExecTransition)
    )
