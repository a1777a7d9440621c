"""Makespan simulator — replay a plan's SWIRL traces against a cost model.

A copy of ``repro/sched/simulate.py``.

The simulator turns a :class:`~repro_torch.core.syntax.WorkflowSystem` into a
timed precedence DAG and computes, without executing anything:

* per-location **timelines** (when each exec/send/recv happens),
* the **makespan** and the **critical path** through it,
* total **cross-location bytes** (and the per-pair breakdown) — the
  quantity SWIRL's rewriting exists to minimise.

The timing model follows the send/receive semantics of the paper:

* ``exec`` occupies every location of ``M(s)`` for ``CostModel.exec_s``
  seconds, starting when all of them are ready (the (EXEC) rule's
  synchronised reduction);
* ``send`` is fire-and-forget — the payload *arrives* at the destination
  ``Link.transfer_s(bytes)`` later, but the sender continues immediately, so
  communication overlaps computation exactly as the reference's decentralised
  threaded runtime overlaps it;
* ``recv`` completes at ``max(local readiness, matching send + transfer)``;
* intra-location transfers are free (they are what rule R1 deletes);
* ``Seq`` serialises, ``Par`` overlaps — the trace structure *is* the
  dependency graph, matching one thread per parallel branch at runtime.

Sends and recvs pair up per ``(src, dst, port)`` channel in program order
(the channels are FIFOs).  A recv with no matching send would block forever
at runtime, so the simulator raises :class:`SimulationError` for it.

``exec_slots`` optionally bounds how many execs one location can run
concurrently (list scheduling): ``None`` models the reference's threaded runtime's
one-thread-per-branch behaviour; ``1`` models classic one-worker-per-machine
SWfMS scheduling and is what the placement search optimises against.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Mapping

from repro_torch.core.syntax import (
    Action,
    Exec,
    Nil,
    Par,
    Recv,
    Send,
    Seq,
    Trace,
    WorkflowSystem,
    is_action,
)

from .estimate import CostModel, SizeModel
from .network import NetworkModel


class SimulationError(RuntimeError):
    """The system cannot be replayed (unmatched recv / cyclic channel wait)."""


@dataclass(frozen=True)
class SimEvent:
    """One timeline entry at a location.

    ``name`` is the bare subject of the event — the step for ``exec``,
    the datum for ``send``, the port for ``recv`` — so profilers can
    match predicted events against recorded spans without parsing
    ``label``.
    """

    start: float
    end: float
    kind: str  # "exec" | "send" | "recv"
    label: str
    name: str | None = None

    def pretty(self) -> str:
        return f"[{self.start * 1e3:8.2f}ms → {self.end * 1e3:8.2f}ms] {self.label}"


@dataclass(frozen=True)
class Simulation:
    """What the replay predicted."""

    makespan: float
    timelines: Mapping[str, tuple[SimEvent, ...]]
    critical_path: tuple[str, ...]
    cross_bytes: int
    bytes_by_pair: Mapping[tuple[str, str], int]
    comm_seconds: float  # summed cross-location transfer time
    exec_seconds: float  # summed exec durations (work, not wall-clock)

    def summary(self) -> str:
        lines = [
            f"makespan: {self.makespan * 1e3:.2f} ms  "
            f"(exec work {self.exec_seconds * 1e3:.2f} ms, "
            f"cross-location transfer {self.comm_seconds * 1e3:.2f} ms)",
            f"cross-location bytes: {self.cross_bytes}",
        ]
        if self.critical_path:
            lines.append("critical path: " + " -> ".join(self.critical_path))
        return "\n".join(lines)


@dataclass
class _Node:
    """One action occurrence in one location's trace (program order id)."""

    nid: int
    location: str
    action: Action
    preds: set[int] = field(default_factory=set)


@dataclass
class _Event:
    """A schedulable unit: one comm occurrence, or one synchronised exec."""

    eid: int
    kind: str
    locations: tuple[str, ...]
    label: str
    duration: float
    preds: set[int] = field(default_factory=set)
    action: Action | None = None


def _collect_nodes(location: str, trace: Trace, start_id: int) -> list[_Node]:
    """Flatten a trace into nodes with structural precedence edges.

    Node ids follow program order (the :func:`~repro_torch.core.syntax.actions`
    traversal), which is also the FIFO order of channel operations.
    """
    nodes: list[_Node] = []

    def build(t: Trace, preds: set[int]) -> set[int]:
        if isinstance(t, Nil):
            return preds
        if is_action(t):
            nid = start_id + len(nodes)
            nodes.append(_Node(nid, location, t, set(preds)))
            return {nid}
        if isinstance(t, Seq):
            cur = preds
            for item in t.items:
                cur = build(item, cur)
            return cur
        if isinstance(t, Par):
            exits: set[int] = set()
            for b in t.branches:
                exits |= build(b, preds)
            return exits
        raise TypeError(f"not a trace: {t!r}")

    build(trace, set())
    return nodes


def run_event_schedule(
    preds: list,
    durations: list[float],
    exec_locations: list,
    comm_edges: Mapping[int, tuple[int, float]],
    exec_slots: int | None,
    locations,
) -> tuple[list[float], list[float], list, int]:
    """Event-driven longest path / list scheduling over plain arrays.

    The shared core behind :func:`simulate` and the placement search's
    incremental scorer (:mod:`repro_torch.sched.incremental`): event ``i`` has
    predecessor ids ``preds[i]``, runs for ``durations[i]`` seconds, and —
    when it is a (possibly multi-location) exec — occupies one slot on each
    of ``exec_locations[i]`` (``None`` marks comm events, which never
    contend).  ``comm_edges[recv] = (send, transfer_s)`` adds the transfer
    latency on exactly that edge.  Ties break on event id, so callers that
    construct events in the same order get bit-identical schedules.

    Returns ``(start, finish, crit_pred, unfinished)``; a non-empty
    ``unfinished`` (event ids never scheduled) means a cyclic wait — the
    caller decides how to report it.
    """
    n_events = len(preds)
    indeg = [len(p) for p in preds]
    succs: dict[int, list[int]] = {}
    for eid, ps in enumerate(preds):
        for p in ps:
            succs.setdefault(p, []).append(eid)

    ready = [0.0] * n_events
    crit_pred: list[int | None] = [None] * n_events
    start = [0.0] * n_events
    finish = [0.0] * n_events
    slot_free: dict[str, list[float]] = {}
    single_free: dict[str, float] = {}
    single_slot = exec_slots == 1  # scalar fast path: one worker per machine
    if exec_slots is not None:
        if exec_slots < 1:
            raise ValueError(f"exec_slots must be >= 1: {exec_slots}")
        if single_slot:
            single_free = {loc: 0.0 for loc in locations}
        else:
            slot_free = {loc: [0.0] * exec_slots for loc in locations}

    heap: list[tuple[float, int]] = [
        (0.0, eid) for eid in range(n_events) if indeg[eid] == 0
    ]
    heapq.heapify(heap)
    done = 0
    while heap:
        _, eid = heapq.heappop(heap)
        t = ready[eid]
        ev_locs = exec_locations[eid]
        if ev_locs is not None and exec_slots is not None:
            if single_slot:
                for loc in ev_locs:
                    busy_until = single_free[loc]
                    if busy_until > t:
                        t = busy_until
                end = t + durations[eid]
                for loc in ev_locs:
                    single_free[loc] = end
            else:
                for loc in ev_locs:
                    t = max(t, min(slot_free[loc]))
                end = t + durations[eid]
                for loc in ev_locs:
                    free = slot_free[loc]
                    free[free.index(min(free))] = end
        start[eid] = t
        fin = finish[eid] = t + durations[eid]
        done += 1
        for s in succs.get(eid, ()):
            weight = 0.0
            edge = comm_edges.get(s)
            if edge is not None and edge[0] == eid:
                weight = edge[1]
            cand = fin + weight
            if cand >= ready[s]:
                ready[s] = cand
                crit_pred[s] = eid
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, (ready[s], s))
    unfinished = (
        [] if done == n_events else [e for e in range(n_events) if indeg[e] > 0]
    )
    return start, finish, crit_pred, unfinished


def simulate(
    system: WorkflowSystem,
    *,
    network: NetworkModel | None = None,
    sizes: SizeModel | None = None,
    costs: CostModel | None = None,
    exec_slots: int | None = None,
) -> Simulation:
    """Replay ``system``'s traces against the cost model (see module doc)."""
    network = (network or NetworkModel.preset("uniform")).bind(
        system.locations()
    )
    sizes = sizes or SizeModel()
    costs = costs or CostModel()

    # 1. Per-location nodes with structural precedence.
    nodes: list[_Node] = []
    for cfg in system.configs:
        nodes.extend(_collect_nodes(cfg.location, cfg.trace, len(nodes)))

    # 2. Merge the per-location occurrences of one synchronised exec into a
    #    single event; comm occurrences become one event each.
    exec_sites: dict[Exec, dict[str, list[int]]] = {}
    for n in nodes:
        if isinstance(n.action, Exec):
            exec_sites.setdefault(n.action, {}).setdefault(
                n.location, []
            ).append(n.nid)

    events: list[_Event] = []
    node_event: dict[int, int] = {}

    def new_event(
        kind: str, locations: tuple[str, ...], label: str,
        duration: float, members: list[int], action: Action,
    ) -> None:
        eid = len(events)
        events.append(
            _Event(eid, kind, locations, label, duration, action=action)
        )
        for nid in members:
            node_event[nid] = eid

    for act in sorted(exec_sites, key=lambda a: a.pretty()):
        sites = exec_sites[act]
        depth = max(len(ids) for ids in sites.values())
        for k in range(depth):
            members = [
                ids[k] for ids in sites.values() if k < len(ids)
            ]
            locs = tuple(
                sorted(l for l, ids in sites.items() if k < len(ids))
            )
            new_event(
                "exec", locs, f"exec({act.step})@{','.join(locs)}",
                max(costs.exec_s(act.step), 0.0), members, act,
            )
    for n in nodes:
        if isinstance(n.action, Send):
            a = n.action
            new_event(
                "send", (n.location,),
                f"send({a.data})@{a.src}->{a.dst}", 0.0, [n.nid], a,
            )
        elif isinstance(n.action, Recv):
            a = n.action
            new_event(
                "recv", (n.location,),
                f"recv({a.port})@{a.dst}<-{a.src}", 0.0, [n.nid], a,
            )

    # Structural precedence, lifted node -> event.
    for n in nodes:
        ev = events[node_event[n.nid]]
        for p in n.preds:
            pe = node_event[p]
            if pe != ev.eid:
                ev.preds.add(pe)

    # 3. FIFO channel matching: k-th send pairs with k-th recv.
    sends: dict[tuple[str, str, str], list[int]] = {}
    recvs: dict[tuple[str, str, str], list[int]] = {}
    for n in nodes:  # nid order == program order per location
        if isinstance(n.action, Send):
            sends.setdefault(
                (n.action.src, n.action.dst, n.action.port), []
            ).append(node_event[n.nid])
        elif isinstance(n.action, Recv):
            recvs.setdefault(
                (n.action.src, n.action.dst, n.action.port), []
            ).append(node_event[n.nid])

    comm_edges: dict[int, tuple[int, float]] = {}  # recv event -> (send, s)
    cross_bytes = 0
    bytes_by_pair: dict[tuple[str, str], int] = {}
    comm_seconds = 0.0
    for chan, rlist in recvs.items():
        slist = sends.get(chan, [])
        if len(rlist) > len(slist):
            raise SimulationError(
                f"{len(rlist) - len(slist)} recv(s) on channel {chan} have "
                "no matching send — the plan would deadlock"
            )
        for seid, reid in zip(slist, rlist):
            send_act = events[seid].action
            assert isinstance(send_act, Send)
            nbytes = sizes.bytes_of(send_act.data)
            transfer = network.transfer_s(nbytes, send_act.src, send_act.dst)
            comm_edges[reid] = (seid, transfer)
            events[reid].preds.add(seid)
            if send_act.src != send_act.dst:
                cross_bytes += nbytes
                pair = (send_act.src, send_act.dst)
                bytes_by_pair[pair] = bytes_by_pair.get(pair, 0) + nbytes
                comm_seconds += transfer

    # 4. Event-driven longest path (list scheduling when exec_slots is set),
    #    via the shared array core.
    n_events = len(events)
    start, finish, crit_pred, unfinished = run_event_schedule(
        [ev.preds for ev in events],
        [ev.duration for ev in events],
        [ev.locations if ev.kind == "exec" else None for ev in events],
        comm_edges,
        exec_slots,
        system.locations(),
    )
    if unfinished:
        stuck = [events[eid].label for eid in unfinished[:5]]
        raise SimulationError(
            "cyclic channel wait — the plan cannot be replayed; "
            f"stuck events include {stuck}"
        )

    # 5. Reports.
    makespan = max(finish, default=0.0)
    timelines: dict[str, list[SimEvent]] = {
        loc: [] for loc in system.locations()
    }
    for ev in events:
        act = ev.action
        if isinstance(act, Exec):
            name: str | None = act.step
        elif isinstance(act, Send):
            name = act.data
        elif isinstance(act, Recv):
            name = act.port
        else:
            name = None
        entry = SimEvent(
            start[ev.eid], finish[ev.eid], ev.kind, ev.label, name
        )
        for loc in ev.locations:
            timelines[loc].append(entry)
    for loc in timelines:
        timelines[loc].sort(key=lambda e: (e.start, e.end, e.label))

    path: list[str] = []
    if events:
        cur: int | None = max(range(n_events), key=lambda i: finish[i])
        while cur is not None:
            path.append(events[cur].label)
            cur = crit_pred[cur]
        path.reverse()

    return Simulation(
        makespan=makespan,
        timelines={loc: tuple(tl) for loc, tl in timelines.items()},
        critical_path=tuple(path),
        cross_bytes=cross_bytes,
        bytes_by_pair=bytes_by_pair,
        comm_seconds=comm_seconds,
        exec_seconds=sum(
            ev.duration for ev in events if ev.kind == "exec"
        ),
    )
