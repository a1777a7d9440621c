"""Incremental placement scoring — candidate moves without tree rebuilds.

A copy of ``repro/sched/incremental.py``.

``refine_placement`` historically scored every candidate move by
re-encoding the whole instance into trace trees, re-running the rewrite
rules over them and re-simulating from scratch — superlinear per move and
infeasible beyond a few hundred steps.  :class:`PlacementScorer` keeps the
plan in the flat domain for the whole search:

* the per-location **rows** (work-queue blocks with their recv/send
  templates, already filtered through the R1/R2 scan) are cached and, when
  one step moves, only the rows whose content mentions that step — its old
  and new homes, the locations of its producers (their send targets change)
  and of its consumers (their recv sources change) — are rebuilt;
* R3 survivorship and the event graph are re-derived from the cached rows
  with plain arrays (no ``Seq``/``Par``/dataclass nodes anywhere), and the
  schedule itself runs through the same
  :func:`repro_torch.sched.simulate.run_event_schedule` core as the public
  simulator.

Equivalence contract: ``score()`` returns exactly the ``(makespan,
cross_bytes)`` that ``evaluate_placement`` — ``simulate(rewrite(encode(I
under M)))`` — would report for the same mapping, including tie-breaking
(events are constructed in the same order as
:func:`repro_torch.sched.simulate.simulate` constructs them, and the heap breaks
ties on event id).  The differential suite in
``tests/test_compile_scale.py`` pins this on random instances; if a rule
list outside the supported forms is requested the caller falls back to the
tree path (:class:`UnsupportedRules`).
"""

from __future__ import annotations

from bisect import bisect_left, insort
from typing import Mapping, Sequence

from repro_torch.core.graph import DistributedWorkflowInstance

from .estimate import CostModel, SizeModel
from .network import NetworkModel
from .simulate import SimulationError, run_event_schedule

__all__ = ["PlacementScorer", "UnsupportedRules"]

#: Rule lists the scorer can replay (prefixes of the canonical order).
_SUPPORTED_RULES = {(), ("R1R2",), ("R1R2", "R3")}


class UnsupportedRules(ValueError):
    """The requested rewrite-rule list has no flat-domain replay."""


class PlacementScorer:
    """Score ``(makespan, cross_bytes)`` of placements, patching per move.

    Usage::

        scorer = PlacementScorer(inst, network, sizes=s, costs=c, rules=r)
        scorer.reset(mapping)
        base = scorer.score()
        scorer.move("s12", ("l3",))
        cand = scorer.score()          # only affected rows were rebuilt
        scorer.move("s12", home)       # revert is just another move
    """

    def __init__(
        self,
        inst: DistributedWorkflowInstance,
        network: NetworkModel,
        *,
        sizes: SizeModel,
        costs: CostModel,
        rules: Sequence[str] = ("R1R2",),
        exec_slots: int | None = 1,
    ) -> None:
        rules = tuple(rules)
        if rules not in _SUPPORTED_RULES:
            raise UnsupportedRules(
                f"no flat-domain replay for rule list {rules!r}; "
                f"supported: {sorted(_SUPPORTED_RULES)}"
            )
        self.rules = rules
        self.exec_slots = exec_slots
        self.locations = sorted(inst.locations)
        self.network = network.bind(inst.locations)

        wf = inst.workflow
        topo = wf.topological_steps()
        self.topo_index = {s: i for i, s in enumerate(topo)}
        self.steps = topo

        # Static per-step / per-datum tables.
        self.in_sorted: dict[str, tuple[str, ...]] = {}
        self.out_sorted: dict[str, tuple[str, ...]] = {}
        self.exec_s: dict[str, float] = {}
        self._pretty_prefix: dict[str, str] = {}
        self.port_of: dict[str, str] = dict(inst.placement)
        self.producers: dict[str, tuple[str, ...]] = {}
        self.consumers: dict[str, tuple[str, ...]] = {}
        self.bytes_of: dict[str, int] = {}
        for s in topo:
            ins = tuple(sorted(inst.in_data(s)))
            outs = tuple(sorted(inst.out_data(s)))
            self.in_sorted[s] = ins
            self.out_sorted[s] = outs
            self.exec_s[s] = max(costs.exec_s(s), 0.0)
            self._pretty_prefix[s] = (
                f"exec({s},{{{','.join(ins)}}}->{{{','.join(outs)}}},{{"
            )
            for d in ins:
                if d not in self.producers:
                    self.producers[d] = tuple(
                        sorted(inst.producers_of_data(d))
                    )
            for d in outs:
                if d not in self.consumers:
                    self.consumers[d] = tuple(
                        sorted(inst.consumers_of_data(d))
                    )
                if d not in self.bytes_of:
                    self.bytes_of[d] = sizes.bytes_of(d)

        # Transfer link cache per ordered location pair.
        self._link = {
            (a, b): self.network.link(a, b)
            for a in self.locations
            for b in self.locations
        }

        # Mutable search state, established by reset().
        self.mapping: dict[str, tuple[str, ...]] = {}
        self._queues: dict[str, list[str]] = {}
        self._rows: dict[str, list] = {}
        self._pretty: dict[str, str] = {}
        #: Exec events ordered by pretty string (simulate()'s order), kept
        #: sorted incrementally — a move changes exactly one entry.
        self._exec_sorted: list[tuple[str, str]] = []
        #: R3 kill set of the current state, shared between the byte screen
        #: and the full score; invalidated by move()/reset().
        self._killed_cache: dict[str, set[tuple]] | None = None

    # -- state construction -------------------------------------------------
    def reset(self, mapping: Mapping[str, Sequence[str]]) -> None:
        """(Re)build every row for ``mapping``."""
        self.mapping = {s: tuple(ls) for s, ls in mapping.items()}
        self._pretty = {
            s: self._pretty_prefix[s] + ",".join(self.mapping[s]) + "})"
            for s in self.steps
        }
        self._exec_sorted = sorted(
            (p, s) for s, p in self._pretty.items()
        )
        self._killed_cache = None
        self._queues = {l: [] for l in self.locations}
        for s in self.steps:  # topo order == work-queue order
            for l in self.mapping[s]:
                self._queues[l].append(s)
        self._rows = {l: self._build_row(l) for l in self.locations}

    def _build_row(self, loc: str) -> list:
        """Blocks ``(step, recvs, sends)`` at ``loc`` after the R1/R2 scan.

        ``recvs`` are ``(port, src)``, ``sends`` are ``(data, port, dst)``
        pairs in Def.-10 emission order; with ``rules == ()`` the raw
        encoding is kept verbatim.
        """
        mapping = self.mapping
        dedupe = bool(self.rules)  # any supported non-empty list starts R1R2
        seen: set[tuple] = set()
        row: list = []
        for s in self._queues[loc]:
            recvs: list[tuple[str, str]] = []
            for d in self.in_sorted[s]:
                port = self.port_of[d]
                for ps in self.producers.get(d, ()):
                    for lj in mapping[ps]:
                        if dedupe:
                            if lj == loc:  # R1
                                continue
                            key = ("r", port, lj)
                            if key in seen:  # R2
                                continue
                            seen.add(key)
                        recvs.append((port, lj))
            sends: list[tuple[str, str, str]] = []
            for d in self.out_sorted[s]:
                port = self.port_of[d]
                for sk in self.consumers.get(d, ()):
                    for lj in mapping[sk]:
                        if dedupe:
                            if lj == loc:  # R1
                                continue
                            key = ("s", d, port, lj)
                            if key in seen:  # R2
                                continue
                            seen.add(key)
                        sends.append((d, port, lj))
            row.append((s, recvs, sends))
        return row

    def action_count(self) -> int:
        """Predicate occurrences in the current (rewritten) plan."""
        return sum(
            1 + len(recvs) + len(sends)
            for row in self._rows.values()
            for _, recvs, sends in row
        )

    # -- incremental patch --------------------------------------------------
    def move(self, step: str, new_locs: tuple[str, ...]) -> None:
        """Re-home ``step``; rebuilds only the rows its placement touches."""
        old_locs = self.mapping[step]
        if new_locs == old_locs:
            return
        affected = set(old_locs) | set(new_locs)
        for d in self.in_sorted[step]:
            for ps in self.producers.get(d, ()):
                affected.update(self.mapping[ps])
        for d in self.out_sorted[step]:
            for sk in self.consumers.get(d, ()):
                affected.update(self.mapping[sk])

        self.mapping[step] = new_locs
        old_pretty = self._pretty[step]
        new_pretty = self._pretty_prefix[step] + ",".join(new_locs) + "})"
        self._pretty[step] = new_pretty
        del self._exec_sorted[
            bisect_left(self._exec_sorted, (old_pretty, step))
        ]
        insort(self._exec_sorted, (new_pretty, step))
        self._killed_cache = None
        ti = self.topo_index
        for l in old_locs:
            if l not in new_locs:
                self._queues[l].remove(step)
        for l in new_locs:
            if l not in old_locs:
                q = self._queues[l]
                lo, hi = 0, len(q)
                key = ti[step]
                while lo < hi:
                    mid = (lo + hi) // 2
                    if ti[q[mid]] < key:
                        lo = mid + 1
                    else:
                        hi = mid
                q.insert(lo, step)
        for l in affected:
            self._rows[l] = self._build_row(l)

    # -- scoring ------------------------------------------------------------
    def score(self) -> tuple[float, int]:
        """``(makespan, cross_bytes)`` of the current mapping.

        Bit-identical to ``simulate(rewrite(encode(inst under mapping)),
        exec_slots=...)`` — see the module docstring.
        """
        mapping = self.mapping
        rows = self._rows

        # R3 survivor filtering (per evaluation, over the cached rows).
        killed: dict[str, set[tuple]] = {}
        if "R3" in self.rules:
            killed = self._r3_killed()

        # 1. Exec events, ordered exactly like simulate(): by pretty()
        #    (the order is maintained incrementally across moves).
        exec_order = [s for _, s in self._exec_sorted]
        exec_eid = {s: i for i, s in enumerate(exec_order)}
        n_exec = len(exec_order)
        preds: list[list[int]] = [[] for _ in range(n_exec)]
        durations: list[float] = [self.exec_s[s] for s in exec_order]
        exec_locations: list = [
            tuple(sorted(set(mapping[s]))) for s in exec_order
        ]

        # 2. Comm events in node order; channel FIFOs as we go.
        send_data: dict[int, str] = {}  # send event id -> datum carried
        chan_sends: dict[tuple[str, str, str], list[int]] = {}
        chan_recvs: dict[tuple[str, str, str], list[int]] = {}
        eid = n_exec
        for loc in self.locations:
            kset = killed.get(loc, ())
            for s, recvs, sends in rows[loc]:
                xe = exec_eid[s]
                xpreds = preds[xe]
                for i, (port, src) in enumerate(recvs):
                    if kset and ("r", s, i) in kset:
                        continue
                    preds.append([])
                    durations.append(0.0)
                    exec_locations.append(None)
                    xpreds.append(eid)
                    chan_recvs.setdefault((src, loc, port), []).append(eid)
                    eid += 1
                for i, (d, port, dst) in enumerate(sends):
                    if kset and ("s", s, i) in kset:
                        continue
                    preds.append([xe])
                    durations.append(0.0)
                    exec_locations.append(None)
                    chan_sends.setdefault((loc, dst, port), []).append(eid)
                    send_data[eid] = d
                    eid += 1

        # 3. FIFO channel matching (k-th send ↔ k-th recv).
        comm_edges: dict[int, tuple[int, float]] = {}
        cross_bytes = 0
        link = self._link
        bytes_of = self.bytes_of
        for chan, rlist in chan_recvs.items():
            slist = chan_sends.get(chan, [])
            if len(rlist) > len(slist):
                raise SimulationError(
                    f"{len(rlist) - len(slist)} recv(s) on channel {chan} "
                    "have no matching send — the plan would deadlock"
                )
            src, dst, _port = chan
            lnk = link[(src, dst)]
            for seid, reid in zip(slist, rlist):
                nbytes = bytes_of[send_data[seid]]
                transfer = lnk.transfer_s(nbytes)
                comm_edges[reid] = (seid, transfer)
                preds[reid].append(seid)
                if src != dst:
                    cross_bytes += nbytes

        # 4. Shared scheduling core.
        _, finish, _, unfinished = run_event_schedule(
            preds,
            durations,
            exec_locations,
            comm_edges,
            self.exec_slots,
            self.locations,
        )
        if unfinished:
            raise SimulationError(
                "cyclic channel wait — the plan cannot be replayed"
            )
        makespan = max(finish, default=0.0)
        return makespan, cross_bytes

    def cross_bytes_only(self) -> int:
        """Exact cross-location bytes of the current mapping, no schedule.

        The ``objective="bytes"`` fast path: the byte total depends only on
        which sends survive rewriting and pair with a recv, so candidate
        moves that do not beat the incumbent byte count can be rejected
        without running the event schedule at all.
        """
        rows = self._rows
        killed: dict[str, set[tuple]] = {}
        if "R3" in self.rules:
            killed = self._r3_killed()
        chan_sends: dict[tuple[str, str, str], list[str]] = {}
        chan_recvs: dict[tuple[str, str, str], int] = {}
        for loc in self.locations:
            kset = killed.get(loc, ())
            for s, recvs, sends in rows[loc]:
                for i, (port, src) in enumerate(recvs):
                    if kset and ("r", s, i) in kset:
                        continue
                    key = (src, loc, port)
                    chan_recvs[key] = chan_recvs.get(key, 0) + 1
                for i, (d, port, dst) in enumerate(sends):
                    if kset and ("s", s, i) in kset:
                        continue
                    chan_sends.setdefault((loc, dst, port), []).append(d)
        total = 0
        bytes_of = self.bytes_of
        for chan, n_recv in chan_recvs.items():
            src, dst, _port = chan
            if src == dst:
                continue
            for d in chan_sends.get(chan, [])[:n_recv]:
                total += bytes_of[d]
        return total

    # -- R3 over the cached rows --------------------------------------------
    def _r3_killed(self) -> dict[str, set[tuple]]:
        """Positions deleted by R3, as ``{loc: {("s"|"r", step, idx)}}``.

        Mirrors :func:`repro_torch.core.flat.rewrite_r3` over the row structure:
        tables over the R1R2 survivors, then one pass over the surviving
        sends in system program order, deleting each qualifying send at its
        source together with the first surviving matching recv at its
        destination.  Memoised per state so the byte screen and the full
        score of the same candidate share one pass.
        """
        if self._killed_cache is not None:
            return self._killed_cache
        mapping = self.mapping
        rows = self._rows

        produces: dict[str, set[str]] = {}
        for s in self.steps:
            outs = self.out_sorted[s]
            if not outs:
                continue
            for l in mapping[s]:
                produces.setdefault(l, set()).update(outs)

        # FIFO indexes over surviving comm positions, plus the live
        # port → data table (both over the R1R2 survivors, exactly like
        # the flat engine builds them over the alive actions).
        send_fifo: dict[tuple, list[tuple]] = {}
        recv_fifo: dict[tuple, list[tuple]] = {}
        port_data: dict[str, set[str]] = {}
        snapshot: list[tuple] = []
        for loc in self.locations:
            for s, recvs, sends in rows[loc]:
                for i, (port, src) in enumerate(recvs):
                    recv_fifo.setdefault((loc, port, src), []).append(
                        ("r", s, i)
                    )
                for i, (d, port, dst) in enumerate(sends):
                    port_data.setdefault(port, set()).add(d)
                    send_fifo.setdefault((loc, d, port, dst), []).append(
                        ("s", s, i)
                    )
                    snapshot.append((loc, d, port, dst))

        killed: dict[str, set[tuple]] = {}
        heads: dict[tuple, int] = {}
        for loc, d, port, dst in snapshot:
            if loc == dst:
                continue
            if len(port_data[port]) != 1:
                continue
            if d not in produces.get(dst, ()):
                continue
            skey = (loc, d, port, dst)
            rkey = (dst, port, loc)
            sq = send_fifo.get(skey)
            rq = recv_fifo.get(rkey)
            if sq is None or rq is None:
                continue
            shead = heads.get(skey, 0)
            rhead = heads.get(rkey, 0)
            if shead >= len(sq) or rhead >= len(rq):
                continue
            heads[skey] = shead + 1
            heads[rkey] = rhead + 1
            killed.setdefault(loc, set()).add(sq[shead])
            killed.setdefault(dst, set()).add(rq[rhead])
        self._killed_cache = killed
        return killed
