"""Workflow graph model — Definitions 1-7 of the SWIRL paper.

A workflow is a directed bipartite graph ``W = (S, P, D)`` of *steps* and
*ports* (Def. 1).  A *workflow instance* adds data elements and their port
placement (Def. 3).  A *distributed workflow* adds locations and a step ->
locations mapping (Def. 5); an *instance* of it carries both (Def. 7).

All containers are immutable once constructed (tuples / frozensets) so that
graphs can be hashed, compared and safely shared between the encoder, the
optimiser and the runtime scheduler.

Accessor complexity: ``In``/``Out`` projections and the data/port lookups
are served from lazily-built adjacency indexes (one linear pass over the
dependency relation, cached on the instance), so encoding and scheduling
stay linear in workflow size — the original per-call relation scans made
``⟦·⟧`` quadratic and 10k-step plans intractable.  Immutability makes the
caches safe: every ``dataclasses.replace`` produces a fresh instance with
fresh (empty) caches.
"""

from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence


def _fset(xs: Iterable[str]) -> frozenset[str]:
    return frozenset(xs)


_EMPTY: frozenset[str] = frozenset()


@dataclass(frozen=True)
class Workflow:
    """Def. 1 — ``W = (S, P, D)`` with ``D ⊆ (S×P) ∪ (P×S)``."""

    steps: frozenset[str]
    ports: frozenset[str]
    deps: frozenset[tuple[str, str]]

    def __post_init__(self) -> None:
        if self.steps & self.ports:
            raise ValueError(
                f"steps and ports must be disjoint: {sorted(self.steps & self.ports)}"
            )
        for a, b in self.deps:
            s2p = a in self.steps and b in self.ports
            p2s = a in self.ports and b in self.steps
            if not (s2p or p2s):
                raise ValueError(f"dependency {(a, b)} is not (S×P) ∪ (P×S)")

    # -- adjacency indexes (lazy, cached; fields are immutable) -------------
    def _adjacency(self) -> dict[str, dict[str, frozenset[str]]]:
        idx = self.__dict__.get("_adj")
        if idx is None:
            in_ports: dict[str, set[str]] = {}
            out_ports: dict[str, set[str]] = {}
            in_steps: dict[str, set[str]] = {}
            out_steps: dict[str, set[str]] = {}
            steps, ports = self.steps, self.ports
            for a, b in self.deps:
                if a in steps:  # (s, p)
                    out_ports.setdefault(a, set()).add(b)
                    in_steps.setdefault(b, set()).add(a)
                else:  # (p, s)
                    in_ports.setdefault(b, set()).add(a)
                    out_steps.setdefault(a, set()).add(b)
            idx = {
                "in_ports": {k: _fset(v) for k, v in in_ports.items()},
                "out_ports": {k: _fset(v) for k, v in out_ports.items()},
                "in_steps": {k: _fset(v) for k, v in in_steps.items()},
                "out_steps": {k: _fset(v) for k, v in out_steps.items()},
            }
            object.__setattr__(self, "_adj", idx)
        return idx

    # -- Def. 2 ------------------------------------------------------------
    def in_ports(self, s: str) -> frozenset[str]:
        """``In(s) = {p | (p, s) ∈ D}``."""
        return self._adjacency()["in_ports"].get(s, _EMPTY)

    def out_ports(self, s: str) -> frozenset[str]:
        """``Out(s) = {p | (s, p) ∈ D}``."""
        return self._adjacency()["out_ports"].get(s, _EMPTY)

    def in_steps(self, p: str) -> frozenset[str]:
        """``In(p) = {s | (s, p) ∈ D}`` — the producers of port ``p``."""
        return self._adjacency()["in_steps"].get(p, _EMPTY)

    def out_steps(self, p: str) -> frozenset[str]:
        """``Out(p) = {s | (p, s) ∈ D}`` — the consumers of port ``p``."""
        return self._adjacency()["out_steps"].get(p, _EMPTY)

    # -- helpers ------------------------------------------------------------
    def initial_ports(self) -> frozenset[str]:
        """Ports with no producing step (workflow inputs, cf. App. B ``s_0``)."""
        return _fset(p for p in self.ports if not self.in_steps(p))

    def topological_steps(self) -> tuple[str, ...]:
        """Steps in a deterministic topological order (raises on cycles).

        Cached: every ``work_queue`` projection reuses one traversal.
        """
        cached = self.__dict__.get("_topo")
        if cached is not None:
            return cached
        # In-degree counts *distinct* upstream steps (a producer feeding a
        # consumer through several ports is still one completion event) —
        # counting per (port, producer) pair would leave the consumer's
        # counter positive forever and misreport an acyclic DAG as cyclic.
        indeg = {s: 0 for s in self.steps}
        for s in self.steps:
            ups: set[str] = set()
            for p in self.in_ports(s):
                ups |= self.in_steps(p)
            indeg[s] = len(ups)
        order: list[str] = []
        ready = [s for s, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        seen: set[str] = set()
        while ready:
            s = heapq.heappop(ready)
            order.append(s)
            seen.add(s)
            nxt: set[str] = set()
            for p in self.out_ports(s):
                nxt |= self.out_steps(p)
            for t in nxt:
                indeg[t] -= 1
                if indeg[t] == 0 and t not in seen:
                    heapq.heappush(ready, t)
        if len(order) != len(self.steps):
            raise ValueError("workflow graph contains a cycle")
        out = tuple(order)
        object.__setattr__(self, "_topo", out)
        return out


def make_workflow(
    steps: Iterable[str],
    ports: Iterable[str],
    deps: Iterable[tuple[str, str]],
) -> Workflow:
    return Workflow(_fset(steps), _fset(ports), frozenset(tuple(d) for d in deps))


@dataclass(frozen=True)
class WorkflowInstance:
    """Def. 3 — ``(W, D, I)`` with ``I ⊆ D×P`` mapping data to its port.

    ``placement`` maps each data element to the single port containing it
    (the paper treats ``I`` as a relation; every example places each data
    element on exactly one port, which is what we enforce).
    """

    workflow: Workflow
    data: frozenset[str]
    placement: Mapping[str, str]  # d -> p

    def __post_init__(self) -> None:
        object.__setattr__(self, "placement", dict(self.placement))
        for d, p in self.placement.items():
            if d not in self.data:
                raise ValueError(f"placement references unknown data {d!r}")
            if p not in self.workflow.ports:
                raise ValueError(f"placement references unknown port {p!r}")
        missing = self.data - set(self.placement)
        if missing:
            raise ValueError(f"data without a port: {sorted(missing)}")

    def _port_index(self) -> dict[str, frozenset[str]]:
        idx = self.__dict__.get("_by_port")
        if idx is None:
            by_port: dict[str, set[str]] = {}
            for d, p in self.placement.items():
                by_port.setdefault(p, set()).add(d)
            idx = {p: _fset(ds) for p, ds in by_port.items()}
            object.__setattr__(self, "_by_port", idx)
        return idx

    def port_of(self, d: str) -> str:
        """``I(d)`` — the port holding data element ``d``."""
        return self.placement[d]

    def data_on(self, p: str) -> frozenset[str]:
        return self._port_index().get(p, _EMPTY)

    # -- Def. 4 ------------------------------------------------------------
    def in_data(self, s: str) -> frozenset[str]:
        """``In^D(s) = {d | (d, p) ∈ I ∧ p ∈ In(s)}``."""
        by_port = self._port_index()
        out: frozenset[str] = _EMPTY
        for p in self.workflow.in_ports(s):
            out = out | by_port.get(p, _EMPTY)
        return out

    def out_data(self, s: str) -> frozenset[str]:
        """``Out^D(s) = {d | (d, p) ∈ I ∧ p ∈ Out(s)}``."""
        by_port = self._port_index()
        out: frozenset[str] = _EMPTY
        for p in self.workflow.out_ports(s):
            out = out | by_port.get(p, _EMPTY)
        return out


@dataclass(frozen=True)
class DistributedWorkflow:
    """Def. 5 — ``(W, L, M)`` with ``M ⊆ S×L``."""

    workflow: Workflow
    locations: frozenset[str]
    mapping: Mapping[str, tuple[str, ...]]  # s -> locations (deterministic order)

    def __post_init__(self) -> None:
        norm = {s: tuple(ls) for s, ls in dict(self.mapping).items()}
        object.__setattr__(self, "mapping", norm)
        for s, ls in norm.items():
            if s not in self.workflow.steps:
                raise ValueError(f"mapping references unknown step {s!r}")
            if not ls:
                raise ValueError(f"step {s!r} mapped to no location")
            for l in ls:
                if l not in self.locations:
                    raise ValueError(f"mapping references unknown location {l!r}")
        unmapped = self.workflow.steps - set(norm)
        if unmapped:
            raise ValueError(f"steps without a location: {sorted(unmapped)}")

    def locs_of(self, s: str) -> tuple[str, ...]:
        """``M(s)``."""
        return self.mapping[s]

    # -- Def. 6 ------------------------------------------------------------
    def work_queue(self, l: str) -> tuple[str, ...]:
        """``Q(l) = {s | l ∈ M(s)}`` in deterministic (topological) order."""
        queues = self.__dict__.get("_queues")
        if queues is None:
            queues = {loc: [] for loc in self.locations}
            for s in self.workflow.topological_steps():
                for loc in self.mapping[s]:
                    queues[loc].append(s)
            queues = {loc: tuple(q) for loc, q in queues.items()}
            object.__setattr__(self, "_queues", queues)
        return queues[l]


@dataclass(frozen=True)
class DistributedWorkflowInstance:
    """Def. 7 — ``I = (W, L, M, D, I)``.

    ``initial_data`` optionally records the instance data distribution
    ``G(l)`` (Sec. 3.2): which data elements are already resident on each
    location before execution starts (e.g. the inputs held by ``l^d``).
    """

    workflow: Workflow
    locations: frozenset[str]
    mapping: Mapping[str, tuple[str, ...]]
    data: frozenset[str]
    placement: Mapping[str, str]
    initial_data: Mapping[str, frozenset[str]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        # Delegate validation to the component models.
        object.__setattr__(self, "mapping", dict(self.mapping))
        object.__setattr__(self, "placement", dict(self.placement))
        object.__setattr__(
            self,
            "initial_data",
            {l: frozenset(ds) for l, ds in dict(self.initial_data).items()},
        )
        # Validate through the component models and keep them: the
        # ``distributed``/``instance`` projections (and everything routed
        # through them — work queues, In^D/Out^D) are served from these
        # cached views instead of re-validating per call.
        object.__setattr__(
            self,
            "_distributed",
            DistributedWorkflow(self.workflow, self.locations, self.mapping),
        )
        object.__setattr__(
            self,
            "_instance",
            WorkflowInstance(self.workflow, self.data, self.placement),
        )
        for l, ds in self.initial_data.items():
            if l not in self.locations:
                raise ValueError(f"initial data on unknown location {l!r}")
            if not ds <= self.data:
                raise ValueError(f"unknown initial data on {l!r}: {sorted(ds - self.data)}")

    # Convenience projections -------------------------------------------------
    @property
    def distributed(self) -> DistributedWorkflow:
        return self._distributed  # type: ignore[attr-defined]

    @property
    def instance(self) -> WorkflowInstance:
        return self._instance  # type: ignore[attr-defined]

    def locs_of(self, s: str) -> tuple[str, ...]:
        return self.mapping[s]

    def work_queue(self, l: str) -> tuple[str, ...]:
        return self.distributed.work_queue(l)

    def port_of(self, d: str) -> str:
        return self.placement[d]

    def _memo(self, name: str, key: str, compute) -> frozenset[str]:
        cache = self.__dict__.get(name)
        if cache is None:
            cache = {}
            object.__setattr__(self, name, cache)
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = compute(key)
        return hit

    def in_data(self, s: str) -> frozenset[str]:
        return self._memo("_in_data", s, self.instance.in_data)

    def out_data(self, s: str) -> frozenset[str]:
        return self._memo("_out_data", s, self.instance.out_data)

    def producers_of_data(self, d: str) -> frozenset[str]:
        """``In(I(d))`` — steps producing the port that holds ``d``."""
        return self.workflow.in_steps(self.placement[d])

    def consumers_of_data(self, d: str) -> frozenset[str]:
        """``Out(I(d))`` — steps consuming the port that holds ``d``."""
        return self.workflow.out_steps(self.placement[d])

    def g(self, l: str) -> frozenset[str]:
        """``G(l)`` — instance data initially resident on ``l``."""
        return self.initial_data.get(l, frozenset())

    def with_initial_data(
        self, initial: Mapping[str, Iterable[str]]
    ) -> "DistributedWorkflowInstance":
        return dataclasses.replace(
            self, initial_data={l: frozenset(ds) for l, ds in initial.items()}
        )
