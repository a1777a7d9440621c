"""Placement search — decide ``M(s)`` against the network cost model.

A copy of ``repro/sched/place.py``.

Two phases, per the classic list-scheduling literature (HEFT; Bux & Leser's
SWfMS survey):

1. :func:`greedy_placement` — critical-path (upward-rank) ordering, then
   earliest-finish-time assignment per step, accounting for where each input
   datum lives and what the link to it costs.  ``objective="bytes"`` swaps
   the score for incoming cross-location bytes (tie-broken by finish time).
2. :func:`refine_placement` — first-improvement local search: try moving
   each movable step to every other location, score the *real* plan under
   the candidate mapping, keep strict improvements.  Scoring is
   incremental (:class:`~repro_torch.sched.incremental.PlacementScorer`): a move
   patches the affected per-location rows and comm-key index entries and
   re-runs the event schedule through the simulator's array core —
   bit-identical to re-encode + rewrite + simulate, without building
   trees — under an eval budget that keeps 10k-step searches tractable.

Spatially-constrained steps (``|M(s)| > 1`` — collectives like the
trainer's ``gradsync``) and explicitly pinned steps are never moved: their
multi-location mapping is semantics, not scheduling.

Candidates are scored on the re-encoded system *after* the paper's R1+R2
rewrite — the loop between placement and rewriting: the scheduler
co-locates producers with consumers, which turns remote sends into local
ones that R1 then deletes, and the score sees exactly the plan that will be
lowered.

:func:`auto_placement` packages both phases plus the round-robin baseline
into a :class:`~repro_torch.sched.report.ScheduleReport`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Mapping

from repro_torch.core.encoding import encode
from repro_torch.core.graph import DistributedWorkflowInstance
from repro_torch.core.optimizer import REWRITE_RULES

from .estimate import CostModel, SizeModel
from .incremental import PlacementScorer, UnsupportedRules
from .network import NetworkModel
from .report import ScheduleReport
from .simulate import Simulation, simulate

#: Lower bound on a step's cost during ranking, so upward ranks strictly
#: decrease along dependency chains (producers always rank above consumers).
_EPS = 1e-9

Placement = dict[str, tuple[str, ...]]


def movable_steps(
    inst: DistributedWorkflowInstance, pin: Iterable[str] = ()
) -> tuple[str, ...]:
    """Steps the scheduler may move: single-location and not pinned."""
    pinned = set(pin)
    return tuple(
        sorted(
            s
            for s in inst.workflow.steps
            if s not in pinned and len(inst.locs_of(s)) == 1
        )
    )


def round_robin_placement(
    inst: DistributedWorkflowInstance,
    *,
    pin: Iterable[str] = (),
) -> Placement:
    """The naive baseline: movable steps dealt round-robin over locations."""
    locs = sorted(inst.locations)
    mapping: Placement = {s: tuple(ls) for s, ls in inst.mapping.items()}
    for i, s in enumerate(movable_steps(inst, pin)):
        mapping[s] = (locs[i % len(locs)],)
    return mapping


def _placed(
    inst: DistributedWorkflowInstance, mapping: Mapping[str, tuple[str, ...]]
) -> DistributedWorkflowInstance:
    """The instance with ``M`` swapped; locations and ``G`` are kept."""
    return dataclasses.replace(inst, mapping=dict(mapping))


def evaluate_placement(
    inst: DistributedWorkflowInstance,
    mapping: Mapping[str, tuple[str, ...]],
    network: NetworkModel,
    *,
    sizes: SizeModel,
    costs: CostModel,
    exec_slots: int | None = 1,
    rules: tuple[str, ...] = ("R1R2",),
) -> Simulation:
    """Re-encode under ``mapping``, apply ``rules``, simulate the result.

    ``rules`` must match what the caller will actually apply to the chosen
    placement (``Plan.schedule`` passes its recorded rule list), so the
    score sees exactly the plan that will be lowered.
    """
    system = encode(_placed(inst, mapping))
    for rule in rules:
        system, _ = REWRITE_RULES[rule](system)
    return simulate(
        system,
        network=network,
        sizes=sizes,
        costs=costs,
        exec_slots=exec_slots,
    )


def _upward_ranks(
    inst: DistributedWorkflowInstance,
    network: NetworkModel,
    sizes: SizeModel,
    costs: CostModel,
) -> dict[str, float]:
    """HEFT upward ranks with location-averaged transfer costs."""
    locs = sorted(inst.locations)
    pairs = [(a, b) for a in locs for b in locs if a != b]

    def avg_transfer(nbytes: int) -> float:
        if not pairs:
            return 0.0
        return sum(
            network.transfer_s(nbytes, a, b) for a, b in pairs
        ) / len(pairs)

    ranks: dict[str, float] = {}
    for s in reversed(inst.workflow.topological_steps()):
        best = 0.0
        for d in inst.out_data(s):
            t = avg_transfer(sizes.bytes_of(d))
            for c in inst.consumers_of_data(d):
                best = max(best, t + ranks.get(c, 0.0))
        ranks[s] = max(costs.exec_s(s), _EPS) + best
    return ranks


def greedy_placement(
    inst: DistributedWorkflowInstance,
    network: NetworkModel,
    *,
    sizes: SizeModel,
    costs: CostModel,
    objective: str = "makespan",
    pin: Iterable[str] = (),
) -> Placement:
    """Critical-path-first earliest-finish-time assignment (see module doc)."""
    network = network.bind(inst.locations)
    locs = sorted(inst.locations)
    movable = set(movable_steps(inst, pin))
    ranks = _upward_ranks(inst, network, sizes, costs)
    order = sorted(inst.workflow.steps, key=lambda s: (-ranks[s], s))

    mapping: Placement = {s: tuple(ls) for s, ls in inst.mapping.items()}
    avail = {l: 0.0 for l in locs}
    # datum -> (resident locations, time it becomes available there)
    data_at: dict[str, tuple[tuple[str, ...], float]] = {}
    for l, ds in sorted(inst.initial_data.items()):
        for d in ds:
            # a datum may start resident on several locations (G lists them
            # independently); keep every copy so the nearest one is charged
            data_at[d] = (data_at.get(d, ((), 0.0))[0] + (l,), 0.0)

    def ready_at(s: str, l: str) -> tuple[float, int]:
        """(earliest input-complete time, incoming cross-location bytes)."""
        t, xbytes = 0.0, 0
        for d in inst.in_data(s):
            if d not in data_at:
                continue  # unsourced datum: assume resident everywhere
            srcs, t_src = data_at[d]
            nbytes = sizes.bytes_of(d)
            src = min(srcs, key=lambda a: network.transfer_s(nbytes, a, l))
            t = max(t, t_src + network.transfer_s(nbytes, src, l))
            if src != l:
                xbytes += nbytes
        return t, xbytes

    for s in order:
        cost = max(costs.exec_s(s), 0.0)
        if s in movable:
            best = None
            for l in locs:
                t_ready, xbytes = ready_at(s, l)
                eft = max(avail[l], t_ready) + cost
                score = (
                    (eft, xbytes, l)
                    if objective == "makespan"
                    else (xbytes, eft, l)
                )
                if best is None or score < best[0]:
                    best = (score, l, eft)
            _, chosen, eft = best
            mapping[s] = (chosen,)
            avail[chosen] = eft
            finish_locs = [chosen]
        else:
            finish_locs = list(mapping[s])
            eft = (
                max(
                    max(avail[l], ready_at(s, l)[0]) for l in finish_locs
                )
                + cost
            )
            for l in finish_locs:
                avail[l] = eft
        for d in inst.out_data(s):
            data_at[d] = (tuple(finish_locs), eft)
    return mapping


#: Operation budget behind the default ``max_evals`` policy: the local
#: search may spend roughly this many action-evaluations (candidate moves ×
#: plan size) before stopping, so refinement cost stays near-constant as
#: plans grow — a 20-step plan gets an exhaustive search, a 10k-step plan an
#: anytime one.  Explicit ``max_evals`` overrides.
_EVAL_OP_BUDGET = 2_500_000


def _default_max_evals(n_actions: int) -> int:
    return max(512, _EVAL_OP_BUDGET // max(1, n_actions))


def refine_placement(
    inst: DistributedWorkflowInstance,
    mapping: Placement,
    network: NetworkModel,
    *,
    sizes: SizeModel,
    costs: CostModel,
    objective: str = "makespan",
    pin: Iterable[str] = (),
    max_rounds: int = 3,
    rules: tuple[str, ...] = ("R1R2",),
    max_evals: int | None = None,
) -> tuple[Placement, Simulation]:
    """First-improvement local search over single-step moves.

    Candidates are scored by the incremental
    :class:`~repro_torch.sched.incremental.PlacementScorer`: when one step moves,
    only the per-location rows and comm-key index entries its placement
    touches are patched, and the event schedule re-runs through the shared
    array core — no re-encoding, no trace trees, bit-identical scores to
    :func:`evaluate_placement` (differentially tested).  Under
    ``objective="bytes"`` a candidate is first screened by its exact byte
    delta and only simulated when it can actually improve the incumbent.

    ``max_evals`` bounds the number of scored candidates (an *anytime*
    search); the default policy scales it inversely with plan size so
    refinement stays tractable at 10k steps.  Rule lists the scorer cannot
    replay fall back to the original re-encode-per-candidate loop.
    """
    network = network.bind(inst.locations)
    locs = sorted(inst.locations)
    movable = movable_steps(inst, pin)

    try:
        scorer = PlacementScorer(
            inst, network, sizes=sizes, costs=costs, rules=rules
        )
    except UnsupportedRules:
        return _refine_placement_tree(
            inst, mapping, network, sizes=sizes, costs=costs,
            objective=objective, pin=pin, max_rounds=max_rounds, rules=rules,
            max_evals=max_evals,
        )

    def score(makespan: float, cross_bytes: int) -> tuple[float, float]:
        if objective == "bytes":
            return (float(cross_bytes), makespan)
        return (makespan, float(cross_bytes))

    current = dict(mapping)
    scorer.reset(current)
    if max_evals is None:
        max_evals = _default_max_evals(scorer.action_count())
    best_score = score(*scorer.score())
    evals = 1
    for _ in range(max_rounds):
        improved = False
        for s in movable:
            home = current[s]
            for l in locs:
                if (l,) == home:
                    continue
                if evals >= max_evals:
                    break
                scorer.move(s, (l,))
                evals += 1
                if objective == "bytes":
                    # Exact byte screen: if the primary key cannot improve,
                    # skip the event schedule entirely.
                    if scorer.cross_bytes_only() > best_score[0]:
                        scorer.move(s, home)
                        continue
                cand = score(*scorer.score())
                if cand < best_score:
                    best_score = cand
                    home = (l,)
                    current[s] = (l,)
                    improved = True
                else:
                    scorer.move(s, home)
            if evals >= max_evals:
                break
        if not improved or evals >= max_evals:
            break
    best_sim = evaluate_placement(
        inst, current, network, sizes=sizes, costs=costs, rules=rules
    )
    return current, best_sim


def _refine_placement_tree(
    inst: DistributedWorkflowInstance,
    mapping: Placement,
    network: NetworkModel,
    *,
    sizes: SizeModel,
    costs: CostModel,
    objective: str,
    pin: Iterable[str],
    max_rounds: int,
    rules: tuple[str, ...],
    max_evals: int | None = None,
) -> tuple[Placement, Simulation]:
    """The original re-encode-per-candidate loop (rule-list fallback).

    An explicit ``max_evals`` caps candidate evaluations here too — the
    per-candidate cost on this path is the superlinear one, so dropping the
    caller's anytime budget would be worst exactly where it matters.  With
    ``max_evals=None`` the loop is exhaustive (legacy behaviour; this
    fallback is only reached for custom rule lists).
    """
    locs = sorted(inst.locations)
    movable = movable_steps(inst, pin)

    def score(sim: Simulation) -> tuple[float, float]:
        if objective == "bytes":
            return (float(sim.cross_bytes), sim.makespan)
        return (sim.makespan, float(sim.cross_bytes))

    current = dict(mapping)
    best_sim = evaluate_placement(
        inst, current, network, sizes=sizes, costs=costs, rules=rules
    )
    best_score = score(best_sim)
    evals = 1
    exhausted = False
    for _ in range(max_rounds):
        improved = False
        for s in movable:
            home = current[s]
            for l in locs:
                if (l,) == home:
                    continue
                if max_evals is not None and evals >= max_evals:
                    exhausted = True
                    break
                current[s] = (l,)
                evals += 1
                sim = evaluate_placement(
                    inst, current, network,
                    sizes=sizes, costs=costs, rules=rules,
                )
                if score(sim) < best_score:
                    best_score, best_sim = score(sim), sim
                    home = (l,)
                    improved = True
            current[s] = home
            if exhausted:
                break
        if not improved or exhausted:
            break
    return current, best_sim


def auto_placement(
    inst: DistributedWorkflowInstance,
    network: NetworkModel | None = None,
    *,
    objective: str = "makespan",
    sizes: SizeModel | None = None,
    costs: CostModel | None = None,
    refine: bool = True,
    pin: Iterable[str] = (),
    rules: tuple[str, ...] = ("R1R2",),
    max_evals: int | None = None,
) -> ScheduleReport:
    """Greedy + (optional) local search, reported against round-robin.

    ``max_evals`` bounds the refinement's candidate evaluations (see
    :func:`refine_placement`); the default policy keeps search cost
    near-constant across plan sizes.
    """
    if objective not in ("makespan", "bytes"):
        raise ValueError(
            f"objective must be 'makespan' or 'bytes', got {objective!r}"
        )
    network = (network or NetworkModel.preset("uniform")).bind(inst.locations)
    sizes = sizes or SizeModel()
    costs = costs or CostModel()

    t0 = time.perf_counter()
    mapping = greedy_placement(
        inst, network, sizes=sizes, costs=costs, objective=objective, pin=pin
    )
    if refine:
        mapping, predicted = refine_placement(
            inst, mapping, network,
            sizes=sizes, costs=costs, objective=objective, pin=pin,
            rules=rules, max_evals=max_evals,
        )
    else:
        predicted = evaluate_placement(
            inst, mapping, network, sizes=sizes, costs=costs, rules=rules
        )
    search_s = time.perf_counter() - t0

    baseline_mapping = round_robin_placement(inst, pin=pin)
    baseline = evaluate_placement(
        inst, baseline_mapping, network, sizes=sizes, costs=costs, rules=rules
    )
    return ScheduleReport(
        objective=objective,
        network=network,
        placement=mapping,
        baseline_placement=baseline_mapping,
        predicted=predicted,
        baseline=baseline,
        search_seconds=search_s,
    )
