"""The staged-compilation pipeline — the port's front door to the toolchain.

A copy of ``repro/api.py`` over the port's own plan machinery::

    trace    front-end description  → Plan        (encode ⟦·⟧, §3.2)
    optimize Plan                   → Plan        (rewriting ⟦·⟧, §4 + R3)
    lower    Plan × backend/placement → Lowered   (program IR + backend)
    compile  Lowered × step bodies  → Executable  (runnable artifact)
    run      Executable             → ExecutionResult
    run_many Executable × [inputs]  → [ExecutionResult]  (compile-once serving)

End to end::

    from repro_torch import swirl

    result = (
        swirl.trace(edges, mapping=mapping)
        .optimize(("R1R2", "R3"))
        .lower("torch", fuse=True)
        .compile(step_fns)
        .run()
    )

Two backends resolve by name through :mod:`repro_torch.backends`:
``torch``, which places each location on a device and runs on ``cuda``
unless lowered with ``platform="cpu"``, and ``inprocess``, the reference's
thread-pool runtime with retry, speculation and checkpoint/restore, which
places nothing.  As in the reference, every stage is a value: a
:class:`Plan` can be optimised twice with different rule sets, certified
against the original system with the weak-barbed-bisimulation checker of
:mod:`repro_torch.core.bisim` (Thm. 1), scheduled against a network cost
model (:mod:`repro_torch.sched`), lowered with ``trace=True`` and aligned
against its predicted timeline (:meth:`Plan.profile`).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Sequence

from repro_torch.backends import get_backend
from repro_torch.backends.base import (
    BackendProgram,
    ExecutionResult,
    PayloadKey,
)
from repro_torch.core.compile import StepFn, StepMeta
from repro_torch.core.encoding import encode
from repro_torch.core.graph import DistributedWorkflowInstance
from repro_torch.core.optimizer import REWRITE_RULES, OptimizationStats
from repro_torch.core.parser import parse_system
from repro_torch.core.syntax import Exec, WorkflowSystem, actions
from repro_torch.core.translate import DagTranslator, SWIRLTranslator
from repro_torch.sched import CostModel, NetworkModel, SizeModel, auto_placement
from repro_torch.sched.report import ScheduleReport

__all__ = [
    "trace",
    "Plan",
    "Lowered",
    "Executable",
    "AppliedRewrite",
    "BisimCertificate",
    "ExecutionResult",
    "ConcurrentRunError",
    "clear_compile_cache",
    "compile_cache_stats",
]


class ConcurrentRunError(RuntimeError):
    """A second run was started while the Executable was still running.

    Applies to whole runs: a :meth:`Executable.run` or a whole
    :meth:`Executable.run_many` *batch* — the batch's internal instance
    parallelism is not a re-entry and is never rejected.
    """


# ---------------------------------------------------------------------------
# trace — front-end → Plan
# ---------------------------------------------------------------------------


def trace(
    source: (
        SWIRLTranslator
        | DistributedWorkflowInstance
        | WorkflowSystem
        | Mapping[str, Sequence[str]]
        | str
        | os.PathLike
    ),
    *,
    mapping: Mapping[str, Sequence[str]] | None = None,
    initial_data: Mapping[str, Any] | None = None,
) -> "Plan":
    """Stage a front-end workflow description into a :class:`Plan`.

    Accepted sources:

    * a :class:`~repro_torch.core.translate.SWIRLTranslator` (its
      :meth:`~repro_torch.core.translate.SWIRLTranslator.instance` is encoded);
    * a :class:`~repro_torch.core.graph.DistributedWorkflowInstance`;
    * an already-encoded :class:`~repro_torch.core.syntax.WorkflowSystem`;
    * a step-adjacency DAG ``{step: [successors]}`` plus the required
      ``mapping=`` step→locations (sugar for :class:`DagTranslator`);
    * ``.swirl`` surface syntax — a path to a ``.swirl`` file, or source
      text containing a location configuration.
    """
    if isinstance(source, SWIRLTranslator):
        return _traced(source.instance())
    if isinstance(source, DistributedWorkflowInstance):
        return _traced(source)
    if isinstance(source, WorkflowSystem):
        return Plan(system=source)
    if isinstance(source, Mapping):
        if mapping is None:
            raise TypeError(
                "trace(edges) needs mapping= (step → locations) to place "
                "the DAG"
            )
        translator = DagTranslator(
            edges=source,
            mapping=mapping,
            initial_data=initial_data or {},
        )
        return _traced(translator.instance())
    if isinstance(source, (str, os.PathLike)):
        text = os.fspath(source)
        if isinstance(source, os.PathLike) or text.endswith(".swirl"):
            # A filesystem path: a missing file is an error, never
            # silently re-interpreted as source text.
            with open(text, encoding="utf-8") as f:
                text = f.read()
        return Plan(system=parse_system(text))
    raise TypeError(f"cannot trace {type(source).__name__}")


def _traced(inst: DistributedWorkflowInstance) -> "Plan":
    t0 = time.perf_counter()
    system = encode(inst)
    return Plan(
        system=system,
        instance=inst,
        timings=(("encode", time.perf_counter() - t0),),
    )


# ---------------------------------------------------------------------------
# Compile cache — re-derivations keyed by (instance hash, rules, placement)
# ---------------------------------------------------------------------------
#
# Scheduling and placement overrides re-derive the plan (re-encode under the
# new M, re-apply the recorded rewrites).  The search that *chose* the
# placement already proved the result; repeating the derivation for every
# ``lower()``/``schedule()`` of the same (instance, rules, placement) triple
# is pure waste at 10k-step scale, so the outcome is cached in a small LRU.
# Everything stored is immutable and shared safely between plans.

_DERIVE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
#: Small on purpose: each entry pins a full rewritten system plus its
#: pre-optimisation origin, which at 10k-step scale is tens of MB.  The
#: cache exists to absorb repeated derivations of the *same* plan
#: (schedule → lower → explain chains), not to memoise sweeps.
_DERIVE_CACHE_MAX = 32
#: Plans are immutable and freely shared across threads, so the cache they
#: all consult must be too: every get/move_to_end/insert/evict happens
#: under this lock (an unlocked hit could be evicted by a concurrent
#: insert between ``get`` and ``move_to_end``).
_DERIVE_CACHE_LOCK = threading.Lock()
#: Hit/miss/eviction counters for the derive cache, reported by
#: :func:`compile_cache_stats` (and the serving gateway's ``/v1/stats``).
_DERIVE_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0, "clears": 0}
#: Bumped by :func:`clear_compile_cache`.  Live :class:`Plan` values stamp
#: their memoised ``exec_program()`` with the generation it was computed
#: under; a stale stamp means the user asked for the memory back, so the
#: program is re-derived instead of served from the plan's own cache —
#: the module LRU and the per-plan memos stay coherent.
_CACHE_GENERATION = 0


def clear_compile_cache() -> None:
    """Drop every cached derivation — the module LRU *and* per-plan memos.

    Useful in long-running processes that sweep many large distinct plans
    and want the memory back deterministically.  Also invalidates the
    cached :meth:`Plan.exec_program` of every live plan (they re-derive on
    next use), so clearing really does release the lowered programs too.
    """
    global _CACHE_GENERATION
    with _DERIVE_CACHE_LOCK:
        _DERIVE_CACHE.clear()
        _CACHE_GENERATION += 1
        _DERIVE_CACHE_STATS["clears"] += 1


def compile_cache_stats() -> dict[str, int]:
    """Snapshot of the derive-cache counters (entries, hits, misses, …)."""
    with _DERIVE_CACHE_LOCK:
        return dict(_DERIVE_CACHE_STATS, entries=len(_DERIVE_CACHE))


def _instance_key(inst: DistributedWorkflowInstance) -> tuple:
    """Stable hashable fingerprint of everything but the step mapping."""
    return (
        inst.workflow,
        inst.data,
        tuple(sorted(inst.placement.items())),
        tuple(sorted(inst.initial_data.items())),
        inst.locations,
    )


def _placement_key(mapping: Mapping[str, Sequence[str]]) -> tuple:
    return tuple(sorted((s, tuple(ls)) for s, ls in mapping.items()))


def _derive_plan(
    inst: DistributedWorkflowInstance,
    rules: Sequence[str],
    *,
    schedule_report: "ScheduleReport | None" = None,
) -> "Plan":
    """Encode ``inst`` and apply ``rules``, through the compile cache."""
    t0 = time.perf_counter()
    key = (_instance_key(inst), tuple(rules), _placement_key(inst.mapping))
    with _DERIVE_CACHE_LOCK:
        hit = _DERIVE_CACHE.get(key)
        if hit is not None:
            _DERIVE_CACHE.move_to_end(key)
            _DERIVE_CACHE_STATS["hits"] += 1
        else:
            _DERIVE_CACHE_STATS["misses"] += 1
    if hit is not None:
        system, origin, rewrites = hit
        return Plan(
            system=system,
            instance=inst,
            origin=origin,
            rewrites=rewrites,
            schedule_report=schedule_report,
            timings=(("derive (cached)", time.perf_counter() - t0),),
        )
    plan = _traced(inst)
    if rules:
        plan = plan.optimize(rules)
    if schedule_report is not None:
        plan = replace(plan, schedule_report=schedule_report)
    with _DERIVE_CACHE_LOCK:
        _DERIVE_CACHE[key] = (plan.system, plan.origin, plan.rewrites)
        while len(_DERIVE_CACHE) > _DERIVE_CACHE_MAX:
            _DERIVE_CACHE.popitem(last=False)
            _DERIVE_CACHE_STATS["evictions"] += 1
    return plan


# ---------------------------------------------------------------------------
# Plan — the traced (and possibly optimised) SWIRL system
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AppliedRewrite:
    """One optimisation rule application with its removal statistics."""

    rule: str
    stats: OptimizationStats


@dataclass(frozen=True)
class BisimCertificate:
    """Mechanical Thm.-1 evidence that optimisation preserved behaviour."""

    equivalent: bool
    method: str = "weak-barbed-bisimulation"
    states_original: int = 0
    states_optimized: int = 0


@dataclass(frozen=True)
class Plan:
    """A traced SWIRL system, optionally rewritten, ready to lower.

    Immutable: :meth:`optimize` and :meth:`lower` return new values, so one
    trace can fan out to many backends/rule sets.
    """

    system: WorkflowSystem
    instance: DistributedWorkflowInstance | None = None
    origin: WorkflowSystem | None = None  # pre-optimisation system
    rewrites: tuple[AppliedRewrite, ...] = ()
    certificate: BisimCertificate | None = None
    schedule_report: ScheduleReport | None = None
    #: Per-phase wall-clock durations ``(label, seconds)`` in the order the
    #: phases ran — rendered by :meth:`explain`.
    timings: tuple[tuple[str, float], ...] = ()

    # -- optimisation -------------------------------------------------------
    def optimize(
        self,
        rules: Sequence[str] = ("R1R2",),
        *,
        certify: bool = False,
        max_states: int = 20_000,
    ) -> "Plan":
        """Apply rewriting rules (Def. 15 and beyond) in order.

        ``rules`` names entries of
        :data:`repro_torch.core.optimizer.REWRITE_RULES` — ``"R1R2"`` is the
        paper's local+duplicate communication removal, ``"R3"`` the
        spatial-constraint deduplication.  With ``certify=True`` the result
        carries a :class:`BisimCertificate` checking ``W ≈ ⟦W⟧`` exactly
        (exponential in system size — keep certified systems small).

        Rules with a flat-engine implementation run as one pipeline over
        the flat IR (one flatten, one tree reconstruction for the whole
        list); anything else falls back to per-rule tree rewriting.
        """
        from repro_torch.core.flat import FLAT_RULES, rewrite_flat_pipeline

        for rule in rules:
            if rule not in REWRITE_RULES:
                raise ValueError(
                    f"unknown rewrite rule {rule!r}; "
                    f"known: {sorted(REWRITE_RULES)}"
                )
        system = self.system
        applied = list(self.rewrites)
        timings = list(self.timings)
        rules = tuple(rules)
        if rules and all(r in FLAT_RULES for r in rules):
            t0 = time.perf_counter()
            system, stats_list = rewrite_flat_pipeline(system, rules)
            timings.append(
                (f"rewrite:{'+'.join(rules)}", time.perf_counter() - t0)
            )
            applied.extend(
                AppliedRewrite(rule, stats)
                for rule, stats in zip(rules, stats_list)
            )
        else:
            for rule in rules:
                t0 = time.perf_counter()
                system, stats = REWRITE_RULES[rule](system)
                timings.append(
                    (f"rewrite:{rule}", time.perf_counter() - t0)
                )
                applied.append(AppliedRewrite(rule, stats))
        plan = replace(
            self,
            system=system,
            origin=self.origin if self.origin is not None else self.system,
            rewrites=tuple(applied),
            certificate=None,
            timings=tuple(timings),
        )
        return plan.certify(max_states=max_states) if certify else plan

    def certify(self, *, max_states: int = 20_000) -> "Plan":
        """Attach Thm.-1 evidence that this plan ≈ its unoptimised origin."""
        from repro_torch.core.bisim import weak_barbed_bisimilar
        from repro_torch.core.semantics import reachable_states

        origin = self.origin if self.origin is not None else self.system
        cert = BisimCertificate(
            equivalent=weak_barbed_bisimilar(
                origin, self.system, max_states=max_states
            ),
            states_original=len(
                reachable_states(origin, max_states=max_states)
            ),
            states_optimized=len(
                reachable_states(self.system, max_states=max_states)
            ),
        )
        if not cert.equivalent:
            raise AssertionError(
                "optimisation broke weak barbed bisimilarity — this is a "
                "bug in the rewrite rules"
            )
        return replace(self, certificate=cert)

    # -- aggregates ---------------------------------------------------------
    @property
    def stats(self) -> OptimizationStats:
        """Merged removal statistics across every applied rewrite."""
        total = OptimizationStats()
        for r in self.rewrites:
            total.removed_local += r.stats.removed_local
            total.removed_duplicate += r.stats.removed_duplicate
            total.kept += r.stats.kept
            for loc, n in r.stats.by_location.items():
                total.by_location[loc] = total.by_location.get(loc, 0) + n
        return total

    def steps(self) -> tuple[str, ...]:
        """Every step name executed anywhere in the system."""
        cached = self.__dict__.get("_steps")
        if cached is None:
            cached = tuple(sorted(self.placement()))
            self.__dict__["_steps"] = cached
        return cached

    def placement(self) -> dict[str, tuple[str, ...]]:
        """Step → locations, from the exec predicates (``M`` reconstructed)."""
        cached = self.__dict__.get("_placement")
        if cached is None:
            cached = {}
            for cfg in self.system.configs:
                for a in actions(cfg.trace):
                    if isinstance(a, Exec):
                        cached[a.step] = tuple(sorted(a.locations))
            self.__dict__["_placement"] = cached
        return dict(cached)

    def fingerprint(self) -> str:
        """Content-addressed identity of this plan (stable public API).

        A hex SHA-256 digest of the canonical ``.swirl`` text of the
        (possibly rewritten) system plus the names of the rewrite rules
        applied to reach it.  The contract:

        * **Equality** — two plans whose systems are equal (same traces,
          same placement ``M``, same data scopes) and that were optimised
          with the same rule list have equal fingerprints, across
          processes and interpreter runs (no ``PYTHONHASHSEED`` dependence).
        * **Sensitivity** — anything that changes the lowered artifact
          changes the fingerprint: a different step→location placement, a
          rewrite that removes communications, added/removed steps or
          data.  Applying a rule that happens to be a no-op still changes
          the fingerprint (the rule list is part of the identity), so a
          fingerprint names one *pipeline output*, not an equivalence
          class.
        * **Versioning** — stable within a release of this package; the
          leading ``swirl-plan-v1`` tag is bumped if the canonical text or
          encoding ever changes, so digests from different contracts can
          never collide silently.

        It equals the reference's fingerprint of the same plan, which keys
        the reference's serving gateway's content-addressed plan cache
        (``repro.serve``).
        """
        cached = self.__dict__.get("_fingerprint")
        if cached is None:
            from repro_torch.core.parser import dumps

            h = hashlib.sha256()
            h.update(b"swirl-plan-v1\n")
            h.update(",".join(r.rule for r in self.rewrites).encode())
            h.update(b"\n")
            h.update(dumps(self.system).encode())
            cached = h.hexdigest()
            self.__dict__["_fingerprint"] = cached
        return cached

    def exec_program(self):
        """The plan lowered to the execution IR (:mod:`repro_torch.exec`).

        Computed once per plan and shared by every backend lowered from it
        (the per-location op arrays are backend-agnostic), so fanning one
        plan out to several backends — or compiling several Executables —
        never re-derives the programs.  :func:`clear_compile_cache`
        invalidates the memo (the stored generation stamp goes stale) so
        the module LRU and per-plan caches release memory together.
        """
        from repro_torch.exec.program import lower_system

        cached = self.__dict__.get("_exec_program")
        if cached is not None and cached[0] == _CACHE_GENERATION:
            return cached[1]
        t0 = time.perf_counter()
        program = lower_system(self.system, schedule=self.schedule_report)
        self._record_phase("lower", time.perf_counter() - t0)
        self.__dict__["_exec_program"] = (_CACHE_GENERATION, program)
        return program

    def _record_phase(self, label: str, seconds: float) -> None:
        """Memoised side-channel for post-construction phase timings.

        ``timings`` is frozen at derive time; the lower/compile stages run
        later (and at most once each, thanks to memoisation), so they land
        in a mutable memo rendered by :meth:`explain` and
        :meth:`phase_timings` alongside the frozen entries.
        """
        self.__dict__.setdefault("_phase_timings", {})[label] = seconds

    def phase_timings(self) -> tuple[tuple[str, float], ...]:
        """Every recorded pipeline phase: derive-time + lower/compile."""
        extra = self.__dict__.get("_phase_timings") or {}
        return self.timings + tuple(extra.items())

    # -- scheduling ---------------------------------------------------------
    def schedule(
        self,
        network: NetworkModel | None = None,
        *,
        objective: str = "makespan",
        steps: Mapping[str, StepFn | StepMeta] | None = None,
        sizes: SizeModel | None = None,
        costs: CostModel | None = None,
        refine: bool = True,
        pin: Sequence[str] = (),
        max_evals: int | None = None,
    ) -> "Plan":
        """Choose ``M(s)`` against a network cost model (``repro_torch.sched``).

        Runs critical-path greedy placement plus local-search refinement,
        re-encodes the instance under the chosen mapping, and re-runs the
        optimiser (the recorded rewrite rules, or the paper's ``R1R2`` for
        a never-optimised plan) — the scheduler co-locates producers with
        consumers, which turns remote sends into local ones that R1 then
        deletes.  ``objective`` is ``"makespan"`` (simulated completion
        time; default) or ``"bytes"`` (cross-location traffic).

        Size/cost estimates come from ``sizes=``/``costs=`` or are
        harvested from ``steps=`` (the same registry handed to
        :meth:`Lowered.compile` — :class:`StepMeta.output_bytes` and
        :class:`StepMeta.expected_seconds`).  Spatially-constrained steps
        (``|M(s)| > 1``) and steps named in ``pin=`` are never moved.

        The result carries a :class:`~repro_torch.sched.ScheduleReport`
        (``plan.schedule_report``, rendered by :meth:`explain`) comparing
        the chosen placement against round-robin.
        """
        if self.instance is None:
            raise ValueError(
                "schedule() needs a Plan traced from a front-end instance "
                "(not raw .swirl text or a WorkflowSystem)"
            )
        metas = {
            name: spec
            for name, spec in (steps or {}).items()
            if isinstance(spec, StepMeta)
        }
        if sizes is None:
            sizes = SizeModel.from_step_metas(metas) if metas else SizeModel()
        if costs is None:
            costs = CostModel.from_step_metas(metas) if metas else CostModel()
        # Re-run the optimiser on the scheduled plan: co-location turns
        # remote sends into local ones that R1 deletes.  The same rule list
        # is passed to the search so candidates are scored on exactly the
        # system that will be lowered; a never-optimised plan gets the
        # paper's default rule set.
        rules = tuple(r.rule for r in self.rewrites) or ("R1R2",)
        t0 = time.perf_counter()
        report = auto_placement(
            self.instance,
            network,
            objective=objective,
            sizes=sizes,
            costs=costs,
            refine=refine,
            pin=pin,
            rules=rules,
            max_evals=max_evals,
        )
        sched_dt = time.perf_counter() - t0
        inst = replace(self.instance, mapping=dict(report.placement))
        plan = _derive_plan(inst, rules, schedule_report=report)
        return replace(
            plan, timings=(("schedule", sched_dt),) + plan.timings
        )

    # -- lowering -----------------------------------------------------------
    def lower(
        self,
        backend: str = "torch",
        *,
        placement: Mapping[str, Sequence[str]] | str | None = None,
        network: NetworkModel | None = None,
        objective: str = "makespan",
        **options: Any,
    ) -> "Lowered":
        """Select an execution backend (and optionally re-place steps).

        ``placement`` overrides the step→locations mapping ``M`` and
        re-derives the plan (re-encode + re-apply the recorded rewrites).
        ``placement="auto"`` instead runs the cost-model-driven scheduler
        (:meth:`schedule`) against ``network=`` (default: the ``uniform``
        preset) and ``objective=``.  Backend-specific ``options`` (the
        ``torch`` backend's ``devices``/``platform``/``fuse``/``max_rounds``,
        and ``trace``/``policy``) are validated here, before any execution;
        a schedule report, when present, is handed down as the uniform
        ``schedule`` option (the ``torch`` backend maps each network group's
        locations onto one contiguous block of devices).
        """
        if isinstance(placement, str):
            if placement != "auto":
                raise ValueError(
                    "placement must be a mapping or the string 'auto', "
                    f"got {placement!r}"
                )
            plan = self.schedule(network, objective=objective)
        else:
            if network is not None or objective != "makespan":
                raise TypeError(
                    "network=/objective= are only meaningful with "
                    "placement='auto' (or use Plan.schedule directly)"
                )
            plan = self._replaced(placement) if placement else self
        b = get_backend(backend)
        if plan.schedule_report is not None:
            options.setdefault("schedule", plan.schedule_report)
        b.validate_options(options)
        return Lowered(plan=plan, backend_name=backend, options=dict(options))

    def _replaced(
        self, placement: Mapping[str, Sequence[str]]
    ) -> "Plan":
        if self.instance is None:
            raise ValueError(
                "placement override needs a Plan traced from a front-end "
                "instance (not raw .swirl text or a WorkflowSystem)"
            )
        unknown = set(placement) - set(self.instance.mapping)
        if unknown:
            raise ValueError(
                f"placement names unknown steps {sorted(unknown)}; "
                f"steps are {sorted(self.instance.mapping)}"
            )
        new_mapping = {
            s: tuple(placement.get(s, ls))
            for s, ls in self.instance.mapping.items()
        }
        locations = frozenset(l for ls in new_mapping.values() for l in ls)
        inst = replace(
            self.instance,
            locations=locations,
            mapping=new_mapping,
            initial_data={
                l: ds
                for l, ds in self.instance.initial_data.items()
                if l in locations
            },
        )
        return _derive_plan(inst, tuple(r.rule for r in self.rewrites))

    # -- introspection ------------------------------------------------------
    def profile(
        self,
        result: Any,
        *,
        network: NetworkModel | None = None,
        sizes: SizeModel | None = None,
        costs: CostModel | None = None,
        exec_slots: int | None = None,
    ) -> "Any":
        """Align a traced run against this plan's predicted timeline.

        ``result`` is a traced :class:`~repro_torch.backends.base.ExecutionResult`
        (from an Executable lowered with ``trace=True``) or a bare
        :class:`repro_torch.obs.RunProfile`.  Replays the plan through the sched
        simulator under the given models (defaults match
        :func:`repro_torch.sched.simulate`) and returns a
        :class:`repro_torch.obs.ProfileReport` with per-step predicted-vs-actual
        drift and achieved-vs-predicted cross-location bytes.
        """
        from repro_torch.obs.profile import RunProfile, align

        prof = getattr(result, "profile", result)
        if not isinstance(prof, RunProfile):
            raise ValueError(
                "result carries no RunProfile — run it on an Executable "
                'lowered with trace=True (e.g. plan.lower("torch", '
                "trace=True))"
            )
        return align(
            self,
            prof,
            network=network,
            sizes=sizes,
            costs=costs,
            exec_slots=exec_slots,
        )

    def explain(self) -> str:
        """Human-readable report: trace, rewrites applied, placement."""
        lines = ["== SWIRL plan =="]
        lines.append(
            f"locations: {len(self.system.locations())}  "
            f"actions: {self.system.total_actions()}  "
            f"communications: {self.system.comm_count()}"
        )
        lines.append("")
        lines.append("-- placement (step -> M(s)) --")
        for s, locs in sorted(self.placement().items()):
            lines.append(f"  {s:<24} {', '.join(locs)}")
        lines.append("")
        lines.append("-- rewrites applied --")
        if not self.rewrites:
            lines.append("  (none — unoptimised plan)")
        for r in self.rewrites:
            lines.append(
                f"  {r.rule:<6} removed {r.stats.removed:>4} "
                f"(local {r.stats.removed_local}, "
                f"duplicate {r.stats.removed_duplicate})"
            )
        if self.certificate is not None:
            c = self.certificate
            lines.append(
                f"  certificate: {c.method} equivalent={c.equivalent} "
                f"({c.states_original} -> {c.states_optimized} states)"
            )
        if self.schedule_report is not None:
            lines.append("")
            lines.append("-- schedule --")
            for row in self.schedule_report.summary().splitlines():
                lines.append(f"  {row}")
        lines.append("")
        lines.append("-- timings --")
        timings = self.phase_timings()
        if not timings:
            lines.append("  (none recorded — plan built from raw syntax)")
        for label, seconds in timings:
            lines.append(f"  {label:<24} {seconds * 1e3:9.2f} ms")
        lines.append("")
        lines.append("-- per-location traces --")
        lines.append(self.system.pretty())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Lowered — plan × backend, awaiting step bodies
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Lowered:
    """A plan bound to a backend; :meth:`compile` attaches step bodies.

    The plan's per-location program IR (:meth:`Plan.exec_program`) is
    shared by every ``Lowered``/``Executable`` derived from the same plan —
    lowering is paid once, backends only attach their interpreter.
    """

    plan: Plan
    backend_name: str
    options: dict[str, Any] = field(default_factory=dict)

    def compile(
        self, steps: Mapping[str, StepFn | StepMeta]
    ) -> "Executable":
        """Attach step bodies (callables or :class:`StepMeta`) and compile.

        ``steps`` must cover every exec predicate in the plan; extra
        entries are ignored (one registry can serve many plans).
        """
        metas: dict[str, StepMeta] = {}
        needed = set(self.plan.steps())
        missing = needed - set(steps)
        if missing:
            raise KeyError(
                f"no step function registered for {sorted(missing)}"
            )
        for name in sorted(needed):
            spec = steps[name]
            metas[name] = (
                spec if isinstance(spec, StepMeta) else StepMeta(fn=spec)
            )
        backend = get_backend(self.backend_name)
        exec_program = self.plan.exec_program()  # memoised; times "lower"
        t0 = time.perf_counter()
        program = backend.compile(exec_program, metas, self.options)
        self.plan._record_phase(
            f"compile[{self.backend_name}]", time.perf_counter() - t0
        )
        return Executable(
            plan=self.plan,
            backend_name=self.backend_name,
            program=program,
        )


# ---------------------------------------------------------------------------
# Executable — the runnable artifact
# ---------------------------------------------------------------------------


@dataclass
class Executable:
    """A compiled workflow: run it (once or in batches), snapshot, resume.

    One Executable owns one :class:`BackendProgram`.  Whether *whole runs*
    may overlap is the backend's call
    (:meth:`~repro_torch.backends.base.BackendProgram.concurrent_batches`).
    Both backends' runs share program-level state (the ``torch`` backend's
    captured CUDA graphs and their static buffers, the ``inprocess``
    backend's snapshot slots), so each keeps the exclusive guard:
    a second overlapping run raises :class:`ConcurrentRunError` (compile
    another Executable from the same :class:`Lowered` to run concurrently).

    In both regimes a :meth:`run_many` batch counts as one run — its
    *internal* instance parallelism happens below the guard and is never
    rejected.
    """

    plan: Plan
    backend_name: str
    program: BackendProgram
    _run_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    _active_runs: int = field(default=0, repr=False, compare=False)

    @property
    def concurrent_runs(self) -> bool:
        """True when whole runs on this Executable may safely overlap."""
        return self.program.concurrent_batches()

    @property
    def active_runs(self) -> int:
        """Whole runs currently in flight (introspection/drain support)."""
        with self._run_lock:
            return self._active_runs

    def _enter_run(self, what: str) -> None:
        with self._run_lock:
            if self._active_runs and not self.program.concurrent_batches():
                raise ConcurrentRunError(
                    f"this Executable ({self.backend_name!r}) is already "
                    f"running; an overlapping {what} would share one "
                    "mutable BackendProgram — wait for the in-flight run, "
                    "or compile() another Executable from the same Lowered"
                )
            self._active_runs += 1

    def _exit_run(self) -> None:
        with self._run_lock:
            self._active_runs -= 1

    def run(
        self,
        *,
        initial_payloads: Mapping[PayloadKey, Any] | None = None,
    ) -> ExecutionResult:
        self._enter_run("run")
        try:
            return self._with_phases(self.program.run(initial_payloads))
        finally:
            self._exit_run()

    def _with_phases(self, result: ExecutionResult) -> ExecutionResult:
        """Stamp a traced result's profile with the plan's phase timings."""
        if result.profile is not None:
            result.profile = result.profile.with_phases(
                self.plan.phase_timings()
            )
        return result

    def run_many(
        self,
        inputs: Sequence[Mapping[PayloadKey, Any] | None],
        *,
        max_concurrent: int = 8,
    ) -> list[ExecutionResult]:
        """Run one workflow instance per entry of ``inputs``, compile-once.

        Every instance executes against this Executable's already-lowered
        program — encode, rewrite, lower and compile are amortised across
        the batch, transports are shared where the backend supports it, and
        at most ``max_concurrent`` instances are in flight at a time.
        Results come back in input order.  The whole batch holds the
        re-entry guard: concurrent ``run_many`` batches (or a concurrent
        :meth:`run`) on one Executable raise :class:`ConcurrentRunError`;
        the batch's internal concurrency does not.
        """
        self._enter_run("run_many batch")
        try:
            return [
                self._with_phases(r)
                for r in self.program.run_many(
                    list(inputs), max_concurrent=max_concurrent
                )
            ]
        finally:
            self._exit_run()

    def run_async(
        self,
        *,
        initial_payloads: Mapping[PayloadKey, Any] | None = None,
    ) -> Future:
        """Run on a daemon thread; the returned future yields the result.

        Daemon so an abandoned (hung) run never blocks interpreter exit.
        """
        fut: Future = Future()

        def worker() -> None:
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(self.run(initial_payloads=initial_payloads))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(
            target=worker, name="swirl-run-async", daemon=True
        ).start()
        return fut

    def checkpoint(self):
        """Consistent snapshot (backends advertising ``"checkpoint"``)."""
        return self.program.checkpoint()

    def restore(self, ckpt) -> "Executable":
        """Resume from a snapshot: the next :meth:`run` continues it."""
        self.program.restore(ckpt)
        return self
