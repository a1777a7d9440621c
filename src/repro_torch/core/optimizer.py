"""Optimisation function ``⟦·⟧ : W_W → W_O`` — Definition 15 of the paper.

Two rewriting rules, applied by a single left-to-right scan of each
location's execution trace while threading a set ``A`` of already-seen
communication prefixes:

* **R1 (local communication)** — ``μ ∈ A_{l,l}``: a ``send``/``recv`` whose
  source and destination coincide is redundant (the data element is already
  in the location's scope after the producing ``exec``) and is replaced by
  ``0``.
* **R2 (duplicate communication)** — ``μ ∈ A``: the same data element was
  already sent to the same location through the same port (just to a
  different step); the later copy is replaced by ``0``.

Per Def. 15 the set ``A`` is threaded *within* one location's trace (both
through ``.`` and ``|`` compositions, in program order) and each location is
rewritten with the same inherited top-level ``A = ∅`` — the sender dedupes
its sends and, independently, the receiver dedupes the matching recvs, which
keeps the two sides consistent.

Correctness: ``W ≈ ⟦W⟧`` (weak barbed bisimulation, Thm. 1) — checked
mechanically by the reference's ``core/bisim.py`` in its property tests.

Two engines implement each rule:

* the **flat engine** (:mod:`repro_torch.core.flat`) — the default behind
  :func:`rewrite_system` / :func:`rewrite_spatial`: one indexed pass over
  per-location action arrays, linear in the action count, built for
  10k-step plans;
* the **tree engine** (:func:`rewrite_system_tree` /
  :func:`rewrite_spatial_tree`) — the original recursive walkers over the
  immutable trace trees, kept verbatim as the reference oracle the
  differential property suite (``tests/test_flat_ir.py``) checks the flat
  engine against.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .syntax import (
    NIL,
    Exec,
    LocationConfig,
    Nil,
    Par,
    Recv,
    Send,
    Seq,
    Trace,
    WorkflowSystem,
    actions,
    is_action,
    par,
    seq,
)


@dataclass
class OptimizationStats:
    """What the rewriting removed — reported by benchmarks and EXPERIMENTS."""

    removed_local: int = 0  # R1: same-location send/recv pairs' predicates
    removed_duplicate: int = 0  # R2: duplicate sends/recvs
    kept: int = 0
    by_location: dict[str, int] = field(default_factory=dict)

    @property
    def removed(self) -> int:
        return self.removed_local + self.removed_duplicate


def _comm_key(a) -> tuple | None:
    """The identity under which communications are deduplicated.

    ``send(d↣p,l,l')`` repeats iff (d,p,l,l') repeats; ``recv(p,l,l')``
    repeats iff (p,l,l') repeats (the receiving side never names the datum,
    cf. Def. 8).
    """
    if isinstance(a, Send):
        return ("send", a.data, a.port, a.src, a.dst)
    if isinstance(a, Recv):
        return ("recv", a.port, a.src, a.dst)
    return None


def _is_local(a) -> bool:
    return isinstance(a, (Send, Recv)) and a.src == a.dst


def _rewrite(t: Trace, seen: set, stats: OptimizationStats, loc: str) -> Trace:
    """One pass of the third auxiliary function of Def. 15 (``A`` = seen)."""
    if isinstance(t, Nil):
        return t
    if is_action(t):
        if isinstance(t, Exec):
            stats.kept += 1
            return t
        if _is_local(t):  # μ ∈ A_{l,l}
            stats.removed_local += 1
            stats.by_location[loc] = stats.by_location.get(loc, 0) + 1
            return NIL
        key = _comm_key(t)
        if key in seen:  # μ ∈ A
            stats.removed_duplicate += 1
            stats.by_location[loc] = stats.by_location.get(loc, 0) + 1
            return NIL
        seen.add(key)
        stats.kept += 1
        return t
    if isinstance(t, Seq):
        return seq(*(_rewrite(i, seen, stats, loc) for i in t.items))
    if isinstance(t, Par):
        return par(*(_rewrite(b, seen, stats, loc) for b in t.branches))
    raise TypeError(f"not a trace: {t!r}")


def rewrite_system_tree(
    w: WorkflowSystem,
) -> tuple[WorkflowSystem, OptimizationStats]:
    """R1+R2 via the recursive tree engine (reference oracle)."""
    stats = OptimizationStats()
    configs = []
    for c in w.configs:
        seen: set = set()  # A = ∅ per location (see module docstring)
        new_trace = _rewrite(c.trace, seen, stats, c.location)
        configs.append(LocationConfig(c.location, c.data, new_trace))
    return WorkflowSystem(tuple(configs)), stats


def rewrite_system(w: WorkflowSystem) -> tuple[WorkflowSystem, OptimizationStats]:
    """``⟦W⟧`` — rewrite every location configuration (Def. 15, rules R1+R2).

    Canonical entry point used by :meth:`repro_torch.api.Plan.optimize`.  Runs the
    single-pass flat engine (:func:`repro_torch.core.flat.rewrite_r1r2`);
    :func:`rewrite_system_tree` is the recursive reference implementation.
    """
    from .flat import FlatSystem, rewrite_r1r2

    fs = FlatSystem.from_system(w)
    stats = rewrite_r1r2(fs)
    return fs.rebuild_system(), stats


# ---------------------------------------------------------------------------
# R3 — spatial-constraint deduplication (beyond the paper's Def. 15)
# ---------------------------------------------------------------------------
#
# When a step s is mapped onto several locations, rule (EXEC) already places
# Out^D(s) on EVERY location of M(s).  The encoding, however, still emits a
# send/recv for each consumer location — including consumers that
# *participate in the producing exec themselves*.  Those transfers are
# value-redundant: the (COMM) would only add a datum that the destination's
# own exec occurrence already added, and removing the pair cannot enable
# anything earlier because (EXEC) still guards on In^D ⊆ D.  The proof
# obligation is the same weak-barbed-bisimulation argument as for R1
# (checked mechanically in tests/test_optimizer_rules.py).  This rewrite is
# what collapses the multi-pod trainer's grad_sync re-broadcast.


def _remove_one(t: Trace, pred) -> tuple[Trace, bool]:
    """Remove the first action satisfying ``pred`` (left-to-right)."""
    if is_action(t):
        return (NIL, True) if pred(t) else (t, False)
    if isinstance(t, Nil):
        return t, False
    if isinstance(t, Seq):
        items = list(t.items)
        for i, item in enumerate(items):
            new, hit = _remove_one(item, pred)
            if hit:
                items[i] = new
                return seq(*items), True
        return t, False
    if isinstance(t, Par):
        branches = list(t.branches)
        for i, b in enumerate(branches):
            new, hit = _remove_one(b, pred)
            if hit:
                branches[i] = new
                return par(*branches), True
        return t, False
    raise TypeError(f"not a trace: {t!r}")


def rewrite_spatial_tree(
    w: WorkflowSystem,
) -> tuple[WorkflowSystem, OptimizationStats]:
    """R3 via the recursive tree engine (reference oracle).

    Quadratic: every removal re-walks and rebuilds the trace tree through
    :func:`_remove_one`.  Kept verbatim (modulo the ``by_location``
    accounting fix) so the differential suite can check the indexed flat
    engine against it; production callers go through
    :func:`rewrite_spatial`.
    """
    stats = OptimizationStats()

    # Port → data elements actually sent over it (from the send predicates).
    port_data: dict[str, set[str]] = {}
    for c in w.configs:
        for a in actions(c.trace):
            if isinstance(a, Send):
                port_data.setdefault(a.port, set()).add(a.data)

    # Location → data its own (spatial) execs produce.
    produces: dict[str, set[str]] = {c.location: set() for c in w.configs}
    for c in w.configs:
        for a in actions(c.trace):
            if isinstance(a, Exec) and c.location in a.locations:
                produces[c.location] |= set(a.outputs)

    new_cfg = {c.location: c for c in w.configs}
    for c in w.configs:
        for a in list(actions(c.trace)):
            if not isinstance(a, Send) or a.src == a.dst:
                continue
            if len(port_data.get(a.port, set())) != 1:
                continue
            if a.data not in produces.get(a.dst, set()):
                continue
            # remove this send at src and one matching recv at dst
            src_cfg, dst_cfg = new_cfg[a.src], new_cfg[a.dst]
            s_trace, s_hit = _remove_one(
                src_cfg.trace, lambda x, a=a: x == a
            )
            d_trace, d_hit = _remove_one(
                dst_cfg.trace,
                lambda x, a=a: isinstance(x, Recv)
                and (x.port, x.src, x.dst) == (a.port, a.src, a.dst),
            )
            if s_hit and d_hit:
                new_cfg[a.src] = LocationConfig(
                    src_cfg.location, src_cfg.data, s_trace
                )
                new_cfg[a.dst] = LocationConfig(
                    dst_cfg.location, dst_cfg.data, d_trace
                )
                # One predicate removed per side: the send at its source,
                # the recv at its destination.
                stats.removed_duplicate += 2
                stats.by_location[a.src] = stats.by_location.get(a.src, 0) + 1
                stats.by_location[a.dst] = stats.by_location.get(a.dst, 0) + 1
    return (
        WorkflowSystem(tuple(new_cfg[c.location] for c in w.configs)),
        stats,
    )


def rewrite_spatial(
    w: WorkflowSystem,
) -> tuple[WorkflowSystem, OptimizationStats]:
    """R3: drop send/recv pairs whose destination co-executes the producer.

    Only channels whose port carries a single data element are rewritten
    (recv predicates name the port, not the datum — with one datum per port
    the matching is unambiguous; multi-data ports are left untouched).

    Runs the indexed flat engine (:func:`repro_torch.core.flat.rewrite_r3`):
    port→data and location→produces tables are built once and each pair is
    deleted by index instead of rebuilding the trace tree per removal
    (:func:`rewrite_spatial_tree`, the reference, is quadratic in plan
    size).
    """
    from .flat import FlatSystem, rewrite_r3

    fs = FlatSystem.from_system(w)
    stats = rewrite_r3(fs)
    return fs.rebuild_system(), stats


#: The rule sets :meth:`repro_torch.api.Plan.optimize` can apply, in canonical
#: application order.  "R1R2" is the paper's Def.-15 scan (local + duplicate
#: communication removal); "R3" is the spatial-constraint deduplication.
#: Backed by the flat engines; :data:`REWRITE_RULES_TREE` holds the
#: recursive reference implementations under the same keys.
REWRITE_RULES = {
    "R1R2": rewrite_system,
    "R3": rewrite_spatial,
}

REWRITE_RULES_TREE = {
    "R1R2": rewrite_system_tree,
    "R3": rewrite_spatial_tree,
}
