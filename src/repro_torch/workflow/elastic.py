"""Elastic re-mapping and failure recovery.

A copy of ``repro/workflow/elastic.py``.

SWIRL semantics is invariant under *location renaming* (names are opaque in
Figs. 2-3), so recovering from a dead location is a bijective substitution on
the last consistent checkpoint:

1. take the checkpointed system (remaining traces per location),
2. rename every reference to the dead location — configuration name,
   ``send``/``recv`` endpoints, ``exec`` location sets — to a spare,
3. move the dead location's checkpointed payloads to the spare,
4. resume reduction.

Steps already completed before the checkpoint are not re-run; in-flight work
is re-executed from pure inputs (lineage argument).  The same primitive
implements *scale-down* (fold several locations onto one — the renaming is
then surjective rather than bijective, which is still sound because traces
compose in parallel and L-COMM handles the now-local transfers) and
*scale-up* via :func:`rebalance` (re-encode the instance with a new mapping).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Mapping

from repro_torch.core.encoding import encode
from repro_torch.core.graph import DistributedWorkflowInstance
from repro_torch.core.optimizer import rewrite_system
from repro_torch.core.parser import dumps
from repro_torch.core.syntax import (
    Exec,
    LocationConfig,
    Nil,
    Par,
    Recv,
    Send,
    Seq,
    Trace,
    WorkflowSystem,
    par,
    seq,
)
from .runtime import Checkpoint


def _rename_trace(t: Trace, ren: Mapping[str, str]) -> Trace:
    r = lambda l: ren.get(l, l)  # noqa: E731
    if isinstance(t, Nil):
        return t
    if isinstance(t, Exec):
        return Exec(t.step, t.inputs, t.outputs, tuple(r(l) for l in t.locations))
    if isinstance(t, Send):
        return Send(t.data, t.port, r(t.src), r(t.dst))
    if isinstance(t, Recv):
        return Recv(t.port, r(t.src), r(t.dst))
    if isinstance(t, Seq):
        return seq(*(_rename_trace(i, ren) for i in t.items))
    if isinstance(t, Par):
        return par(*(_rename_trace(b, ren) for b in t.branches))
    raise TypeError(f"not a trace: {t!r}")


def rename_locations(w: WorkflowSystem, ren: Mapping[str, str]) -> WorkflowSystem:
    """Apply a location substitution to a whole system.

    If two configurations collapse onto the same name (scale-down), their
    data sets are united and their traces composed in parallel.
    """
    merged: dict[str, LocationConfig] = {}
    for cfg in w.configs:
        new_name = ren.get(cfg.location, cfg.location)
        new_trace = _rename_trace(cfg.trace, ren)
        if new_name in merged:
            prev = merged[new_name]
            merged[new_name] = LocationConfig(
                new_name, prev.data | cfg.data, par(prev.trace, new_trace)
            )
        else:
            merged[new_name] = LocationConfig(new_name, cfg.data, new_trace)
    return WorkflowSystem(tuple(merged[k] for k in sorted(merged)))


def fold_payloads(
    payloads: Mapping[tuple[str, str], object], ren: Mapping[str, str]
) -> dict[tuple[str, str], object]:
    """Move payloads under a location substitution, deterministically.

    A fold can collapse two holders of the same datum onto one key.  The
    precedence is fixed: a *survivor's* payload (a location not being
    renamed away) always beats one inherited from a renamed (dead)
    location, and between two renamed locations the lexicographically
    smallest source wins — never dict-iteration order.
    """
    folded: dict[tuple[str, str], object] = {}
    for l, d in sorted(payloads):
        v = payloads[(l, d)]
        if l in ren:
            folded.setdefault((ren[l], d), v)
        else:
            folded[(l, d)] = v
    return folded


def recover_checkpoint(
    ckpt: Checkpoint, ren: Mapping[str, str]
) -> Checkpoint:
    """Produce the post-recovery checkpoint under a location substitution."""
    system = rename_locations(ckpt.system, ren)
    return Checkpoint(
        system_text=dumps(system),
        payloads=fold_payloads(ckpt.payloads, ren),
        completed_execs=ckpt.completed_execs,
    )


def plan_recovery(
    live: list[str], dead: list[str], spares: list[str]
) -> dict[str, str]:
    """Assign each dead location a replacement: spares first, then fold onto
    live locations round-robin (scale-down)."""
    ren: dict[str, str] = {}
    pool = list(spares)
    live_sorted = sorted(live)
    folded = 0  # counts fold assignments only, so the round-robin starts
    # at live_sorted[0] regardless of how many deads took spares first.
    for d in sorted(dead):
        if pool:
            ren[d] = pool.pop(0)
        elif live_sorted:
            ren[d] = live_sorted[folded % len(live_sorted)]
            folded += 1
        else:
            raise RuntimeError("no live locations or spares to recover onto")
    return ren


def rebalance(
    inst: DistributedWorkflowInstance,
    new_mapping: Mapping[str, tuple[str, ...]],
    *,
    optimize_system: bool = True,
) -> WorkflowSystem:
    """Scale-out/in: re-encode the *instance* under a new step→location map.

    Used at iteration boundaries (e.g. between training steps) when the
    resource pool changed: the workflow graph and data are unchanged, only
    ``M`` is replaced, then ``⟦·⟧`` and the optimiser re-derive the plan.
    """
    locations = frozenset(l for ls in new_mapping.values() for l in ls)
    new_inst = replace(
        inst,
        locations=locations,
        mapping={s: tuple(ls) for s, ls in new_mapping.items()},
        initial_data={
            l: ds for l, ds in inst.initial_data.items() if l in locations
        },
    )
    w = encode(new_inst)
    if optimize_system:
        w, _ = rewrite_system(w)
    return w
