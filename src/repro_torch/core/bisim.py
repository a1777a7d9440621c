"""A copy of ``repro/core/bisim.py``.

Weak barbed bisimulation checker — Definition 16 / Theorem 1.

The observables (barbs) are the ``exec(s, F(s), M(s))`` predicates; all
communications are silent ``τ`` actions.  For the finite-state systems
produced by the encoder we can check ``W ≈ ⟦W⟧`` *exactly* by a greatest-
fixpoint computation over the product of the two reachable state spaces:

    R₀ = S_W × S_O
    drop (w, o) whenever a transition of one side cannot be weakly matched
    by the other (exec labels matched as τ* ν τ*, τ matched as τ*), or the
    weak barbs disagree;
    iterate to the fixpoint, then test (init_W, init_O) ∈ R.

This is the mechanical counterpart of the paper's Lemmas A.2/A.3 and
Theorem A.1, used as an executable proof on randomised instances.
"""

from __future__ import annotations

from collections import defaultdict

from .semantics import reachable_states
from .syntax import WorkflowSystem

Label = tuple
LTS = dict[str, list[tuple[Label, str]]]


def _tau_closure(lts: LTS) -> dict[str, frozenset[str]]:
    """τ* reachability per state."""
    closure: dict[str, set[str]] = {s: {s} for s in lts}
    changed = True
    while changed:
        changed = False
        for s in lts:
            for lbl, nxt in lts[s]:
                if lbl[0] != "tau":
                    continue
                add = closure[nxt] - closure[s]
                if add:
                    closure[s] |= add
                    changed = True
    return {s: frozenset(v) for s, v in closure.items()}


def _weak_obs_succ(
    lts: LTS, closure: dict[str, frozenset[str]]
) -> dict[str, dict[Label, frozenset[str]]]:
    """``o ⇒ --ν--> ⇒ o''`` successors per state and observable label."""
    out: dict[str, dict[Label, set[str]]] = {s: defaultdict(set) for s in lts}
    for s in lts:
        for mid in closure[s]:
            for lbl, nxt in lts[mid]:
                if lbl[0] == "tau":
                    continue
                out[s][lbl] |= closure[nxt]
    return {s: {l: frozenset(v) for l, v in d.items()} for s, d in out.items()}


def _weak_barbs(
    lts: LTS, closure: dict[str, frozenset[str]]
) -> dict[str, frozenset[Label]]:
    """``W ⇓_ν`` — barbs reachable via τ*."""
    strong: dict[str, set[Label]] = {
        s: {lbl for lbl, _ in lts[s] if lbl[0] != "tau"} for s in lts
    }
    return {
        s: frozenset(b for t in closure[s] for b in strong[t]) for s in lts
    }


def weak_barbed_bisimilar(
    w: WorkflowSystem,
    o: WorkflowSystem,
    *,
    max_states: int = 20_000,
) -> bool:
    """Decide ``w ≈ o`` (exact, for finite systems)."""
    lts_w = reachable_states(w, max_states=max_states)
    lts_o = reachable_states(o, max_states=max_states)
    cl_w, cl_o = _tau_closure(lts_w), _tau_closure(lts_o)
    obs_w, obs_o = _weak_obs_succ(lts_w, cl_w), _weak_obs_succ(lts_o, cl_o)
    barbs_w, barbs_o = _weak_barbs(lts_w, cl_w), _weak_barbs(lts_o, cl_o)

    # Candidate relation: states agreeing on weak barbs.
    rel: set[tuple[str, str]] = {
        (a, b)
        for a in lts_w
        for b in lts_o
        if barbs_w[a] == barbs_o[b]
    }

    def ok_one_way(a: str, b: str, lts_a, obs_b, cl_b, flip: bool) -> bool:
        for lbl, a2 in lts_a[a]:
            if lbl[0] == "tau":
                cand = cl_b[b]
                if not any(((a2, b2) if not flip else (b2, a2)) in rel for b2 in cand):
                    return False
            else:
                cand = obs_b[b].get(lbl, frozenset())
                if not any(((a2, b2) if not flip else (b2, a2)) in rel for b2 in cand):
                    return False
        return True

    changed = True
    while changed:
        changed = False
        for pair in list(rel):
            a, b = pair
            if not ok_one_way(a, b, lts_w, obs_o, cl_o, flip=False):
                rel.discard(pair)
                changed = True
                continue
            if not ok_one_way(b, a, lts_o, obs_w, cl_w, flip=True):
                rel.discard(pair)
                changed = True
    return (w.canonical(), o.canonical()) in rel
