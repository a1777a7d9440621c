"""Flat indexed trace IR — the array view of a :class:`WorkflowSystem`.

The recursive tree walkers in :mod:`repro_torch.core.optimizer` are fine at the
paper's 5–20-step scale but superlinear at 10k-step scale: R3's
``_remove_one`` rebuilds the full immutable trace tree once per removed
action, and every tree rewrite re-allocates the entire trace.  The flat IR
stores each location's trace as

* ``actions`` — the predicate occurrences in *program order* (exactly the
  traversal order of :func:`repro_torch.core.syntax.actions`),
* ``ops``     — a preorder structure skeleton (``SEQ``/``PAR`` arity plus
  leaf slots) that makes the flattening lossless,
* ``alive``   — one flag per occurrence: rewriting deletes by index instead
  of rebuilding immutable trees,

plus hash indexes over communication keys (``(data, port, src, dst)`` for
sends, ``(port, src, dst)`` for recvs) so R2/R3 matching is O(1) per
occurrence.

Contracts, checked by the property suite in ``tests/test_flat_ir.py``:

* **Round-trip** — ``FlatSystem.from_system(w).to_system() == w`` exactly
  (node-for-node raw reconstruction) while nothing has been deleted.
* **Engine equivalence** — :func:`rewrite_r1r2` / :func:`rewrite_r3`
  followed by :meth:`FlatSystem.rebuild_system` return a system equal to
  the recursive reference engines
  (:func:`repro_torch.core.optimizer.rewrite_system_tree` /
  :func:`~repro_torch.core.optimizer.rewrite_spatial_tree`), with identical
  :class:`~repro_torch.core.optimizer.OptimizationStats`, on every system in
  smart-constructor normal form — anything produced by
  :func:`~repro_torch.core.encoding.encode`, the ``.swirl`` parser, or the
  ``seq``/``par`` smart constructors.  (The reference R1/R2 engine rebuilds
  every path through the smart constructors, so a non-normal input — e.g. a
  raw ``Seq`` holding a ``Nil`` — is normalised differently by the two R3
  engines; such trees cannot be produced by any front end.)

``bisim``, ``semantics`` and the parser never see the flat form: it is an
internal acceleration structure with a lossless bridge to the tree syntax.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Iterator

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
    par,
    seq,
)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard for type checkers
    from .optimizer import OptimizationStats

__all__ = [
    "FlatTrace",
    "FlatConfig",
    "FlatSystem",
    "flatten_trace",
    "rewrite_r1r2",
    "rewrite_r3",
    "rewrite_flat_pipeline",
    "FLAT_RULES",
]

# Structure opcodes.  ``ops`` is a preorder list of ``(code, arg)`` pairs:
# SEQ/PAR carry their child count, ACT the index into ``actions``.
OP_NIL = 0
OP_ACT = 1
OP_SEQ = 2
OP_PAR = 3


class FlatTrace:
    """One trace as (preorder skeleton, program-order actions, alive flags)."""

    __slots__ = ("ops", "actions", "alive")

    def __init__(
        self,
        ops: list[tuple[int, int]],
        actions: list[Action],
        alive: list[bool] | None = None,
    ) -> None:
        self.ops = ops
        self.actions = actions
        self.alive = [True] * len(actions) if alive is None else alive

    # -- tree -> flat -------------------------------------------------------
    @classmethod
    def from_trace(cls, t: Trace) -> "FlatTrace":
        ops: list[tuple[int, int]] = []
        actions: list[Action] = []
        stack: list[Trace] = [t]
        while stack:
            node = stack.pop()
            if isinstance(node, Nil):
                ops.append((OP_NIL, 0))
            elif is_action(node):
                ops.append((OP_ACT, len(actions)))
                actions.append(node)  # type: ignore[arg-type]
            elif isinstance(node, Seq):
                ops.append((OP_SEQ, len(node.items)))
                stack.extend(reversed(node.items))
            elif isinstance(node, Par):
                ops.append((OP_PAR, len(node.branches)))
                stack.extend(reversed(node.branches))
            else:
                raise TypeError(f"not a trace: {node!r}")
        return cls(ops, actions)

    # -- flat -> tree -------------------------------------------------------
    def to_trace(self) -> Trace:
        """Exact raw reconstruction (requires every action still alive)."""
        if not all(self.alive):
            raise ValueError(
                "trace has deleted actions; use rebuild() for the "
                "smart-constructor reconstruction"
            )
        t, pos = self._build(0, exact=True)
        if pos != len(self.ops):
            raise ValueError("trailing structure ops — corrupt flat trace")
        return t

    def rebuild(self) -> Trace:
        """Smart-constructor reconstruction honouring the alive flags.

        Dead action slots become ``0`` and the ``seq``/``par`` identities
        collapse them away — exactly what the recursive R1/R2 engine does on
        every path of the tree.
        """
        t, pos = self._build(0, exact=False)
        if pos != len(self.ops):
            raise ValueError("trailing structure ops — corrupt flat trace")
        return t

    def _build(self, pos: int, *, exact: bool) -> tuple[Trace, int]:
        code, arg = self.ops[pos]
        pos += 1
        if code == OP_NIL:
            return NIL, pos
        if code == OP_ACT:
            if exact or self.alive[arg]:
                return self.actions[arg], pos
            return NIL, pos
        children: list[Trace] = []
        for _ in range(arg):
            child, pos = self._build(pos, exact=exact)
            children.append(child)
        if code == OP_SEQ:
            return (Seq(tuple(children)) if exact else seq(*children)), pos
        if code == OP_PAR:
            return (Par(tuple(children)) if exact else par(*children)), pos
        raise ValueError(f"unknown structure opcode {code}")

    def compact(self) -> "FlatTrace":
        """The op-array export: live actions + normalised flat skeleton.

        Drops every dead slot and applies the ``seq``/``par`` smart-
        constructor identities (units removed, single children inlined,
        same-kind nests flattened) *without leaving the flat form* — the
        flat analogue of :meth:`rebuild`.  This is what the execution
        lowering (:mod:`repro_torch.exec`) consumes: a program-order action
        array plus the minimal control skeleton, with
        ``compact().rebuild() == rebuild()`` by construction.
        """
        kinds = {OP_SEQ, OP_PAR}

        def norm(pos: int) -> tuple[tuple | None, int]:
            code, arg = self.ops[pos]
            pos += 1
            if code == OP_NIL:
                return None, pos
            if code == OP_ACT:
                if self.alive[arg]:
                    return (OP_ACT, self.actions[arg]), pos
                return None, pos
            children: list[tuple] = []
            for _ in range(arg):
                child, pos = norm(pos)
                if child is None:
                    continue
                if child[0] == code:
                    children.extend(child[1])
                else:
                    children.append(child)
            if not children:
                return None, pos
            if len(children) == 1:
                return children[0], pos
            assert code in kinds
            return (code, children), pos

        root, end = norm(0)
        if end != len(self.ops):
            raise ValueError("trailing structure ops — corrupt flat trace")
        ops: list[tuple[int, int]] = []
        actions: list[Action] = []
        stack: list[tuple] = [] if root is None else [root]
        if root is None:
            ops.append((OP_NIL, 0))
        while stack:
            node = stack.pop()
            code, payload = node
            if code == OP_ACT:
                ops.append((OP_ACT, len(actions)))
                actions.append(payload)
            else:
                ops.append((code, len(payload)))
                stack.extend(reversed(payload))
        return FlatTrace(ops, actions)

    # -- views --------------------------------------------------------------
    def live_actions(self) -> Iterator[tuple[int, Action]]:
        """``(index, action)`` pairs still alive, in program order."""
        alive = self.alive
        for i, a in enumerate(self.actions):
            if alive[i]:
                yield i, a

    def __len__(self) -> int:
        return len(self.actions)


def flatten_trace(t: Trace) -> FlatTrace:
    """Convenience alias for :meth:`FlatTrace.from_trace`."""
    return FlatTrace.from_trace(t)


class FlatConfig:
    """``⟨l, D, e⟩`` with ``e`` in flat form."""

    __slots__ = ("location", "data", "trace")

    def __init__(
        self, location: str, data: frozenset[str], trace: FlatTrace
    ) -> None:
        self.location = location
        self.data = data
        self.trace = trace


class FlatSystem:
    """A :class:`WorkflowSystem` as per-location flat action arrays."""

    __slots__ = ("configs", "_by_location")

    def __init__(self, configs: list[FlatConfig]) -> None:
        self.configs = configs
        self._by_location = {c.location: c for c in configs}

    @classmethod
    def from_system(cls, w: WorkflowSystem) -> "FlatSystem":
        return cls(
            [
                FlatConfig(c.location, c.data, FlatTrace.from_trace(c.trace))
                for c in w.configs
            ]
        )

    def __getitem__(self, location: str) -> FlatConfig:
        return self._by_location[location]

    def to_system(self) -> WorkflowSystem:
        """Exact round-trip (only valid while nothing has been deleted)."""
        return WorkflowSystem(
            tuple(
                LocationConfig(c.location, c.data, c.trace.to_trace())
                for c in self.configs
            )
        )

    def rebuild_system(self) -> WorkflowSystem:
        """Smart-constructor reconstruction honouring deletions."""
        return WorkflowSystem(
            tuple(
                LocationConfig(c.location, c.data, c.trace.rebuild())
                for c in self.configs
            )
        )

    # -- indexes ------------------------------------------------------------
    def comm_indexes(
        self,
    ) -> tuple[
        dict[str, dict[tuple, deque[int]]],
        dict[str, dict[tuple, deque[int]]],
    ]:
        """Per-location FIFO indexes over *alive* communication keys.

        Returns ``(sends, recvs)``: ``sends[loc][(data, port, src, dst)]``
        and ``recvs[loc][(port, src, dst)]`` are deques of action indices
        into ``self[loc].trace.actions`` in program order — popping the left
        end is exactly "the first matching occurrence" the tree engine's
        ``_remove_one`` finds.
        """
        sends: dict[str, dict[tuple, deque[int]]] = {}
        recvs: dict[str, dict[tuple, deque[int]]] = {}
        for cfg in self.configs:
            s_idx: dict[tuple, deque[int]] = {}
            r_idx: dict[tuple, deque[int]] = {}
            for i, a in cfg.trace.live_actions():
                if isinstance(a, Send):
                    s_idx.setdefault(
                        (a.data, a.port, a.src, a.dst), deque()
                    ).append(i)
                elif isinstance(a, Recv):
                    r_idx.setdefault((a.port, a.src, a.dst), deque()).append(i)
            sends[cfg.location] = s_idx
            recvs[cfg.location] = r_idx
        return sends, recvs


# ---------------------------------------------------------------------------
# Flat rewriting engines (Def. 15 + R3) — single indexed passes
# ---------------------------------------------------------------------------


def _new_stats() -> "OptimizationStats":
    from .optimizer import OptimizationStats

    return OptimizationStats()


def rewrite_r1r2(fs: FlatSystem) -> "OptimizationStats":
    """R1+R2 (Def. 15) as one left-to-right scan per location, in place.

    Mirrors the reference engine exactly: the set ``A`` of seen
    communication prefixes is threaded through each location's actions in
    program order (``A = ∅`` per location), local comms (R1) and repeats of
    an already-seen key (R2) are deleted by index.
    """
    stats = _new_stats()
    by_loc = stats.by_location
    kept = removed_local = removed_duplicate = 0
    for cfg in fs.configs:
        seen: set[tuple] = set()
        loc = cfg.location
        alive = cfg.trace.alive
        removed_here = 0
        for i, a in enumerate(cfg.trace.actions):
            if not alive[i]:
                continue
            cls = a.__class__
            if cls is Exec:
                kept += 1
                continue
            if a.src == a.dst:  # R1: μ ∈ A_{l,l}
                alive[i] = False
                removed_local += 1
                removed_here += 1
                continue
            if cls is Send:
                key: tuple = ("send", a.data, a.port, a.src, a.dst)
            else:
                key = ("recv", a.port, a.src, a.dst)
            if key in seen:  # R2: μ ∈ A
                alive[i] = False
                removed_duplicate += 1
                removed_here += 1
            else:
                seen.add(key)
                kept += 1
        if removed_here:
            by_loc[loc] = by_loc.get(loc, 0) + removed_here
    stats.kept = kept
    stats.removed_local = removed_local
    stats.removed_duplicate = removed_duplicate
    return stats


def rewrite_r3(fs: FlatSystem) -> "OptimizationStats":
    """R3 (spatial-constraint dedup) as one indexed pass, in place.

    The reference engine re-walks and rebuilds the whole tree per removed
    action; here the ``port → data`` and ``location → produces`` tables are
    built once over the alive actions and each removal pops the per-key
    FIFO index — first alive send at the source, first alive matching recv
    at the destination — making the pass linear in the action count.

    Stats count each removed pair once at the send's source *and* once at
    the recv's destination in ``by_location`` (two predicates, one per
    side), matching the reference engine.
    """
    stats = _new_stats()
    by_loc = stats.by_location

    # One scan builds everything: port → data sent over it, location →
    # data its own (alive) execs produce, the snapshot of alive send
    # occurrences in system program order (the tree engine iterates
    # `actions(c.trace)` of the pre-R3 system), and per-location FIFO
    # indexes (index lists + head pointers) over the comm keys.
    port_data: dict[str, set[str]] = {}
    produces: dict[str, set[str]] = {c.location: set() for c in fs.configs}
    snapshot: list[Send] = []
    send_fifo: dict[tuple, list[int]] = {}  # (loc, data, port, src, dst)
    recv_fifo: dict[tuple, list[int]] = {}  # (loc, port, src, dst)
    for cfg in fs.configs:
        loc = cfg.location
        prod = produces[loc]
        alive = cfg.trace.alive
        for i, a in enumerate(cfg.trace.actions):
            if not alive[i]:
                continue
            cls = a.__class__
            if cls is Send:
                port_data.setdefault(a.port, set()).add(a.data)
                snapshot.append(a)
                send_fifo.setdefault(
                    (loc, a.data, a.port, a.src, a.dst), []
                ).append(i)
            elif cls is Recv:
                recv_fifo.setdefault(
                    (loc, a.port, a.src, a.dst), []
                ).append(i)
            elif loc in a.locations:  # Exec
                prod.update(a.outputs)

    heads: dict[tuple, int] = {}
    for a in snapshot:
        if a.src == a.dst:
            continue
        if len(port_data[a.port]) != 1:
            continue
        if a.data not in produces.get(a.dst, ()):
            continue
        skey = (a.src, a.data, a.port, a.src, a.dst)
        rkey = (a.dst, a.port, a.src, a.dst)
        sq = send_fifo.get(skey)
        rq = recv_fifo.get(rkey)
        if sq is None or rq is None:
            continue
        shead = heads.get(skey, 0)
        rhead = heads.get(rkey, 0)
        if shead >= len(sq) or rhead >= len(rq):
            continue  # one side already exhausted — keep the other intact
        heads[skey] = shead + 1
        heads[rkey] = rhead + 1
        fs[a.src].trace.alive[sq[shead]] = False
        fs[a.dst].trace.alive[rq[rhead]] = False
        stats.removed_duplicate += 2
        by_loc[a.src] = by_loc.get(a.src, 0) + 1
        by_loc[a.dst] = by_loc.get(a.dst, 0) + 1
    return stats


#: Flat in-place engines by rule name (same keys as
#: :data:`repro_torch.core.optimizer.REWRITE_RULES`).
FLAT_RULES = {
    "R1R2": rewrite_r1r2,
    "R3": rewrite_r3,
}


def rewrite_flat_pipeline(
    w: WorkflowSystem, rules: tuple[str, ...]
) -> tuple[WorkflowSystem, list["OptimizationStats"]]:
    """Apply ``rules`` with ONE flatten and ONE rebuild around the passes.

    The fast path behind :meth:`repro_torch.api.Plan.optimize`: flattening and
    tree reconstruction are paid once for the whole rule list instead of
    once per rule.
    """
    unknown = [r for r in rules if r not in FLAT_RULES]
    if unknown:
        raise KeyError(f"unknown flat rewrite rules {unknown}")
    fs = FlatSystem.from_system(w)
    stats = [FLAT_RULES[r](fs) for r in rules]
    return fs.rebuild_system(), stats
