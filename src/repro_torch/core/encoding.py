"""Encoding function ``⟦·⟧ : W_I → W_W`` — Definitions 10-12 of the paper.

Given a distributed workflow instance ``I = (W, L, M, D, I)``, the encoding
produces the workflow system

    W_Init = Π_{l ∈ L} ⟨l, G(l), Π_{s ∈ Q(l)} B_l(s)⟩

where each *building block* ``B_l(s)`` (Def. 10) is

    (Π recv(I(d_i), l_j, l))         for every input datum and every
                                      location of its producing step
    . exec(s, In^D(s) ↦ Out^D(s), M(s))
    . (Π send(d_i ↣ I(d_i), l, l_j)) for every output datum, every consumer
                                      step, and every location it maps to

Determinism: all the Π iterations follow a fixed (sorted / mapping) order so
that encoding the same instance twice yields the identical system — the
paper-exactness tests rely on this.

Two output forms implement the same Def.-10 block enumeration:

* :func:`encode`      — the tree syntax (``W_Init`` as Seq/Par trees), via
  :func:`building_block`/:func:`_block_parts`;
* :func:`encode_flat` — the flat IR (:class:`~repro_torch.core.flat.FlatSystem`),
  emitting the per-location action arrays and structure skeleton directly
  from precomputed per-step templates, without materialising any tree
  nodes.  The two enumerations are kept honest against each other by the
  exact-equality property ``encode_flat(I).to_system() == encode(I)``
  (tests/test_flat_ir.py), so the fast compilation paths can stay in the
  flat domain end to end.
"""

from __future__ import annotations

from .flat import OP_ACT, OP_NIL, OP_PAR, OP_SEQ, FlatConfig, FlatSystem, FlatTrace
from .graph import DistributedWorkflowInstance
from .syntax import (
    Action,
    Exec,
    LocationConfig,
    Recv,
    Send,
    Trace,
    WorkflowSystem,
    par,
    seq,
)


def _block_parts(
    inst: DistributedWorkflowInstance, s: str, l: str
) -> tuple[list[Recv], Exec, list[Send]]:
    """The three pieces of ``B_l(s)`` (Def. 10) as action lists."""
    if l not in inst.locs_of(s):
        raise ValueError(f"step {s!r} is not mapped onto location {l!r}")

    # (i) receive every input data element from every location of its producer
    recvs: list[Recv] = []
    for d in sorted(inst.in_data(s)):
        port = inst.port_of(d)
        producers = sorted(inst.producers_of_data(d))
        if not producers:
            # Initial port with no producing step: the data must be part of
            # G(l) (cf. App. B, handled by the auxiliary step s_0 in the
            # translate front-end). Nothing to receive.
            continue
        for ps in producers:
            for lj in inst.locs_of(ps):
                recvs.append(Recv(port, lj, l))

    ex = Exec(s, inst.in_data(s), inst.out_data(s), inst.locs_of(s))

    # (iii) send every output datum to every consumer step's locations
    sends: list[Send] = []
    for d in sorted(inst.out_data(s)):
        port = inst.port_of(d)
        for sk in sorted(inst.consumers_of_data(d)):
            for lj in inst.locs_of(sk):
                sends.append(Send(d, port, l, lj))

    return recvs, ex, sends


def building_block(inst: DistributedWorkflowInstance, s: str, l: str) -> Trace:
    """``B_l(s)`` per Def. 10."""
    recvs, ex, sends = _block_parts(inst, s, l)
    return seq(par(*recvs), ex, par(*sends))


def encode(inst: DistributedWorkflowInstance) -> WorkflowSystem:
    """``⟦I⟧`` per Def. 11 / Def. 12 (initial state ``W_Init``)."""
    configs = []
    for l in sorted(inst.locations):
        blocks = [building_block(inst, s, l) for s in inst.work_queue(l)]
        configs.append(LocationConfig(l, inst.g(l), par(*blocks)))
    return WorkflowSystem(tuple(configs))


# ---------------------------------------------------------------------------
# Flat-form encoding — same blocks, no tree nodes
# ---------------------------------------------------------------------------


def _emit_group(
    ops: list[tuple[int, int]],
    actions: list[Action],
    group: list[Action],
) -> int:
    """Emit ``par(*group)`` ops; returns 1 if anything was emitted, else 0."""
    if not group:
        return 0
    if len(group) > 1:
        ops.append((OP_PAR, len(group)))
    for a in group:
        ops.append((OP_ACT, len(actions)))
        actions.append(a)
    return 1


def encode_flat(inst: DistributedWorkflowInstance) -> FlatSystem:
    """``⟦I⟧`` emitted directly as a :class:`~repro_torch.core.flat.FlatSystem`.

    Structurally identical to :func:`encode` — the emitted skeleton mirrors
    what the ``seq``/``par`` smart constructors build: empty recv/send
    groups vanish, singleton groups inline, a block with no comms is its
    bare exec, and a location with one block is that block itself.

    The per-step recv/send templates (everything in ``B_l(s)`` that does
    not depend on ``l``) are computed once and instantiated per location,
    so a 10k-step encode performs no repeated sorting or relation scans.
    """
    topo = inst.workflow.topological_steps()
    # Grab the adjacency/port indexes once — the per-call accessor wrappers
    # cost more than the lookups themselves at 10k-step scale.
    adj = inst.workflow._adjacency()
    in_ports, out_ports = adj["in_ports"], adj["out_ports"]
    in_steps = adj["in_steps"]
    by_port = inst.instance._port_index()
    port_of = inst.placement
    mapping = inst.mapping
    empty: frozenset[str] = frozenset()

    # Per-step templates: recv sources (port, producer-location) and send
    # targets (datum, port, consumer-location), in Def.-10 emission order.
    recv_tmpl: dict[str, list[tuple[str, str]]] = {}
    send_tmpl: dict[str, list[tuple[str, str, str]]] = {}
    execs: dict[str, Exec] = {}
    producers_sorted: dict[str, list[str]] = {}
    consumers_sorted: dict[str, list[str]] = {}
    for s in topo:
        in_data: frozenset[str] = empty
        for p in in_ports.get(s, ()):
            in_data = in_data | by_port.get(p, empty)
        out_data: frozenset[str] = empty
        for p in out_ports.get(s, ()):
            out_data = out_data | by_port.get(p, empty)
        rt: list[tuple[str, str]] = []
        for d in sorted(in_data):
            port = port_of[d]
            producers = producers_sorted.get(d)
            if producers is None:
                producers = producers_sorted[d] = sorted(
                    in_steps.get(port, ())
                )
            for ps in producers:
                for lj in mapping[ps]:
                    rt.append((port, lj))
        recv_tmpl[s] = rt
        st: list[tuple[str, str, str]] = []
        for d in sorted(out_data):
            port = port_of[d]
            consumers = consumers_sorted.get(d)
            if consumers is None:
                consumers = consumers_sorted[d] = sorted(
                    inst.consumers_of_data(d)
                )
            for sk in consumers:
                for lj in mapping[sk]:
                    st.append((d, port, lj))
        send_tmpl[s] = st
        execs[s] = Exec(s, in_data, out_data, mapping[s])

    configs: list[FlatConfig] = []
    for l in sorted(inst.locations):
        queue = inst.work_queue(l)
        ops: list[tuple[int, int]] = []
        actions: list[Action] = []
        if not queue:
            ops.append((OP_NIL, 0))
        else:
            if len(queue) > 1:
                ops.append((OP_PAR, len(queue)))
            for s in queue:
                recvs: list[Action] = [
                    Recv(port, lj, l) for port, lj in recv_tmpl[s]
                ]
                sends: list[Action] = [
                    Send(d, port, l, lj) for d, port, lj in send_tmpl[s]
                ]
                n_items = 1 + (1 if recvs else 0) + (1 if sends else 0)
                if n_items > 1:
                    ops.append((OP_SEQ, n_items))
                _emit_group(ops, actions, recvs)
                ops.append((OP_ACT, len(actions)))
                actions.append(execs[s])
                _emit_group(ops, actions, sends)
        configs.append(
            FlatConfig(l, inst.g(l), FlatTrace(ops, actions))
        )
    return FlatSystem(configs)
