"""Front-end translators — the ``SWIRLTranslator`` layer of the toolchain.

The paper's toolchain translates product-specific workflow languages (CWL,
DAX, GWF) into SWIRL.  Offline we implement the same abstract class with
concrete translators for:

* :class:`DagTranslator` — a generic step-adjacency description (the common
  denominator of DAX/CWL DAGs): ``{step: [dependent steps]}`` plus a
  step→locations mapping.  One port + one data element is materialised per
  producer step output edge group, exactly like DAX's file-based edges.
* :func:`genomes_1000` — the paper's §6/Appendix B evaluation workflow,
  parameterised by ``(n, m, a, b, c)``.
* :class:`TrainPipelineTranslator` — swirl-jax's own front-end: a multi-pod
  training iteration (data shards → per-pod train steps → gradient
  synchronisation → optimiser update → checkpoint) as a distributed workflow
  instance.  ``launch/train.py`` drives distribution through this path, making
  the paper's technique the framework's first-class scheduling layer.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

from .graph import DistributedWorkflowInstance, make_workflow


class SWIRLTranslator(ABC):
    """Abstract translator: front-end description → distributed instance."""

    @abstractmethod
    def instance(self) -> DistributedWorkflowInstance:
        ...


# ---------------------------------------------------------------------------
# Generic DAG front-end
# ---------------------------------------------------------------------------


@dataclass
class DagTranslator(SWIRLTranslator):
    """``edges[s] = [s', ...]`` step DAG + ``mapping[s] = (l, ...)``.

    For every producer step ``s`` with successors, one port ``p^s`` and one
    data element ``d^s`` are created (all successors read the same datum —
    multiple output edges from one port, as Def. 1 allows).  Source steps
    with no predecessors consume nothing; their inputs, if any, must be
    provided via ``initial_data``.
    """

    edges: Mapping[str, Sequence[str]]
    mapping: Mapping[str, Sequence[str]]
    initial_data: Mapping[str, Iterable[str]] = field(default_factory=dict)

    def instance(self) -> DistributedWorkflowInstance:
        steps = set(self.edges) | {t for ts in self.edges.values() for t in ts}
        ports, data, deps, placement = set(), set(), set(), {}
        for s, succs in self.edges.items():
            if not succs:
                continue
            p, d = f"p^{s}", f"d^{s}"
            ports.add(p)
            data.add(d)
            placement[d] = p
            deps.add((s, p))
            for t in succs:
                deps.add((p, t))
        wf = make_workflow(steps, ports, deps)
        locations = frozenset(l for ls in self.mapping.values() for l in ls)
        return DistributedWorkflowInstance(
            workflow=wf,
            locations=locations,
            mapping={s: tuple(ls) for s, ls in self.mapping.items()},
            data=frozenset(data),
            placement=placement,
            initial_data={l: frozenset(ds) for l, ds in self.initial_data.items()},
        )


# ---------------------------------------------------------------------------
# 1000 Genomes (paper §6 / Appendix B)
# ---------------------------------------------------------------------------


def genomes_1000(
    n: int = 4, m: int = 3, a: int = 2, b: int = 2, c: int = 2
) -> DistributedWorkflowInstance:
    """The 1000 Genomes workflow instance of Table 1 / Fig. 5-6.

    ``n`` individuals steps over ``a`` locations, one individuals_merge, one
    sifting, ``m`` mutations_overlap steps over ``b`` locations and ``m``
    frequency steps over ``c`` locations, plus the auxiliary step
    ``s_0`` on ``l^d`` distributing the initial data.
    """
    steps = {"s0", "sIM", "sSF"}
    ports: set[str] = set()
    deps: set[tuple[str, str]] = set()
    data: set[str] = set()
    placement: dict[str, str] = {}
    mapping: dict[str, tuple[str, ...]] = {
        "s0": ("l^d",),
        "sIM": ("l^IM",),
        "sSF": ("l^SF",),
    }

    def port(name: str, datum: str, producer: str, consumers: Iterable[str]):
        ports.add(name)
        data.add(datum)
        placement[datum] = name
        deps.add((producer, name))
        for cstep in consumers:
            deps.add((name, cstep))

    # individuals: s^I_i on l^I_{(i-1) % a + 1}, fed by d0_i from s0.
    for i in range(1, n + 1):
        s = f"sI_{i}"
        steps.add(s)
        mapping[s] = (f"l^I_{(i - 1) % a + 1}",)
        port(f"p0_{i}", f"d0_{i}", "s0", [s])
        port(f"pI_{i}", f"dI_{i}", s, ["sIM"])

    # sifting input from s0 on l^d; its output feeds every MO and F step.
    port("p0_SF", "d0_SF", "s0", ["sSF"])

    # individuals_merge output d^IM and sifting output d^SF feed all MO/F.
    mo_steps, f_steps = [], []
    for h in range(1, m + 1):
        smo, sf = f"sMO_{h}", f"sF_{h}"
        steps |= {smo, sf}
        mo_steps.append(smo)
        f_steps.append(sf)
        mapping[smo] = (f"l^MO_{(h - 1) % b + 1}",)
        mapping[sf] = (f"l^F_{(h - 1) % c + 1}",)
        port(f"pP_{h}", f"dP_{h}", "s0", [smo, sf])
    port("p^IM", "d^IM", "sIM", mo_steps + f_steps)
    port("p^SF", "d^SF", "sSF", mo_steps + f_steps)

    locations = frozenset(
        {"l^d", "l^IM", "l^SF"}
        | {f"l^I_{j}" for j in range(1, a + 1)}
        | {f"l^MO_{t}" for t in range(1, b + 1)}
        | {f"l^F_{k}" for k in range(1, c + 1)}
    )
    wf = make_workflow(steps, ports, deps)
    # l^d initially owns every d0/dP input (G(l^d)).
    initial = {
        "l^d": frozenset(
            {f"d0_{i}" for i in range(1, n + 1)}
            | {f"dP_{h}" for h in range(1, m + 1)}
            | {"d0_SF"}
        )
    }
    return DistributedWorkflowInstance(
        workflow=wf,
        locations=locations,
        mapping=mapping,
        data=frozenset(data),
        placement=placement,
        initial_data=initial,
    )


# ---------------------------------------------------------------------------
# swirl-jax training-pipeline front-end
# ---------------------------------------------------------------------------


@dataclass
class TrainPipelineTranslator(SWIRLTranslator):
    """One training iteration over ``n_pods`` pods as a workflow instance.

    Steps (per iteration):
      * ``shard_<i>``    — produce pod-``i``'s input batch shard (on ``pod<i>``)
      * ``fwdbwd_<i>``   — forward+backward on pod ``i`` → local gradients
      * ``gradsync``     — hierarchical gradient synchronisation (mapped onto
        *all* pods: the spatial constraint models the collective — every pod
        participates and each ends up with the synchronised gradient copy)
      * ``update_<i>``   — optimiser update per pod (ZeRO-local)
      * ``ckpt``         — checkpoint step on pod 0 (optional)

    Per-pod replica state (``params_<i>``, ``opt_<i>``) and the iteration
    number enter as *initial ports* (no producing step — the same device as
    the paper's App. B data on ``l^d``), resident in ``G(pod<i>)``.

    Encoding + the paper's optimisation then produce exactly the minimal
    communication plan: R1 removes same-pod transfers (data/grad stay local),
    R2 coalesces the duplicate broadcast of the synchronised gradients.
    """

    n_pods: int = 2
    with_checkpoint: bool = True

    def instance(self) -> DistributedWorkflowInstance:
        pods = [f"pod{i}" for i in range(self.n_pods)]
        steps, ports, deps = set(), set(), set()
        data, placement = set(), {}
        mapping: dict[str, tuple[str, ...]] = {}
        initial: dict[str, set[str]] = {p: set() for p in pods}

        def port(name, datum, producer, consumers):
            ports.add(name)
            data.add(datum)
            placement[datum] = name
            if producer is not None:
                deps.add((producer, name))
            for cstep in consumers:
                deps.add((name, cstep))

        for i, pod in enumerate(pods):
            sh, fb, up = f"shard_{i}", f"fwdbwd_{i}", f"update_{i}"
            steps |= {sh, fb, up}
            mapping[sh] = (pod,)
            mapping[fb] = (pod,)
            mapping[up] = (pod,)
            # initial (resident) state for this pod
            port(f"p_iter_{i}", f"iter_{i}", None, [sh])
            port(f"p_params_{i}", f"params_{i}", None, [fb, up])
            port(f"p_opt_{i}", f"opt_{i}", None, [up])
            initial[pod] |= {f"iter_{i}", f"params_{i}", f"opt_{i}"}
            port(f"p_batch_{i}", f"batch_{i}", sh, [fb])
            port(f"p_grad_{i}", f"grad_{i}", fb, ["gradsync"])
            # updated replica state: consumed by ckpt on pod0 (if enabled),
            # read back by the caller between iterations either way
            port(
                f"p_state_{i}", f"state_{i}", up,
                ["ckpt"] if (self.with_checkpoint and i == 0) else [],
            )
        steps.add("gradsync")
        mapping["gradsync"] = tuple(pods)
        port("p_gsync", "grad_sync", "gradsync", [f"update_{i}" for i in range(self.n_pods)])
        if self.with_checkpoint:
            steps.add("ckpt")
            mapping["ckpt"] = (pods[0],)

        wf = make_workflow(steps, ports, deps)
        return DistributedWorkflowInstance(
            workflow=wf,
            locations=frozenset(pods),
            mapping=mapping,
            data=frozenset(data),
            placement=placement,
            initial_data={l: frozenset(ds) for l, ds in initial.items()},
        )


# ---------------------------------------------------------------------------
# Pipeline-parallel front-end (stages as locations)
# ---------------------------------------------------------------------------


@dataclass
class PipelineTranslator(SWIRLTranslator):
    """``n_stages`` pipeline stages × ``n_microbatches`` as a workflow.

    Stage ``j`` of microbatch ``k`` depends on stage ``j-1`` of the same
    microbatch; each stage is pinned to its own location.  The SWIRL send/recv
    pairs between consecutive stages are what ``launch``'s bundle compiler
    lowers to ``ppermute`` on the stage mesh axis.
    """

    n_stages: int = 4
    n_microbatches: int = 2

    def instance(self) -> DistributedWorkflowInstance:
        steps, ports, deps = set(), set(), set()
        data, placement, mapping = set(), {}, {}
        for k in range(self.n_microbatches):
            for j in range(self.n_stages):
                s = f"stage{j}_mb{k}"
                steps.add(s)
                mapping[s] = (f"stage{j}",)
                if j > 0:
                    p, d = f"p_{j - 1}to{j}_mb{k}", f"act_{j - 1}to{j}_mb{k}"
                    ports.add(p)
                    data.add(d)
                    placement[d] = p
                    deps.add((f"stage{j - 1}_mb{k}", p))
                    deps.add((p, s))
        wf = make_workflow(steps, ports, deps)
        return DistributedWorkflowInstance(
            workflow=wf,
            locations=frozenset(f"stage{j}" for j in range(self.n_stages)),
            mapping=mapping,
            data=frozenset(data),
            placement=placement,
        )
