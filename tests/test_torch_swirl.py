"""The port's plan machinery (``repro_torch.swirl``) against the reference's.

The same workflow instances — seeded random layered DAGs from
``test_differential.random_instance`` and the paper's 1000 Genomes instance
— are traced, optimised with R1R2 and R3 and lowered by both packages; the
canonical ``.swirl`` text, the fingerprint, the per-location programs and
the fusion planner's segments must be equal.  So must the plans of the
training and pipeline translators, and the port's flat rewriting engines
must agree with its tree engines.  What the port refused before it ported
tracing, scheduling and certification is checked to run now, and what it
still refuses to be refused.
"""

from __future__ import annotations

import dataclasses
import random

import pytest
import torch
from test_differential import random_instance

import repro.backends as jbackends
from repro import swirl as jswirl
from repro.backends.jax_backend import _plan_segments as j_plan_segments
from repro.core import translate as jtranslate
from repro.core.parser import dumps as j_dumps
from repro.core.translate import DagTranslator as JDagTranslator
from repro.core.translate import genomes_1000 as j_genomes
from repro_torch import swirl as tswirl
from repro_torch.backends import UnknownBackendError, available_backends
from repro_torch.backends.torch_backend import _plan_segments as t_plan_segments
from repro_torch.core import optimizer as toptimizer
from repro_torch.core import translate as ttranslate
from repro_torch.core.encoding import encode as t_encode
from repro_torch.core.graph import DistributedWorkflowInstance as TInstance
from repro_torch.core.graph import make_workflow as t_make_workflow
from repro_torch.core.parser import dumps as t_dumps
from repro_torch.core.translate import DagTranslator as TDagTranslator
from repro_torch.core.translate import genomes_1000 as t_genomes

CHUNKS = 10
CHUNK_SIZE = 6  # CHUNKS × CHUNK_SIZE = 60 random DAGs
RULES = ("R1R2", "R3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(inst):
    """The reference's instance rebuilt from the port's own classes."""
    wf = inst.workflow
    return TInstance(
        workflow=t_make_workflow(wf.steps, wf.ports, wf.deps),
        locations=inst.locations,
        mapping=dict(inst.mapping),
        data=inst.data,
        placement=dict(inst.placement),
        initial_data=dict(inst.initial_data),
    )


def dags(chunk: int) -> list:
    rng = random.Random(14_000 + chunk)
    return [random_instance(rng) for _ in range(CHUNK_SIZE)]


def op_lists(program) -> dict:
    """Per-location op lists and control skeletons as plain tuples."""
    return {
        lp.location: (
            [(type(op).__name__, dataclasses.astuple(op)) for op in lp.ops],
            lp.structure,
            lp.data,
        )
        for lp in program.programs
    }


def segments(program, plan_segments) -> dict:
    return {
        start: [(op.step, tuple(picks)) for op, picks in acts]
        for start, acts in plan_segments(program).items()
    }


def assert_same_plan(jplan, tplan) -> None:
    text = j_dumps(jplan.system)
    assert t_dumps(tplan.system) == text
    assert tplan.fingerprint() == jplan.fingerprint()
    assert tplan.steps() == jplan.steps()
    assert tplan.placement() == jplan.placement()
    assert op_lists(tplan.exec_program()) == op_lists(jplan.exec_program())
    assert segments(tplan.exec_program(), t_plan_segments) == segments(
        jplan.exec_program(), j_plan_segments
    )
    assert [(r.rule, r.stats.removed_local, r.stats.removed_duplicate, r.stats.kept)
            for r in tplan.rewrites] == [
        (r.rule, r.stats.removed_local, r.stats.removed_duplicate, r.stats.kept)
        for r in jplan.rewrites
    ]
    # explain() up to its timings, which are wall-clock.
    cut = "-- timings --"
    assert tplan.explain().split(cut)[0] == jplan.explain().split(cut)[0]


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dags_give_equal_plans(chunk):
    for inst in dags(chunk):
        jraw, traw = jswirl.trace(inst), tswirl.trace(to_port(inst))
        assert t_dumps(traw.system) == j_dumps(jraw.system)
        assert_same_plan(jraw.optimize(RULES), traw.optimize(RULES))


@pytest.mark.parametrize("rules", [(), ("R1R2",), ("R3",), RULES])
def test_genomes_gives_equal_plans(rules):
    kw = dict(n=4, m=3, a=2, b=2, c=2)
    jplan = jswirl.trace(j_genomes(**kw)).optimize(rules)
    tplan = tswirl.trace(t_genomes(**kw)).optimize(rules)
    assert_same_plan(jplan, tplan)


@pytest.mark.parametrize(
    "translator, kw",
    [
        ("TrainPipelineTranslator", dict(n_pods=2)),
        ("TrainPipelineTranslator", dict(n_pods=4, with_checkpoint=False)),
        ("PipelineTranslator", dict(n_stages=4, n_microbatches=3)),
    ],
)
def test_translators_give_equal_plans(translator, kw):
    jplan = jswirl.trace(getattr(jtranslate, translator)(**kw)).optimize(RULES)
    tplan = tswirl.trace(getattr(ttranslate, translator)(**kw)).optimize(RULES)
    assert_same_plan(jplan, tplan)


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_flat_engines_match_the_tree_engines(chunk):
    # The port's copy keeps the reference's recursive rewriters as the
    # oracle of its flat engines, as the reference's own tests do.
    for inst in dags(chunk):
        system = t_encode(to_port(inst))
        for rule, flat in toptimizer.REWRITE_RULES.items():
            tree = toptimizer.REWRITE_RULES_TREE[rule]
            (fw, fs), (tw, ts) = flat(system), tree(system)
            assert t_dumps(fw) == t_dumps(tw)
            assert (fs.removed_local, fs.removed_duplicate, fs.kept) == (
                ts.removed_local, ts.removed_duplicate, ts.kept)


def test_swirl_text_round_trips_through_the_port():
    inst = dags(0)[0]
    text = j_dumps(jswirl.trace(inst).optimize(RULES).system)
    assert t_dumps(tswirl.trace(text).system) == text
    assert t_dumps(tswirl.trace(text).system) == j_dumps(jswirl.trace(text).system)


def test_dag_sugar_and_translator_give_equal_plans():
    edges = {"a": ["b", "c"], "b": ["d"], "c": ["d"], "d": []}
    mapping = {"a": ["l0"], "b": ["l1"], "c": ["l0", "l1"], "d": ["l2"]}
    jplan = jswirl.trace(edges, mapping=mapping).optimize(RULES)
    tplan = tswirl.trace(edges, mapping=mapping).optimize(RULES)
    assert_same_plan(jplan, tplan)
    jt = jswirl.trace(JDagTranslator(edges=edges, mapping=mapping))
    tt = tswirl.trace(TDagTranslator(edges=edges, mapping=mapping))
    assert t_dumps(tt.system) == j_dumps(jt.system)


def test_placement_override_rederives_equal_plans():
    inst = t_genomes(n=4, m=3, a=2, b=2, c=2)
    jinst = j_genomes(n=4, m=3, a=2, b=2, c=2)
    over = {"sIM": ("l^SF",), "sF_1": ("l^MO_1",)}
    jl = jswirl.trace(jinst).optimize(RULES).lower("inprocess", placement=over)
    tl = tswirl.trace(inst).optimize(RULES).lower("torch", placement=over, platform="cpu")
    assert_same_plan(jl.plan, tl.plan)
    before = tswirl.compile_cache_stats()
    tswirl.trace(inst).optimize(RULES).lower("torch", placement=over, platform="cpu")
    assert tswirl.compile_cache_stats()["hits"] == before["hits"] + 1


# -- what the port refused before, and what it still refuses ---------------------


def _plan():
    return tswirl.trace(t_genomes(n=2, m=1, a=1, b=1, c=1)).optimize(RULES)


@pytest.mark.parametrize("option", ["trace", "schedule", "workers"])
def test_unported_lowering_options_raise_the_unknown_option_error(option):
    """``trace`` and ``schedule`` are ported now and accepted; ``workers``
    (the reference's multiprocess backend's option) still raises the
    unknown-option error."""
    plan = _plan()
    if option == "workers":
        with pytest.raises(TypeError, match=r"unknown options for backend 'torch'.*supported:.*policy"):
            plan.lower("torch", **{option: True})
        return
    value = True if option == "trace" else plan.schedule().schedule_report
    lowered = plan.lower("torch", platform="cpu", **{option: value})
    assert lowered.options[option] is value
    res = lowered.compile({s: (lambda i, s=s: {d: s for d in plan.instance.out_data(s)})
                           for s in plan.steps()}).run()
    assert (res.profile is not None) == (option == "trace")
    assert res.stats["execs"] == len(plan.steps())


def test_unported_stages_raise_by_name():
    """What the port refused by name before its trace, schedule and certify
    slice now runs; a bad placement string and every other backend name are
    still refused."""
    plan = _plan()
    auto = plan.lower("torch", placement="auto", platform="cpu")
    assert auto.plan.schedule_report is not None
    assert auto.options["schedule"] is auto.plan.schedule_report
    with pytest.raises(ValueError, match="placement must be"):
        plan.lower("torch", placement="round-robin")
    certified = plan.optimize(RULES, certify=True)
    assert certified.certificate is not None and certified.certificate.equivalent
    assert plan.schedule().schedule_report is not None
    fns = {s: (lambda i, s=s: {d: s for d in plan.instance.out_data(s)}) for s in plan.steps()}
    traced = plan.lower("torch", trace=True, platform="cpu").compile(fns).run()
    report = plan.profile(traced)
    assert report.backend == "torch" and report.drifts
    for name in ("jax", "threaded", "multiprocess", "nope"):
        with pytest.raises(UnknownBackendError, match="available: \\('inprocess', 'torch'\\)"):
            plan.lower(name)


def test_registry_is_the_ports_own():
    assert available_backends() == ("inprocess", "torch")
    _plan().lower("torch", platform="cpu")
    _plan().lower("inprocess")
    assert "torch" not in jbackends._REGISTRY
    assert "torch" not in jbackends.available_backends()
    assert jbackends.get_backend("inprocess").__module__ == "repro.backends.inprocess"


def test_default_platform_is_cuda_and_raises_without_it(monkeypatch):
    plan = _plan()
    fns = {s: (lambda i: {}) for s in plan.steps()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        plan.lower("torch").compile(fns).run()
    with pytest.raises(RuntimeError, match="is_available"):
        plan.lower("torch", fuse=True).compile(fns).run()
    with pytest.raises(RuntimeError, match="is_available"):
        plan.lower("torch", devices=["cuda:0"]).compile(fns).run()
