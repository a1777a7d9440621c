"""The port's reduction semantics and bisimulation checker against the reference's.

``repro_torch.core.semantics`` and ``repro_torch.core.bisim`` are copies of
the reference's modules; on the same systems they must explore the same
labelled transition systems (equal state counts, equal edges), reach the
same verdicts, and ``optimize(certify=True)`` must attach an equal
certificate.  The systems: 20 small layered DAGs drawn from numpy seeds,
1000 Genomes at the smallest scale the checker explores within its
20,000-state limit, the 12-step rmsnorm pipeline, the quickstart plan, and
planted pairs that are not equivalent.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch
from test_torch_dataplane import RULES, pipeline
from test_torch_swirl import to_port

from repro import swirl as jswirl
from repro.core import bisim as jbisim
from repro.core import semantics as jsem
from repro.core.graph import DistributedWorkflowInstance as JInstance
from repro.core.graph import make_workflow as j_make_workflow
from repro.core.parser import parse_system as j_parse
from repro.core.translate import genomes_1000 as j_genomes
from repro_torch import swirl as tswirl
from repro_torch.core import bisim as tbisim
from repro_torch.core import semantics as tsem
from repro_torch.core.graph import DistributedWorkflowInstance as TInstance
from repro_torch.core.graph import make_workflow as t_make_workflow
from repro_torch.core.parser import parse_system as t_parse
from repro_torch.core.translate import genomes_1000 as t_genomes

N_DAGS = 20
SMALL_GENOMES = dict(n=2, m=1, a=1, b=1, c=1)
EDGES = {
    "preprocess": ["train_a", "train_b"],
    "train_a": ["evaluate"],
    "train_b": ["evaluate"],
    "evaluate": ["report"],
    "report": [],
}
MAPPING = {
    "preprocess": ("cpu0",),
    "train_a": ("gpu0",),
    "train_b": ("gpu1",),
    "evaluate": ("gpu0",),
    "report": ("cpu0",),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_instance(seed: int) -> JInstance:
    """A layered DAG of 2-5 steps on 1-3 locations (a spatially constrained
    step now and then), small enough for exact state exploration."""
    rng = np.random.default_rng(20_000 + seed)
    n_steps, n_locs = int(rng.integers(2, 6)), int(rng.integers(1, 4))
    locations = [f"l{i}" for i in range(n_locs)]
    steps, ports, deps, data, placement, mapping = [], [], [], [], {}, {}
    prev: list[str] = []
    sid = 0
    while sid < n_steps:
        new: list[str] = []
        for _ in range(min(n_steps - sid, int(rng.integers(1, 3)))):
            s = f"s{sid}"
            sid += 1
            steps.append(s)
            if n_locs > 1 and rng.random() < 0.2:
                mapping[s] = tuple(sorted(rng.choice(locations, 2, replace=False).tolist()))
            else:
                mapping[s] = (locations[int(rng.integers(n_locs))],)
            for p in prev:
                if rng.random() < 0.6:
                    deps.append((p, s))
            if sid < n_steps or rng.random() < 0.5:
                p, d = f"p{s}", f"d{s}"
                ports.append(p)
                data.append(d)
                placement[d] = p
                deps.append((s, p))
                new.append(p)
        prev = new
    return JInstance(
        workflow=j_make_workflow(steps, ports, deps),
        locations=frozenset(locations),
        mapping=mapping,
        data=frozenset(data),
        placement=placement,
        initial_data={},
    )


def both_plans(seed):
    inst = small_instance(seed)
    return jswirl.trace(inst), tswirl.trace(to_port(inst))


def cert(plan):
    return dataclasses.astuple(plan.certificate)


# -- the state space -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(N_DAGS))
def test_reachable_states_equal_the_reference(seed):
    jraw, traw = both_plans(seed)
    for jp, tp in ((jraw, traw), (jraw.optimize(RULES), traw.optimize(RULES))):
        jlts = jsem.reachable_states(jp.system)
        tlts = tsem.reachable_states(tp.system)
        assert len(tlts) == len(jlts) > 0
        assert tlts == jlts  # the same canonical states and labelled edges
        assert tsem.barbs(tp.system) == jsem.barbs(jp.system)


def test_state_limit_is_the_reference_limit():
    jp = jswirl.trace(j_genomes(**SMALL_GENOMES))
    tp = tswirl.trace(t_genomes(**SMALL_GENOMES))
    n = len(jsem.reachable_states(jp.system))
    assert len(tsem.reachable_states(tp.system, max_states=n)) == n
    for sem, plan in ((jsem, jp), (tsem, tp)):
        with pytest.raises(RuntimeError, match="state space too large"):
            sem.reachable_states(plan.system, max_states=n // 2)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_runs_take_the_reference_schedule(seed):
    jp, tp = jswirl.trace(j_genomes(**SMALL_GENOMES)), tswirl.trace(t_genomes(**SMALL_GENOMES))
    for prefer_comm in (False, True):
        jr = jsem.run(jp.system, rng=random.Random(seed), prefer_comm=prefer_comm)
        tr = tsem.run(tp.system, rng=random.Random(seed), prefer_comm=prefer_comm)
        assert tr.events == jr.events
        assert tr.final.canonical() == jr.final.canonical()
        assert tr.deadlocked == jr.deadlocked is False


# -- verdicts ------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(N_DAGS))
def test_optimised_dags_are_bisimilar_on_both_sides(seed):
    jraw, traw = both_plans(seed)
    jo, to = jraw.optimize(RULES), traw.optimize(RULES)
    jv = jbisim.weak_barbed_bisimilar(jraw.system, jo.system)
    tv = tbisim.weak_barbed_bisimilar(traw.system, to.system)
    assert tv is jv is True


def test_genomes_optimised_is_bisimilar_on_both_sides():
    jraw = jswirl.trace(j_genomes(**SMALL_GENOMES))
    traw = tswirl.trace(t_genomes(**SMALL_GENOMES))
    jo, to = jraw.optimize(RULES), traw.optimize(RULES)
    assert tbisim.weak_barbed_bisimilar(traw.system, to.system) is True
    assert jbisim.weak_barbed_bisimilar(jraw.system, jo.system) is True


PLANTED = [
    # An exec dropped: observable.
    ("<l,{d},exec(s,{d}->{},{l}).exec(t,{d}->{},{l})>",
     "<l,{d},exec(s,{d}->{},{l})>"),
    # A recv dropped: the consumer can never fire.
    ("<l,{d},exec(s,{d}->{d1},{l}).send(d1->p1,l,lp)> | "
     "<lp,{},recv(p1,l,lp).exec(t,{d1}->{},{lp})>",
     "<l,{d},exec(s,{d}->{d1},{l}).send(d1->p1,l,lp)> | "
     "<lp,{},exec(t,{d1}->{},{lp})>"),
    # Two execs reordered: a different barb comes first.
    ("<l,{d},exec(s,{d}->{},{l}).exec(t,{d}->{},{l})>",
     "<l,{d},exec(t,{d}->{},{l}).exec(s,{d}->{},{l})>"),
]


@pytest.mark.parametrize("pair", range(len(PLANTED)))
def test_planted_non_equivalent_pairs_are_refused_on_both_sides(pair):
    w, o = PLANTED[pair]
    assert jbisim.weak_barbed_bisimilar(j_parse(w), j_parse(o)) is False
    assert tbisim.weak_barbed_bisimilar(t_parse(w), t_parse(o)) is False
    assert tbisim.weak_barbed_bisimilar(t_parse(w), t_parse(w)) is True


# -- Plan.certify ------------------------------------------------------------------------


def certify_cases():
    return {
        "quickstart": (jswirl.trace(EDGES, mapping=MAPPING),
                       tswirl.trace(EDGES, mapping=MAPPING)),
        "genomes": (jswirl.trace(j_genomes(**SMALL_GENOMES)),
                    tswirl.trace(t_genomes(**SMALL_GENOMES))),
        "pipeline": (jswirl.trace(pipeline(JInstance, j_make_workflow)),
                     tswirl.trace(pipeline(TInstance, t_make_workflow))),
    }


@pytest.mark.parametrize("case", ["quickstart", "genomes", "pipeline"])
def test_optimize_certify_attaches_an_equal_certificate(case):
    jraw, traw = certify_cases()[case]
    jp = jraw.optimize(RULES, certify=True)
    tp = traw.optimize(RULES, certify=True)
    assert tp.certificate is not None and tp.certificate.equivalent
    assert cert(tp) == cert(jp)
    assert tp.fingerprint() == jp.fingerprint()
    line = "  certificate:"
    assert [ln for ln in tp.explain().splitlines() if ln.startswith(line)] == [
        ln for ln in jp.explain().splitlines() if ln.startswith(line)]
    assert traw.optimize(RULES).certificate is None
    # A further optimise drops the certificate, as in the reference.
    assert tp.optimize(("R3",)).certificate is None


@pytest.mark.parametrize("seed", range(0, N_DAGS, 4))
def test_seeded_dag_certificates_equal_the_reference(seed):
    jraw, traw = both_plans(seed)
    assert cert(traw.optimize(RULES, certify=True)) == cert(jraw.optimize(RULES, certify=True))
    # A raw plan certifies against itself.
    assert cert(traw.certify()) == cert(jraw.certify())


def test_scheduled_plan_certifies_as_the_reference():
    from repro.sched import NetworkModel as JNet
    from repro_torch.sched import NetworkModel as TNet

    jraw, traw = certify_cases()["genomes"]
    js = jraw.optimize(RULES, certify=True).schedule(JNet.preset("two-rack")).certify()
    ts = traw.optimize(RULES, certify=True).schedule(TNet.preset("two-rack")).certify()
    assert cert(ts) == cert(js) and ts.certificate.equivalent
    assert ts.fingerprint() == js.fingerprint()


def test_a_broken_rewrite_fails_certification():
    w, o = PLANTED[0]
    tplan = tswirl.trace(w)
    broken = dataclasses.replace(tplan, system=t_parse(o), origin=tplan.system)
    with pytest.raises(AssertionError, match="broke weak barbed bisimilarity"):
        broken.certify()


def test_paper_scale_genomes_is_refused_as_in_the_reference():
    """1000 Genomes at the paper's scale (the data plane's G) has more than
    the default 20,000 states: both sides refuse to certify it alike."""
    scale = dict(n=4, m=3, a=2, b=2, c=2)
    for sw, genomes in ((jswirl, j_genomes), (tswirl, t_genomes)):
        with pytest.raises(RuntimeError, match="state space too large"):
            sw.trace(genomes(**scale)).optimize(RULES, certify=True)
