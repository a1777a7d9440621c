"""The port's ``inprocess`` backend against the reference's.

The same plans — seeded layered DAGs (``test_differential.random_instance``
and the reference's ``core/randgen``), the quickstart plan and 1000 Genomes,
each raw and optimised with R1R2 and R3 — run on both packages' ``inprocess``
backends with the same pure step bodies (``conftest.identity_step_fns``:
string payloads that spell out their inputs).  Stores must be equal, and so
must every count of the runs' ``RunStats`` and the multiset of (step, leader)
fires; retries under ``FlakyFn`` and a speculated straggler count alike;
traced runs give equal span schemas.

Checkpoints: both runtimes fire ready steps on a thread pool, so where a run
stands when a step fails depends on timing.  For a snapshot taken mid-run,
both central modules get a pool that runs each task as it is submitted:
the fires then come in one fixed order, the same on both sides, and the
snapshot after a planted ``PermanentError`` must be equal — the remaining
SWIRL term by ``dumps``, the payloads and the completed steps.  Restored
with healthy bodies, either snapshot (the reference's carried into the
port's ``Checkpoint``) must finish with the straight run's store.
"""

from __future__ import annotations

import random
from concurrent.futures import Future

import pytest
from conftest import identity_step_fns
from test_differential import random_instance
from test_torch_swirl import to_port

from repro import swirl as jswirl
from repro.core.randgen import random_layered_instance
from repro.core.translate import genomes_1000 as j_genomes
from repro.exec import central as jcentral
from repro.workflow import fault as jfault
from repro_torch import swirl as tswirl
from repro_torch.backends import get_backend
from repro_torch.core.parser import dumps as t_dumps
from repro_torch.core.randgen import random_layered_instance as t_random_layered_instance
from repro_torch.core.translate import genomes_1000 as t_genomes
from repro_torch.exec import central as tcentral
from repro_torch.workflow import Checkpoint, RunStats, WorkflowDeadlock
from repro_torch.workflow import fault as tfault

RULES = ("R1R2", "R3")
CHUNKS, CHUNK_SIZE = 6, 5  # 30 DAGs of test_differential's generator
RANDGEN = [(n, seed) for n, seed in ((8, 1), (25, 2), (60, 3), (120, 4))]
GENOMES = {"small": dict(n=2, m=1, a=1, b=1, c=1), "paper": dict(n=4, m=3, a=2, b=2, c=2)}
EDGES = {"preprocess": ["train_a", "train_b"], "train_a": ["evaluate"], "train_b": ["evaluate"],
         "evaluate": ["report"], "report": []}
MAPPING = {"preprocess": ("cpu0",), "train_a": ("gpu0",), "train_b": ("gpu1",), "evaluate": ("gpu0",),
           "report": ("cpu0",)}
COUNTS = ("execs", "comms", "retries", "speculations", "timeouts", "checkpoints")


class InlinePool:
    """A stand-in for ``ThreadPoolExecutor`` that runs each task as it is
    submitted, so that a run fires its steps in one fixed order."""

    def __init__(self, max_workers=None):
        pass

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 — the future carries it, as a pool's does
            fut.set_exception(e)
        return fut

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def genomes_init(inst) -> dict:
    return {("l^d", d): f"in:{d}" for d in sorted(inst.g("l^d"))}


def plans(jinst, tinst, rules):
    jp, tp = jswirl.trace(jinst), tswirl.trace(tinst)
    if rules:
        jp, tp = jp.optimize(rules), tp.optimize(rules)
    assert t_dumps(tp.system) == jswirl_dumps(jp.system)
    return jp, tp


def jswirl_dumps(system) -> str:
    from repro.core.parser import dumps

    return dumps(system)


def fires(stats) -> list:
    return sorted((step, leader) for step, leader, _ in stats.exec_log)


def run_both(jplan, tplan, jfns, tfns=None, init=None, jopts=None, topts=None):
    """One run on each package's inprocess backend; both results."""
    jres = jplan.lower("inprocess", **(jopts or {})).compile(jfns).run(initial_payloads=dict(init or {}))
    tres = tplan.lower("inprocess", **(topts or {})).compile(tfns or jfns).run(initial_payloads=dict(init or {}))
    return jres, tres


def assert_same_run(jres, tres) -> None:
    assert tres.backend == "inprocess" and isinstance(tres.stats, RunStats)
    assert tres.data == jres.data
    assert {k: getattr(tres.stats, k) for k in COUNTS} == {k: getattr(jres.stats, k) for k in COUNTS}
    assert fires(tres.stats) == fires(jres.stats)


def dags(chunk: int) -> list:
    rng = random.Random(20_000 + chunk)
    return [random_instance(rng) for _ in range(CHUNK_SIZE)]


# -- stores and stats -------------------------------------------------------------


@pytest.mark.parametrize("rules", [(), RULES], ids=["raw", "optimised"])
@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dags_give_equal_stores_and_stats(chunk, rules):
    for inst in dags(chunk):
        jp, tp = plans(inst, to_port(inst), rules)
        assert_same_run(*run_both(jp, tp, identity_step_fns(inst)))


@pytest.mark.parametrize("n,seed", RANDGEN)
def test_randgen_instances_give_equal_stores_and_stats(n, seed):
    inst = random_layered_instance(n, seed=seed)
    jp, tp = plans(inst, t_random_layered_instance(n, seed=seed), RULES)
    assert_same_run(*run_both(jp, tp, identity_step_fns(inst)))


@pytest.mark.parametrize("rules", [(), RULES], ids=["raw", "optimised"])
@pytest.mark.parametrize("size", sorted(GENOMES))
def test_genomes_give_equal_stores_and_stats(size, rules):
    jinst, tinst = j_genomes(**GENOMES[size]), t_genomes(**GENOMES[size])
    jp, tp = plans(jinst, tinst, rules)
    jres, tres = run_both(jp, tp, identity_step_fns(jinst), init=genomes_init(jinst))
    assert_same_run(jres, tres)
    assert tres.stats.execs == len(jinst.workflow.steps)


def test_quickstart_stores_stats_and_span_schema_equal_the_reference():
    fns = {
        "preprocess": lambda i: {"d^preprocess": list(range(10))},
        "train_a": lambda i: {"d^train_a": sum(i["d^preprocess"])},
        "train_b": lambda i: {"d^train_b": max(i["d^preprocess"])},
        "evaluate": lambda i: {"d^evaluate": i["d^train_a"] + i["d^train_b"]},
        "report": lambda i: {},
    }
    jp = jswirl.trace(EDGES, mapping=MAPPING).optimize()
    tp = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    jres, tres = run_both(jp, tp, fns, jopts={"trace": True}, topts={"trace": True})
    assert_same_run(jres, tres)
    assert tres.payload("cpu0", "d^evaluate") == 54
    assert tres.profile.span_schema() and tres.profile.span_schema() == jres.profile.span_schema()
    untraced = tp.lower("inprocess").compile(fns).run()
    assert untraced.profile is None and untraced.data == tres.data


@pytest.mark.parametrize("seed", range(4))
def test_traced_dags_give_equal_span_schemas(seed):
    inst = random_instance(random.Random(21_000 + seed))
    jp, tp = plans(inst, to_port(inst), RULES)
    jres, tres = run_both(jp, tp, identity_step_fns(inst), jopts={"trace": True}, topts={"trace": True})
    assert_same_run(jres, tres)
    assert tres.profile.span_schema() == jres.profile.span_schema()


# -- fault tolerance ----------------------------------------------------------------


def _flaky_case(seed: int, failures: int):
    inst = random_instance(random.Random(22_000 + seed))
    jp, tp = plans(inst, to_port(inst), RULES)
    fns = identity_step_fns(inst)
    victim = sorted(fns)[len(fns) // 2]
    jfns, tfns = dict(fns), dict(fns)
    jfns[victim] = jfault.FlakyFn(fns[victim], failures=failures)
    tfns[victim] = tfault.FlakyFn(fns[victim], failures=failures)
    opts = ({"retry": jfault.RetryPolicy(max_retries=2)}, {"retry": tfault.RetryPolicy(max_retries=2)})
    return inst, jp, tp, fns, jfns, tfns, opts, victim


@pytest.mark.parametrize("seed", range(3))
def test_retry_under_flaky_steps_counts_as_the_reference(seed):
    inst, jp, tp, fns, jfns, tfns, (jo, to), victim = _flaky_case(seed, failures=2)
    jres, tres = run_both(jp, tp, jfns, tfns, jopts=jo, topts=to)
    assert_same_run(jres, tres)
    assert tres.stats.retries == 2 and tfns[victim].calls == jfns[victim].calls == 3
    assert tres.data == tp.lower("inprocess").compile(fns).run().data


def test_a_step_failing_past_its_retries_raises_as_the_reference():
    inst, jp, tp, fns, jfns, tfns, (jo, to), victim = _flaky_case(0, failures=3)
    with pytest.raises(jfault.TransientError, match="after 3 attempts"):
        jp.lower("inprocess", **jo).compile(jfns).run()
    with pytest.raises(tfault.TransientError, match="after 3 attempts"):
        tp.lower("inprocess", **to).compile(tfns).run()
    assert tfns[victim].calls == jfns[victim].calls == 3


def test_a_straggler_is_speculated_as_in_the_reference():
    """A first call that sleeps 2 s against an expected 0.01 s: after 0.03 s
    (the policy's factor of 3) a backup copy runs and wins, on both sides."""
    jp = jswirl.trace(EDGES, mapping=MAPPING).optimize()
    tp = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    fns = identity_step_fns(tp.instance)
    jfns, tfns = dict(fns), dict(fns)
    jfns["train_a"] = jfault.SlowFn(fns["train_a"], delay_s=2.0)
    tfns["train_a"] = tfault.SlowFn(fns["train_a"], delay_s=2.0)
    jo = {"speculation": jfault.SpeculationPolicy(), "expected_s": {"train_a": 0.01}}
    to = {"speculation": tfault.SpeculationPolicy(), "expected_s": {"train_a": 0.01}}
    jres, tres = run_both(jp, tp, jfns, tfns, jopts=jo, topts=to)
    assert_same_run(jres, tres)
    assert tres.stats.speculations == 1 and tres.stats.wall_s < 1.5


def test_a_plan_without_a_step_body_is_refused():
    tp = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    fns = identity_step_fns(tp.instance)
    del fns["evaluate"]
    with pytest.raises(KeyError, match=r"no step function registered for \['evaluate'\]"):
        tp.lower("inprocess").compile(fns)


def test_a_run_that_cannot_terminate_raises_deadlock():
    """Two locations that each wait for the other (the reference's
    ``tests/test_runtime.py`` case), lowered by each backend directly."""
    from repro.backends import get_backend as jget_backend
    from repro.core.parser import parse_system as jparse
    from repro.workflow import WorkflowDeadlock as JWorkflowDeadlock
    from repro_torch.core.parser import parse_system as tparse

    text = "<a,{},recv(p,b,a)> | <b,{},recv(q,a,b)>"
    with pytest.raises(JWorkflowDeadlock, match="did not terminate"):
        jget_backend("inprocess").compile(jparse(text), {}, {}).run()
    with pytest.raises(WorkflowDeadlock, match="did not terminate"):
        get_backend("inprocess").compile(tparse(text), {}, {}).run()


# -- checkpoint and restore ------------------------------------------------------------


CKPT_CASES = ["dag-0", "dag-1", "dag-2", "randgen-40", "genomes-small", "genomes-paper"]


def ckpt_case(name: str):
    kind, arg = name.split("-")
    init = {}
    if kind == "dag":
        jinst = random_instance(random.Random(23_000 + int(arg)))
        tinst = to_port(jinst)
    elif kind == "randgen":
        jinst = random_layered_instance(int(arg), seed=5)
        tinst = t_random_layered_instance(int(arg), seed=5)
    else:
        jinst, tinst = j_genomes(**GENOMES[arg]), t_genomes(**GENOMES[arg])
        init = genomes_init(jinst)
    jp, tp = plans(jinst, tinst, RULES)
    return jinst, jp, tp, identity_step_fns(jinst), init


@pytest.fixture
def inline_pools(monkeypatch):
    monkeypatch.setattr(jcentral, "ThreadPoolExecutor", InlinePool)
    monkeypatch.setattr(tcentral, "ThreadPoolExecutor", InlinePool)


@pytest.mark.parametrize("case", CKPT_CASES)
def test_a_mid_run_checkpoint_equals_the_reference_and_restores(case, inline_pools):
    inst, jp, tp, fns, init = ckpt_case(case)
    straight = tp.lower("inprocess").compile(fns).run(initial_payloads=dict(init))
    order = [step for step, _, _ in straight.stats.exec_log]
    victim = order[len(order) // 2]  # fires after half the steps

    def broken(package):
        def fail(inputs):
            raise package.PermanentError(f"{victim} fails")
        return {**fns, victim: fail}

    snaps = []
    for swirl_plan, package in ((jp, jfault), (tp, tfault)):
        exe = swirl_plan.lower("inprocess").compile(broken(package))
        with pytest.raises(package.PermanentError, match=f"{victim} fails"):
            exe.run(initial_payloads=dict(init))
        snaps.append(exe.checkpoint())
    jck, tck = snaps
    assert isinstance(tck, Checkpoint)
    assert tck.system_text == jck.system_text and t_dumps(tck.system) == tck.system_text
    assert tck.completed_execs == jck.completed_execs and tck.payloads == jck.payloads
    assert 0 < len(tck.completed_execs) < len(order) and victim not in tck.completed_execs
    # Resumed with healthy bodies, each snapshot (the reference's carried into
    # the port's Checkpoint) finishes with the straight run's store, and the
    # two resumed runs count alike.
    jres = jp.lower("inprocess").compile(fns).restore(jck).run()
    carried = Checkpoint(jck.system_text, dict(jck.payloads), jck.completed_execs)
    for ck in (tck, carried):
        tres = tp.lower("inprocess").compile(fns).restore(ck).run()
        assert_same_run(jres, tres)
        assert tres.data == straight.data


@pytest.mark.parametrize("case", ["dag-0", "genomes-small"])
def test_snapshots_every_k_fires_equal_the_references(case, inline_pools, tmp_path):
    """``checkpoint_every``/``checkpoint_path``: the snapshot on disk after a
    run, and the count of snapshots written, equal the reference's; saved
    and loaded, the port's snapshot is a ``Checkpoint`` again."""
    inst, jp, tp, fns, init = ckpt_case(case)
    jres = jp.lower("inprocess", checkpoint_every=2, checkpoint_path=str(tmp_path / "j.ckpt")).compile(
        fns).run(initial_payloads=dict(init))
    tres = tp.lower("inprocess", checkpoint_every=2, checkpoint_path=str(tmp_path / "t.ckpt")).compile(
        fns).run(initial_payloads=dict(init))
    assert_same_run(jres, tres)
    assert tres.stats.checkpoints == tres.stats.execs // 2 > 0
    from repro.workflow.runtime import Checkpoint as JCheckpoint

    jck, tck = JCheckpoint.load(tmp_path / "j.ckpt"), Checkpoint.load(tmp_path / "t.ckpt")
    assert (tck.system_text, tck.payloads, tck.completed_execs) == (
        jck.system_text, jck.payloads, jck.completed_execs)
    (tmp_path / "x.ckpt").write_bytes(b"\x80\x04K\x01.")  # a pickled 1
    with pytest.raises(TypeError, match="not a workflow checkpoint"):
        Checkpoint.load(tmp_path / "x.ckpt")


def test_pristine_and_finished_snapshots_restore_as_in_the_reference():
    tp = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    fns = identity_step_fns(tp.instance)
    exe = tp.lower("inprocess").compile(fns)
    pristine = exe.checkpoint()
    assert pristine.system_text == t_dumps(tp.system) and not pristine.completed_execs
    done = exe.run()
    finished = exe.checkpoint()
    assert finished.completed_execs == frozenset(fns)
    for ck in (pristine, finished):
        assert tp.lower("inprocess").compile(fns).restore(ck).run().data == done.data


def test_backend_advertises_the_references_capabilities_and_options():
    from repro.backends import get_backend as jget_backend

    tb, jb = get_backend("inprocess"), jget_backend("inprocess")
    assert tb.capabilities == jb.capabilities == frozenset({"checkpoint", "retry", "speculation"})
    assert tb.known_options() == jb.known_options()
    tp = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    with pytest.raises(TypeError, match="unknown options for backend 'inprocess'"):
        tp.lower("inprocess", platform="cpu")
