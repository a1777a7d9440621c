"""The port's elasticity against the reference's: renaming, recovery, rebalance.

``repro_torch.workflow.elastic`` and ``repro_torch.exec.elastic`` are copies
of the reference's.  First the reference's ``tests/test_elastic.py`` cases
run on the port unchanged: the tree layer (rename the checkpointed term,
re-encode, resume) as the semantics oracle, and the exec-IR layer (the same
substitution on the lowered op arrays, which the ``multiprocess`` backend's
recovery uses) held against it.  Then every function is held against the
reference's on the same inputs: ``rename_program``, ``resimulate``,
``rename_locations``, ``fold_payloads``, ``recover_checkpoint``,
``plan_recovery`` and ``rebalance`` (systems compared by ``dumps``), and
``random_layered_instance`` for 20 seeds.
"""

import random

import pytest
import torch

from repro_torch import swirl
from repro_torch.backends import get_backend
from repro_torch.core import encode, optimize, run
from repro_torch.core.compile import StepMeta
from repro_torch.core.parser import dumps
from repro_torch.core.randgen import random_layered_instance
from repro_torch.core.translate import genomes_1000
from repro_torch.exec import lower_system, rename_program, resimulate
from repro_torch.workflow import (
    Checkpoint,
    Runtime,
    fold_payloads,
    plan_recovery,
    rebalance,
    recover_checkpoint,
    rename_locations,
)

from conftest import identity_step_fns
from test_torch_swirl import to_port

from repro import swirl as jswirl
from repro.core import encode as j_encode
from repro.core.parser import dumps as j_dumps
from repro.core.randgen import random_layered_instance as j_random_layered_instance
from repro.core.translate import genomes_1000 as j_genomes
from repro.exec import lower_system as j_lower_system
from repro.exec import rename_program as j_rename_program
from repro.exec import resimulate as j_resimulate
from repro.workflow import Checkpoint as JCheckpoint
from repro.workflow import fold_payloads as j_fold_payloads
from repro.workflow import plan_recovery as j_plan_recovery
from repro.workflow import rebalance as j_rebalance
from repro.workflow import recover_checkpoint as j_recover_checkpoint
from repro.workflow import rename_locations as j_rename_locations


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n=3, m=2):
    inst = genomes_1000(n=n, m=m, a=2, b=2, c=2)
    w, _ = optimize(encode(inst))
    fns = identity_step_fns(inst)
    init = {("l^d", d): f"raw:{d}" for d in inst.g("l^d")}
    return inst, w, fns, init


def test_rename_is_semantics_invariant():
    inst, w, fns, init = _setup()
    ren = {"l^MO_1": "spare1", "l^F_2": "spare2"}
    w2 = rename_locations(w, ren)
    init2 = {(ren.get(l, l), d): v for (l, d), v in init.items()}
    r1 = run(w, rng=random.Random(3))
    r2 = run(w2, rng=random.Random(3))
    assert not r1.deadlocked and not r2.deadlocked
    assert len(r1.exec_events) == len(r2.exec_events)
    rt = Runtime(w2, fns, initial_payloads=init2)
    rt.run()
    assert "d^IM" in rt.location_data("spare1")


def test_scale_down_merges_locations():
    inst, w, fns, init = _setup()
    # fold both MO locations onto one
    w2 = rename_locations(w, {"l^MO_2": "l^MO_1"})
    assert "l^MO_2" not in w2.locations()
    rt = Runtime(w2, fns, initial_payloads=init)
    stats = rt.run()
    assert stats.execs == len(inst.workflow.steps)


def test_recovery_from_checkpoint(tmp_path):
    inst, w, fns, init = _setup(n=4, m=3)
    path = tmp_path / "wf.ckpt"
    rt = Runtime(w, fns, initial_payloads=init, checkpoint_every=3,
                 checkpoint_path=path)
    rt.run()
    ckpt = Checkpoint.load(path)

    # l^MO_1 "dies"; plan a substitution and resume
    ren = plan_recovery(
        live=[l for l in w.locations() if l != "l^MO_1"],
        dead=["l^MO_1"],
        spares=["l^spare"],
    )
    assert ren == {"l^MO_1": "l^spare"}
    ckpt2 = recover_checkpoint(ckpt, ren)
    rt2 = Runtime.restore(ckpt2, fns)
    rt2.run()
    assert "d^IM" in rt2.location_data("l^spare")


def test_plan_recovery_folds_without_spares():
    ren = plan_recovery(live=["a", "b"], dead=["x", "y", "z"], spares=["s1"])
    assert ren["x"] == "s1"
    assert set(ren.values()) <= {"s1", "a", "b"}


def test_plan_recovery_round_robin_starts_at_first_live():
    # Regression: the fold round-robin used to be indexed by the *overall*
    # dead position, so deads that consumed spares skewed every later fold
    # assignment.  It must index from the first *folded* entry.
    ren = plan_recovery(live=["a", "b"], dead=["x", "y"], spares=["s1"])
    assert ren == {"x": "s1", "y": "a"}


def test_plan_recovery_fold_balances_after_spare_exhaustion():
    ren = plan_recovery(
        live=["a", "b"], dead=["v", "w", "x", "y", "z"], spares=["s1"]
    )
    assert ren == {"v": "s1", "w": "a", "x": "b", "y": "a", "z": "b"}


def test_plan_recovery_without_any_target_raises():
    with pytest.raises(RuntimeError):
        plan_recovery(live=[], dead=["x"], spares=[])


def test_fold_payloads_survivor_beats_dead_and_dead_ties_break_low():
    # Regression: the fold used to keep whichever payload dict iteration
    # visited last.  The precedence is fixed: a survivor's copy of a datum
    # always wins over one inherited from a renamed (dead) location, and
    # between dead sources the lexicographically smallest wins.
    ren = {"dead_a": "live", "dead_b": "live"}
    folded = fold_payloads(
        {
            ("dead_b", "d"): "from_b",
            ("live", "d"): "mine",
            ("dead_a", "d"): "from_a",
            ("dead_b", "e"): "only_b",
        },
        ren,
    )
    assert folded == {("live", "d"): "mine", ("live", "e"): "only_b"}
    no_survivor = fold_payloads(
        {("dead_b", "d"): "from_b", ("dead_a", "d"): "from_a"}, ren
    )
    assert no_survivor == {("live", "d"): "from_a"}


def test_recover_checkpoint_folds_payloads_deterministically():
    inst, w, fns, init = _setup()
    ckpt = Checkpoint(
        system_text=dumps(w),
        payloads={
            ("l^MO_1", "d^x"): "from_mo1",
            ("l^MO_2", "d^x"): "from_mo2",
            ("l^F_1", "d^x"): "survivor",
        },
        completed_execs=frozenset({"sIM"}),
    )
    ckpt2 = recover_checkpoint(
        ckpt, {"l^MO_1": "l^F_1", "l^MO_2": "l^F_1"}
    )
    assert ckpt2.payloads == {("l^F_1", "d^x"): "survivor"}
    assert ckpt2.completed_execs == frozenset({"sIM"})
    assert "l^MO_1" not in ckpt2.system.locations()


def test_recover_checkpoint_round_trips_through_disk(tmp_path):
    inst, w, fns, init = _setup()
    path = tmp_path / "wf.ckpt"
    rt = Runtime(w, fns, initial_payloads=init, checkpoint_every=3,
                 checkpoint_path=path)
    rt.run()
    ckpt2 = recover_checkpoint(Checkpoint.load(path), {"l^MO_1": "l^spare"})
    out = tmp_path / "recovered.ckpt"
    ckpt2.save(out)
    loaded = Checkpoint.load(out)
    assert loaded.payloads == ckpt2.payloads
    assert loaded.completed_execs == ckpt2.completed_execs
    assert loaded.system == ckpt2.system
    assert "l^spare" in loaded.system.locations()


# ---------------------------------------------------------------------------
# Exec-IR renaming (repro.exec.elastic) vs the tree oracle
# ---------------------------------------------------------------------------


def _random_plan(seed, n_steps=12, p_spatial=0.0):
    inst = random_layered_instance(
        n_steps, n_locations=4, seed=seed, p_spatial=p_spatial
    )
    return inst, swirl.trace(inst).optimize()


def test_rename_program_bijective_matches_tree_oracle():
    for seed in range(10):
        inst, plan = _random_plan(seed)
        w = plan.system
        locs = sorted(w.locations())
        ren = {l: f"spare{i}" for i, l in enumerate(locs[:2])}
        arrays = rename_program(lower_system(w), ren).system
        tree = rename_locations(w, ren)
        assert arrays == tree, f"seed {seed} diverged from the oracle"


def test_rename_program_surjective_matches_tree_oracle():
    for seed in range(10):
        inst, plan = _random_plan(seed)
        w = plan.system
        locs = sorted(w.locations())
        if len(locs) < 2:
            continue
        # Fold the two smallest locations onto the largest (scale-down).
        ren = {l: locs[-1] for l in locs[:2]}
        arrays = rename_program(lower_system(w), ren).system
        tree = rename_locations(w, ren)
        assert arrays == tree, f"seed {seed} diverged from the oracle"


def _run_renamed(plan, fns, ren):
    """Execute the renamed op arrays directly through a backend."""
    renamed = rename_program(lower_system(plan.system), ren)
    metas = {s: StepMeta(fn=fn) for s, fn in fns.items()}
    exe = get_backend("threaded").compile(renamed, metas, {"timeout_s": 60})
    return exe.run().data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_renamed_program_executes_equivalently_bijective(seed):
    inst, plan = _random_plan(seed, n_steps=10)
    fns = identity_step_fns(inst)
    clean = plan.lower("threaded", timeout_s=60).compile(fns).run().data
    locs = sorted(plan.system.locations())
    ren = {locs[0]: "spare0"}
    data = _run_renamed(plan, fns, ren)
    assert data == {ren.get(l, l): d for l, d in clean.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folded_program_executes_equivalently(seed):
    inst, plan = _random_plan(seed, n_steps=10)
    fns = identity_step_fns(inst)
    clean = plan.lower("threaded", timeout_s=60).compile(fns).run().data
    locs = sorted(plan.system.locations())
    if len(locs) < 2:
        pytest.skip("optimised plan collapsed to one location")
    ren = {locs[0]: locs[-1]}
    data = _run_renamed(plan, fns, ren)
    expected: dict = {}
    for l, d in clean.items():
        expected.setdefault(ren.get(l, l), {}).update(d)
    assert data == expected


def test_folded_spatial_step_executes_once_per_location_set():
    # A fold that collapses both members of a spatial M(s) onto one name
    # deliberately diverges from the tree oracle: the synchronised copies
    # become redundant and all but the first are dropped.  The executed
    # *data* must still match the clean run.
    for seed in range(6):
        inst, plan = _random_plan(seed, n_steps=10, p_spatial=0.5)
        fns = identity_step_fns(inst)
        clean = plan.lower("threaded", timeout_s=60).compile(fns).run().data
        locs = sorted(plan.system.locations())
        if len(locs) < 2:
            continue
        ren = {locs[0]: locs[1]}
        data = _run_renamed(plan, fns, ren)
        expected: dict = {}
        for l, d in clean.items():
            expected.setdefault(ren.get(l, l), {}).update(d)
        assert data == expected, f"seed {seed} diverged after spatial fold"


def test_rebalance_reencodes():
    inst, w, fns, init = _setup()
    # move every MO/F step onto a single fat node
    new_mapping = {
        s: (("fat",) if s.startswith(("sMO", "sF")) else inst.locs_of(s))
        for s in inst.workflow.steps
    }
    w2 = rebalance(inst, new_mapping)
    assert "fat" in w2.locations()
    rt = Runtime(w2, fns, initial_payloads=init)
    stats = rt.run()
    assert stats.execs == len(inst.workflow.steps)
    assert "d^IM" in rt.location_data("fat")


# ---------------------------------------------------------------------------
# Each function against the reference's, on the same inputs
# ---------------------------------------------------------------------------


def _plans(seed, n_steps=12, p_spatial=0.0, rules=("R1R2",)):
    jinst = j_random_layered_instance(n_steps, n_locations=4, seed=seed, p_spatial=p_spatial)
    tinst = random_layered_instance(n_steps, n_locations=4, seed=seed, p_spatial=p_spatial)
    return jinst, jswirl.trace(jinst).optimize(rules), swirl.trace(tinst).optimize(rules)


def _renamings(locs):
    yield {l: f"spare{i}" for i, l in enumerate(locs[:2])}  # onto spares
    if len(locs) > 1:
        yield {l: locs[-1] for l in locs[:2]}  # a fold (scale-down)
        yield {locs[0]: locs[1]}


def _programs_equal(t, j):
    assert len(t.programs) == len(j.programs)
    for tp, jp in zip(t.programs, j.programs):
        assert tp.location == jp.location and tp.data == jp.data
        assert repr(tp.structure) == repr(jp.structure)
        assert repr(tp.ops) == repr(jp.ops)
    assert dumps(t.system) == j_dumps(j.system)


@pytest.mark.parametrize("p_spatial", [0.0, 0.5])
def test_rename_program_equals_the_references(p_spatial):
    for seed in range(10):
        _, jp, tp = _plans(seed, p_spatial=p_spatial, rules=("R1R2", "R3"))
        jprog, tprog = j_lower_system(jp.system), lower_system(tp.system)
        for ren in _renamings(sorted(tp.system.locations())):
            _programs_equal(rename_program(tprog, ren), j_rename_program(jprog, ren))


def test_resimulate_equals_the_references():
    for seed in range(6):
        _, jp, tp = _plans(seed, rules=("R1R2", "R3"))
        locs = sorted(tp.system.locations())
        ren = next(_renamings(locs))
        t = resimulate(rename_program(lower_system(tp.system), ren))
        j = j_resimulate(j_rename_program(j_lower_system(jp.system), ren))
        assert t.makespan == j.makespan
        assert t.critical_path == j.critical_path
        assert t.cross_bytes == j.cross_bytes and t.comm_seconds == j.comm_seconds
        assert {l: [repr(e) for e in es] for l, es in t.timelines.items()} == \
            {l: [repr(e) for e in es] for l, es in j.timelines.items()}


def test_rename_locations_equals_the_references():
    for seed in range(10):
        _, jp, tp = _plans(seed)
        for ren in _renamings(sorted(tp.system.locations())):
            assert dumps(rename_locations(tp.system, ren)) == j_dumps(j_rename_locations(jp.system, ren))
    jw, tw = j_encode(j_genomes(n=3, m=2, a=2, b=2, c=2)), encode(genomes_1000(n=3, m=2, a=2, b=2, c=2))
    ren = {"l^MO_1": "spare1", "l^F_2": "spare2", "l^MO_2": "l^MO_1"}
    assert dumps(rename_locations(tw, ren)) == j_dumps(j_rename_locations(jw, ren))


def test_fold_payloads_and_recover_checkpoint_equal_the_references():
    rng = random.Random(24)
    locs = ["a", "b", "c", "dead_a", "dead_b"]
    for _ in range(20):
        payloads = {(rng.choice(locs), f"d{rng.randrange(6)}"): rng.random() for _ in range(12)}
        ren = {"dead_a": rng.choice(["a", "b", "spare"]), "dead_b": rng.choice(["a", "c"])}
        assert fold_payloads(payloads, ren) == j_fold_payloads(payloads, ren)
    jw, tw = j_encode(j_genomes(n=3, m=2, a=2, b=2, c=2)), encode(genomes_1000(n=3, m=2, a=2, b=2, c=2))
    payloads = {("l^MO_1", "d^x"): "from_mo1", ("l^MO_2", "d^x"): "from_mo2", ("l^F_1", "d^x"): "survivor",
                ("l^MO_2", "d^y"): "only_mo2"}
    done = frozenset({"sIM", "s0"})
    ren = {"l^MO_1": "l^F_1", "l^MO_2": "l^spare"}
    t = recover_checkpoint(Checkpoint(system_text=dumps(tw), payloads=dict(payloads), completed_execs=done), ren)
    j = j_recover_checkpoint(JCheckpoint(system_text=j_dumps(jw), payloads=dict(payloads), completed_execs=done), ren)
    assert t.system_text == j.system_text
    assert t.payloads == j.payloads and t.completed_execs == j.completed_execs


def test_plan_recovery_equals_the_references():
    rng = random.Random(7)
    for _ in range(50):
        names = [f"l{i}" for i in range(rng.randrange(1, 9))]
        rng.shuffle(names)
        k = rng.randrange(0, len(names) + 1)
        live, dead = names[:k], names[k:]
        spares = [f"s{i}" for i in range(rng.randrange(0, 3))]
        try:
            want = j_plan_recovery(live=live, dead=dead, spares=spares)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                plan_recovery(live=live, dead=dead, spares=spares)
            continue
        assert plan_recovery(live=live, dead=dead, spares=spares) == want


def test_rebalance_equals_the_references():
    jinst, tinst = j_genomes(n=3, m=2, a=2, b=2, c=2), genomes_1000(n=3, m=2, a=2, b=2, c=2)
    mappings = [
        {s: (("fat",) if s.startswith(("sMO", "sF")) else jinst.locs_of(s)) for s in jinst.workflow.steps},
        {s: ("one",) for s in jinst.workflow.steps},
        {s: (jinst.locs_of(s) if s != "sIM" else ("l^IM", "l^SF")) for s in jinst.workflow.steps},
    ]
    for mapping in mappings:
        assert dumps(rebalance(tinst, mapping)) == j_dumps(j_rebalance(jinst, mapping))


@pytest.mark.parametrize("seed", range(20))
def test_random_layered_instance_equals_the_references(seed):
    rng = random.Random(seed)
    kw = dict(n_locations=rng.randrange(2, 7), max_width=rng.randrange(1, 6),
              max_fan_in=rng.randrange(1, 4), p_spatial=rng.choice([0.0, 0.1, 0.5]),
              p_sink_port=rng.choice([0.0, 0.5, 1.0]))
    n = rng.randrange(1, 80)
    j = j_random_layered_instance(n, seed=seed, **kw)
    t = random_layered_instance(n, seed=seed, **kw)
    assert to_port(j) == t
    assert dumps(encode(t)) == j_dumps(j_encode(j))
