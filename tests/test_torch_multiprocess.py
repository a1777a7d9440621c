"""The port's ``multiprocess`` backend against the reference's.

``repro_torch.backends.multiprocess`` is a copy of
``repro.backends.multiprocess``: one OS process per location group over a
socket (or shared-memory) transport, typed worker failures, checkpoints
merged at the coordinator, and spare and fold recovery.  Here:

* ``assign_workers`` equals the reference's on the quickstart plan,
  ``genomes_1000(2, 1, 1, 1, 1)`` and 20 ``random_layered_instance`` DAGs,
  with and without ``workers=`` and a schedule report;
* final stores ``==`` the reference's ``multiprocess`` stores on the same
  plans (string payloads that spell out their inputs), and CPU tensor
  payloads equal the port's ``threaded`` run bit for bit, forked and
  spawned (module-level step bodies, as on the card);
* the reference's ``tests/test_multiprocess.py`` cases, run on the port:
  distinct PIDs, a killed worker, checkpoint and restore, a restore across
  backends, spare and fold recovery, ``run_many`` through kills, and no
  shared-memory segment left behind;
* the worker's control messages are framed with plain pickle, so a tensor
  in a ``done`` message survives its worker's exit.

Every file of the port's tests pins torch to one thread (forked workers
inherit it).
"""

from __future__ import annotations

import glob
import multiprocessing as mp
import os
import pickle
import random
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import identity_step_fns
from test_torch_swirl import to_port

from repro import swirl as jswirl
from repro.backends.multiprocess import assign_workers as j_assign_workers
from repro.core.randgen import random_layered_instance as j_random_layered_instance
from repro.core.translate import genomes_1000 as j_genomes
from repro.sched import NetworkModel as JNetworkModel
from repro_torch import swirl
from repro_torch.backends import WorkerFailedError, available_backends, get_backend
from repro_torch.backends import multiprocess as tmp
from repro_torch.backends.multiprocess import assign_workers
from repro_torch.core.randgen import random_layered_instance
from repro_torch.core.translate import genomes_1000
from repro_torch.kernels import ops as kops
from repro_torch.sched import NetworkModel
from repro_torch.workflow.transport import SharedMemoryTransport, shm_namespace

ROOT = Path(__file__).resolve().parents[1]
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
SMALL_GENOMES = dict(n=2, m=1, a=1, b=1, c=1)
RANDGEN = [(n, seed) for n, seed in zip((8, 12, 16, 20, 25) * 4, range(20))]
TIMEOUT = {"timeout_s": 60}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quickstart_steps():
    return {
        "preprocess": lambda inp: {"d^preprocess": list(range(10))},
        "train_a": lambda inp: {"d^train_a": sum(inp["d^preprocess"])},
        "train_b": lambda inp: {"d^train_b": max(inp["d^preprocess"])},
        "evaluate": lambda inp: {
            "d^evaluate": inp["d^train_a"] + inp["d^train_b"]
        },
        "report": lambda inp: {},
    }


@pytest.fixture
def plan():
    return swirl.trace(EDGES, mapping=MAPPING).optimize()


def _pid_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:  # pragma: no cover - alive but not ours
        return False
    return False


def _assert_no_workers_left(program) -> None:
    assert not mp.active_children(), "worker processes were not reaped"
    assert program.last_pids, "run never recorded its worker pids"
    leaked = [pid for pid in program.last_pids.values() if not _pid_gone(pid)]
    assert not leaked, f"orphan worker processes: {leaked}"


def genomes_init(inst) -> dict:
    return {("l^d", d): f"in:{d}" for d in sorted(inst.g("l^d"))}


# -- assign_workers equal to the reference's ------------------------------------------


def _assignment_cases():
    cases = [("quickstart", jswirl.trace(EDGES, mapping=MAPPING).optimize(),
              swirl.trace(EDGES, mapping=MAPPING).optimize())]
    cases.append(("genomes", jswirl.trace(j_genomes(**SMALL_GENOMES)).optimize(),
                  swirl.trace(genomes_1000(**SMALL_GENOMES)).optimize()))
    for n, seed in RANDGEN:
        cases.append((f"randgen-{n}-{seed}",
                      jswirl.trace(j_random_layered_instance(n, seed=seed)).optimize(("R1R2", "R3")),
                      swirl.trace(random_layered_instance(n, seed=seed)).optimize(("R1R2", "R3"))))
    return cases


@pytest.mark.parametrize("workers", [None, 1, 2, 3])
def test_assign_workers_equals_the_references(workers):
    for name, jp, tp in _assignment_cases():
        want = j_assign_workers(jp.system, workers=workers)
        assert assign_workers(tp.system, workers=workers) == want, name
        # The backend's path reads the lowered program's op arrays.
        assert assign_workers(tp.exec_program(), workers=workers) == \
            j_assign_workers(jp.exec_program(), workers=workers), name


@pytest.mark.parametrize("workers", [None, 2])
def test_assign_workers_with_a_schedule_equals_the_references(workers):
    for name, jp, tp in _assignment_cases():
        locs = sorted(tp.system.locations())
        jnet = JNetworkModel.preset("two-rack").bind(locs)
        tnet = NetworkModel.preset("two-rack").bind(locs)
        js, ts = jp.schedule(jnet), tp.schedule(tnet)
        want = j_assign_workers(js.system, workers=workers, schedule=js.schedule_report)
        assert assign_workers(ts.system, workers=workers, schedule=ts.schedule_report) == want, name


def test_randgen_instances_equal_the_references():
    for n, seed in RANDGEN:
        j, t = j_random_layered_instance(n, seed=seed), random_layered_instance(n, seed=seed)
        assert to_port(j) == t


# -- stores equal to the reference's ------------------------------------------------


def run_both(jplan, tplan, fns, init=None, **opts):
    opts = {**TIMEOUT, **opts}
    jres = jplan.lower("multiprocess", **opts).compile(fns).run(initial_payloads=dict(init or {}))
    texe = tplan.lower("multiprocess", **opts).compile(fns)
    tres = texe.run(initial_payloads=dict(init or {}))
    assert tres.backend == "multiprocess"
    assert {k: v for k, v in tres.stats.items() if k != "pids"} == \
        {k: v for k, v in jres.stats.items() if k != "pids"}
    _assert_no_workers_left(texe.program)
    return jres, tres


@pytest.mark.parametrize("rules", [(), ("R1R2", "R3")], ids=["raw", "optimised"])
def test_quickstart_store_equals_the_references(rules):
    jp, tp = jswirl.trace(EDGES, mapping=MAPPING), swirl.trace(EDGES, mapping=MAPPING)
    if rules:
        jp, tp = jp.optimize(rules), tp.optimize(rules)
    jres, tres = run_both(jp, tp, identity_step_fns(jp.instance))
    assert tres.data == jres.data


@pytest.mark.parametrize("opts", [{}, {"workers": 2}], ids=["socket", "workers2"])
def test_genomes_store_equals_the_references(opts):
    jinst, tinst = j_genomes(**SMALL_GENOMES), genomes_1000(**SMALL_GENOMES)
    jp, tp = jswirl.trace(jinst).optimize(), swirl.trace(tinst).optimize()
    jres, tres = run_both(jp, tp, identity_step_fns(jinst), genomes_init(jinst), **opts)
    assert tres.data == jres.data


@pytest.mark.parametrize("n,seed", RANDGEN[:5])
def test_randgen_stores_equal_the_references(n, seed):
    jinst = j_random_layered_instance(n, seed=seed)
    jp = jswirl.trace(jinst).optimize(("R1R2", "R3"))
    tp = swirl.trace(random_layered_instance(n, seed=seed)).optimize(("R1R2", "R3"))
    jres, tres = run_both(jp, tp, identity_step_fns(jinst))
    assert tres.data == jres.data


def test_recovered_store_equals_the_references():
    jp, tp = jswirl.trace(EDGES, mapping=MAPPING).optimize(), swirl.trace(EDGES, mapping=MAPPING).optimize()
    opts = dict(_kill_at_step="evaluate", recover="spare", spares=["spare0"])
    jres, tres = run_both(jp, tp, identity_step_fns(jp.instance), **opts)
    assert tres.data == jres.data
    assert tres.stats["recoveries"] == jres.stats["recoveries"]


# -- tensors: CPU payloads equal the threaded run ----------------------------------


def _pipeline_plan(n_steps: int = 6):
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow

    steps = [f"s{i}" for i in range(1, n_steps + 1)]
    ports = [f"p{i}" for i in range(n_steps + 1)]
    deps = []
    for i, s in enumerate(steps):
        deps += [(f"p{i}", s), (s, f"p{i + 1}")]
    inst = DistributedWorkflowInstance(
        workflow=make_workflow(steps, ports, deps),
        locations=frozenset({"l0", "l1"}),
        mapping={s: ("l0",) if k % 2 else ("l1",) for k, s in enumerate(steps, start=1)},
        data=frozenset(f"d{i}" for i in range(n_steps + 1)),
        placement={f"d{i}": f"p{i}" for i in range(n_steps + 1)},
        initial_data={"l0": frozenset({"d0"})},
    )
    return swirl.trace(inst).optimize()


def _tensor_steps(n_steps: int = 6):
    w = torch.ones(16)
    return {
        f"s{k + 1}": (
            lambda i, a=f"d{k}", b=f"d{k + 1}", k=k: {
                b: kops.rmsnorm(i[a], w) if k % 3 == 0 else 0.5 * i[a] + 0.1 * torch.tanh(i[a])
            }
        )
        for k in range(n_steps)
    }


def test_cpu_tensor_payloads_equal_the_threaded_run():
    plan = _pipeline_plan()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32))
    feed = {("l0", "d0"): x}
    thr = plan.lower("threaded", **TIMEOUT).compile(_tensor_steps()).run(initial_payloads=dict(feed))
    exe = plan.lower("multiprocess", **TIMEOUT).compile(_tensor_steps())
    res = exe.run(initial_payloads=dict(feed))
    assert {loc: sorted(d) for loc, d in res.data.items()} == {loc: sorted(d) for loc, d in thr.data.items()}
    for loc, ds in thr.data.items():
        for d, v in ds.items():
            got = res.data[loc][d]
            assert isinstance(got, torch.Tensor) and got.dtype == v.dtype and torch.equal(got, v), (loc, d)
    # Every step's outputs reached the coordinator's merged store.
    ckpt = exe.checkpoint()
    assert set(ckpt.completed_execs) == {f"s{k}" for k in range(1, 7)}
    _assert_no_workers_left(exe.program)


def test_a_tensor_in_a_done_message_survives_its_workers_exit():
    """Torch registers tensor reductions with ``ForkingPickler``; the port's
    workers frame their control messages with plain pickle, so the tensor
    the coordinator gets owns its bytes."""
    t = torch.arange(6, dtype=torch.float32)
    conn_a, conn_b = mp.Pipe()
    tmp._send_msg(conn_a, ("done", 0, {"l0": {"d": t}}))
    msg = tmp._recv_msg(conn_b)
    assert msg[0] == "done" and torch.equal(msg[2]["l0"]["d"], t)
    assert not msg[2]["l0"]["d"].is_shared()
    conn_a.close()
    conn_b.close()


def _chip_smoke():
    """``chip_smoke.py`` imported by its own name, so that a spawned worker
    can import it to unpickle its module-level step bodies."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_spawned_workers_run_module_level_steps_on_tensors():
    """Under ``spawn`` every step body must pickle: phase 17's bodies are
    module-level functions of ``chip_smoke.py``; on the CPU they run on CPU
    tensors and report their own process's launches (none here: the CPU
    path launches no kernel)."""
    cs = _chip_smoke()
    plan = _pipeline_plan(cs.DP_STEPS)
    fns = cs.mp_dp_fns(torch.ones(32))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 32)).astype(np.float32))
    feed = {("l0", "d0"): x}
    thr = plan.lower("threaded", **TIMEOUT).compile(fns).run(initial_payloads=dict(feed))
    exe = plan.lower("multiprocess", start_method="spawn", **TIMEOUT).compile(fns)
    res = exe.run(initial_payloads=dict(feed))
    assert res.stats["start_method"] == "spawn"
    assert os.getpid() not in res.stats["pids"].values()
    for loc, ds in thr.data.items():
        assert res.data[loc].keys() == ds.keys()  # the reports stay out of the stores
        for d, v in ds.items():
            assert torch.equal(res.data[loc][d], v), (loc, d)
    reports = cs.worker_reports(exe.checkpoint().payloads)
    assert sorted(reports) == sorted(f"s{k}" for k in range(1, cs.DP_STEPS + 1))
    assert {r["pid"] for r in reports.values()} == set(res.stats["pids"].values())
    assert all(r["launches"] == {} for r in reports.values())
    _assert_no_workers_left(exe.program)


def test_phase_17_rehearsed_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_multiprocess`` on the CPU at small shapes, forked
    (so that the workers inherit the switch forced to the kernel path, under
    which the plain rmsnorm counts as the card's launch), the card's
    synchronise a no-op.  The
    phase's own checks run: stores equal to ``threaded``'s, rmsnorm steps
    against the plain version, exactly 3 launches inside the workers of a
    P-split run, distinct worker PIDs and none left, a killed worker named
    by location and step, and the spare recovery's store."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DP_SHAPES", {"P-ref": (8, 16), "P-full": (32, 64)})
    monkeypatch.setattr(cs, "G_ELEMS", 64)
    monkeypatch.setattr(cs, "DP_REPEATS", 2)
    monkeypatch.setattr(cs, "MP_RUNS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    out = cs.phase_multiprocess(torch, "cpu rehearsal", "H100 SXM", device="cpu", start_method="fork")
    three = {"rmsnorm": cs.DP_NORMS}
    assert out["launches"] == {"P-ref/split": three, "P-full/split": three, "G": {}}
    assert out["P-ref/split"]["workers"] == 2 and out["G"]["workers"] == 9
    assert out["P-full/split"]["wire"]["messages"] == cs.DP_STEPS - 1
    assert out["P-full/split"]["wire"]["bytes"] > (cs.DP_STEPS - 1) * 32 * 64 * 4
    assert out["kill"]["error"].startswith("worker for location 'l1' failed in step 's6'")
    assert out["spare"]["recoveries"][0]["renaming"] == {"l1": "spare0"}
    assert all(s >= 0 for s in out["G"]["fleet_start_ms"] + out["G"]["steps_ms"])
    assert not mp.active_children()


# -- the reference's cases, on the port ---------------------------------------------


class TestProcessIsolation:
    def test_registered_with_checkpoint_capability(self):
        b = get_backend("multiprocess")
        assert "multiprocess" in available_backends()
        assert "checkpoint" in b.capabilities
        assert "serve" not in b.capabilities

    def test_each_location_group_is_a_distinct_os_process(self, plan):
        exe = plan.lower("multiprocess").compile(quickstart_steps())
        result = exe.run()
        pids = result.stats["pids"]
        assert len(pids) == result.stats["workers"] == 3
        assert len(set(pids.values())) == 3, "workers shared a process"
        assert os.getpid() not in pids.values(), "a worker ran in-process"
        _assert_no_workers_left(exe.program)

    def test_identical_to_every_other_backend(self, plan):
        results = {
            b: plan.lower(b, **({"platform": "cpu"} if b == "torch" else {}))
            .compile(quickstart_steps()).run().data
            for b in available_backends()
        }
        reference = results.pop("multiprocess")
        for backend, data in results.items():
            assert data == reference, f"{backend} diverged from multiprocess"

    def test_identical_on_1000_genomes(self):
        inst = genomes_1000(n=2, m=2, a=1, b=1, c=1)
        plan = swirl.trace(inst).optimize()
        fns = {}
        for s in inst.workflow.steps:
            outs = inst.out_data(s)
            fns[s] = lambda i, s=s, outs=outs: {
                o: f"{s}({','.join(sorted(map(str, i)))})" for o in outs
            }
        init = {("l^d", d): f"raw:{d}" for d in inst.g("l^d")}
        extra = {"threaded": TIMEOUT, "multiprocess": TIMEOUT, "torch": {"platform": "cpu"}}
        results = {
            b: plan.lower(b, **extra.get(b, {})).compile(fns).run(initial_payloads=dict(init)).data
            for b in available_backends()
        }
        reference = results.pop("multiprocess")
        for backend, data in results.items():
            assert data == reference, f"{backend} diverged on 1000 Genomes"

    def test_initial_payloads_reach_their_worker(self, plan):
        init = {("cpu0", "seed"): [5, 6, 7]}
        result = plan.lower("multiprocess").compile(quickstart_steps()).run(initial_payloads=dict(init))
        threaded = plan.lower("threaded").compile(quickstart_steps()).run(initial_payloads=dict(init))
        assert result.payload("cpu0", "seed") == [5, 6, 7]
        assert result.data == threaded.data


class TestWorkerAssignment:
    def test_default_one_process_per_location(self, plan):
        assert assign_workers(plan.system) == [("cpu0",), ("gpu0",), ("gpu1",)]

    def test_spatial_constraint_locations_share_a_process(self):
        mapping = dict(MAPPING, evaluate=("gpu0", "gpu1"))
        plan = swirl.trace(EDGES, mapping=mapping).optimize()
        assert ("gpu0", "gpu1") in assign_workers(plan.system)
        result = plan.lower("multiprocess").compile(quickstart_steps()).run()
        assert result.payload("cpu0", "d^evaluate") == 54
        assert result.stats["workers"] == 2

    def test_workers_option_packs_groups(self, plan):
        result = plan.lower("multiprocess", workers=2).compile(quickstart_steps()).run()
        assert result.stats["workers"] == 2
        assert len(set(result.stats["pids"].values())) == 2
        assert result.payload("cpu0", "d^evaluate") == 54

    def test_workers_must_be_positive(self, plan):
        exe = plan.lower("multiprocess", workers=0).compile(quickstart_steps())
        with pytest.raises(ValueError, match="workers"):
            exe.run()

    def test_schedule_pins_network_groups_to_processes(self):
        inst = genomes_1000(n=2, m=2, a=1, b=1, c=1)
        net = NetworkModel.preset("two-rack").bind(sorted(inst.locations))
        plan = swirl.trace(inst).optimize().schedule(net)
        groups = assign_workers(plan.system, schedule=plan.schedule_report)
        racks = {}
        for loc in plan.system.locations():
            racks.setdefault(net.group_of(loc), set()).add(loc)
        for members in racks.values():
            owners = {g for g in groups if members & set(g)}
            assert len(owners) == 1, f"rack {members} split across {owners}"

    def test_memory_transport_rejected(self, plan):
        exe = plan.lower("multiprocess", transport="memory").compile(quickstart_steps())
        with pytest.raises(ValueError, match="cannot cross process"):
            exe.run()

    def test_unknown_option_rejected_at_lower_time(self, plan):
        with pytest.raises(TypeError, match="unknown options"):
            plan.lower("multiprocess", warp_speed=True)


class TestWorkerFailure:
    def test_killed_worker_names_location_and_step(self, plan):
        exe = plan.lower("multiprocess", _kill_at_step="evaluate", **TIMEOUT).compile(quickstart_steps())
        with pytest.raises(WorkerFailedError) as e:
            exe.run()
        assert e.value.location == "gpu0"
        assert e.value.step == "evaluate"
        assert e.value.exitcode == -signal.SIGKILL
        _assert_no_workers_left(exe.program)

    def test_step_exception_surfaces_as_worker_failed(self, plan):
        steps = quickstart_steps()
        steps["train_b"] = lambda inp: (_ for _ in ()).throw(ValueError("boom"))
        exe = plan.lower("multiprocess", **TIMEOUT).compile(steps)
        with pytest.raises(WorkerFailedError) as e:
            exe.run()
        assert e.value.location == "gpu1"
        assert e.value.step == "train_b"
        assert "boom" in e.value.reason
        _assert_no_workers_left(exe.program)

    def test_checkpoint_restore_resumes_to_same_result(self, plan, tmp_path):
        log = tmp_path / "execs.log"
        clean = plan.lower("multiprocess").compile(quickstart_steps()).run()
        exe = plan.lower("multiprocess", _kill_at_step="evaluate", **TIMEOUT).compile(_logged_steps(log))
        with pytest.raises(WorkerFailedError):
            exe.run()
        ckpt = exe.checkpoint()
        assert {"preprocess", "train_a", "train_b"} <= set(ckpt.completed_execs)
        assert "evaluate" not in ckpt.completed_execs
        log.write_text("")
        restored = plan.lower("multiprocess", **TIMEOUT).compile(_logged_steps(log)).restore(ckpt).run()
        assert restored.data == clean.data
        rerun = set(log.read_text().split())
        assert "preprocess" not in rerun, "completed step was re-executed"
        assert "train_a" not in rerun and "train_b" not in rerun
        assert "evaluate" in rerun
        _assert_no_workers_left(exe.program)

    def test_checkpoint_after_success_skips_everything(self, plan, tmp_path):
        log = tmp_path / "execs.log"
        steps = _logged_steps(log)
        exe = plan.lower("multiprocess").compile(steps)
        first = exe.run()
        ckpt = exe.checkpoint()
        assert set(ckpt.completed_execs) == set(EDGES)
        log.write_text("")
        restored = plan.lower("multiprocess").compile(steps).restore(ckpt).run()
        assert restored.data == first.data
        assert log.read_text() == "", "restore re-executed completed steps"

    def test_cross_backend_checkpoint_restore(self, plan):
        """An inprocess snapshot resumes on multiprocess (same final data)."""
        inproc = plan.lower("inprocess").compile(quickstart_steps())
        done = inproc.run()
        ckpt = inproc.checkpoint()
        restored = plan.lower("multiprocess").compile(quickstart_steps()).restore(ckpt).run()
        assert restored.data == done.data

    def test_a_reference_checkpoint_restores_on_the_port(self, plan):
        """A snapshot of the reference's multiprocess run, carried across by
        ``dumps`` and its payloads, resumes the port's run to the same data."""
        from repro_torch.workflow import Checkpoint

        jplan = jswirl.trace(EDGES, mapping=MAPPING).optimize()
        jexe = jplan.lower("multiprocess", _kill_at_step="evaluate", **TIMEOUT).compile(quickstart_steps())
        with pytest.raises(Exception):
            jexe.run()
        jck = jexe.checkpoint()
        ckpt = Checkpoint(system_text=jck.system_text, payloads=dict(jck.payloads),
                          completed_execs=frozenset(jck.completed_execs))
        clean = plan.lower("multiprocess").compile(quickstart_steps()).run()
        restored = plan.lower("multiprocess", **TIMEOUT).compile(quickstart_steps()).restore(ckpt).run()
        assert restored.data == clean.data


def _logged_steps(log):
    """Step bodies that append their name to ``log`` on every execution."""
    steps = {}
    for name, fn in quickstart_steps().items():

        def wrapper(inp, _name=name, _fn=fn):
            with open(log, "a") as f:
                f.write(f"{_name}\n")
            return _fn(inp)

        steps[name] = wrapper
    return steps


class TestElasticRecovery:
    def test_spare_recovery_survives_sigkill(self, plan, tmp_path):
        log = tmp_path / "execs.log"
        clean = plan.lower("multiprocess", **TIMEOUT).compile(quickstart_steps()).run()
        exe = plan.lower("multiprocess", _kill_at_step="evaluate", recover="spare", spares=["spare0"],
                         trace=True, **TIMEOUT).compile(_logged_steps(log))
        result = exe.run()
        recs = result.stats["recoveries"]
        assert len(recs) == 1
        rec = recs[0]
        assert rec["mode"] == "spare"
        assert rec["failed_step"] == "evaluate"
        assert rec["dead"] == ["gpu0"]
        assert rec["renaming"] == {"gpu0": "spare0"}
        assert result.data == {("spare0" if l == "gpu0" else l): d for l, d in clean.data.items()}
        assert sorted(log.read_text().split()) == sorted(quickstart_steps())
        spans = [s for s in result.profile.spans if s.name == "recover:spare"]
        assert len(spans) == 1
        assert spans[0].kind == "phase"
        assert (spans[0].src, spans[0].dst) == ("gpu0", "spare0")
        _assert_no_workers_left(exe.program)

    def test_fold_recovery_merges_onto_survivor(self, plan, tmp_path):
        log = tmp_path / "execs.log"
        clean = plan.lower("multiprocess", **TIMEOUT).compile(quickstart_steps()).run()
        exe = plan.lower("multiprocess", _kill_at_step="evaluate", recover="fold",
                         **TIMEOUT).compile(_logged_steps(log))
        result = exe.run()
        recs = result.stats["recoveries"]
        assert len(recs) == 1
        ren = recs[0]["renaming"]
        assert recs[0]["mode"] == "fold"
        assert set(ren) == {"gpu0"}
        assert ren["gpu0"] in {"cpu0", "gpu1"}
        expected: dict = {}
        for l, d in clean.data.items():
            expected.setdefault(ren.get(l, l), {}).update(d)
        assert result.data == expected
        assert sorted(log.read_text().split()) == sorted(quickstart_steps())
        _assert_no_workers_left(exe.program)

    def test_error_failures_are_never_recovered(self, plan):
        steps = quickstart_steps()
        steps["train_b"] = lambda inp: (_ for _ in ()).throw(ValueError("boom"))
        exe = plan.lower("multiprocess", recover="spare", spares=["spare0"], **TIMEOUT).compile(steps)
        with pytest.raises(WorkerFailedError) as e:
            exe.run()
        assert "boom" in e.value.reason
        _assert_no_workers_left(exe.program)

    def test_recovery_exhausted_spares_raises(self, plan):
        exe = plan.lower("multiprocess", _kill_at_step="evaluate", recover="spare", spares=[],
                         max_recoveries=0, **TIMEOUT).compile(quickstart_steps())
        with pytest.raises(WorkerFailedError) as e:
            exe.run()
        assert e.value.exitcode == -signal.SIGKILL
        _assert_no_workers_left(exe.program)

    def test_bad_recover_mode_rejected(self, plan):
        exe = plan.lower("multiprocess", recover="wishful").compile(quickstart_steps())
        with pytest.raises(ValueError, match="recover must be"):
            exe.run()

    def test_run_many_batch_keeps_draining_through_kills(self, plan):
        clean = plan.lower("multiprocess", **TIMEOUT).compile(quickstart_steps()).run()
        exe = plan.lower("multiprocess", timeout_s=120, _kill_at_step="evaluate",
                         recover="fold").compile(quickstart_steps())
        results = exe.run_many([None] * 3)
        assert len(results) == 3
        for r in results:
            assert len(r.stats["recoveries"]) == 1
            ren = r.stats["recoveries"][0]["renaming"]
            expected: dict = {}
            for l, d in clean.data.items():
                expected.setdefault(ren.get(l, l), {}).update(d)
            assert r.data == expected
        _assert_no_workers_left(exe.program)


class TestZeroCopyElasticRecovery:
    """SIGKILL a worker that owns live ``/dev/shm`` arenas, then recover.

    ``preprocess`` on cpu0 broadcasts a 512KB array out of cpu0's arenas;
    killing at ``report`` (also on cpu0) takes down a worker whose segments
    are still on disk.  The recovery must give the clean run's arrays
    (modulo the renaming), and the coordinator's sweep must leave nothing of
    any attempt's namespace.  Only this run's namespaces are listed, never
    the global ``swirl-*``, which other test files' fleets share.
    """

    @staticmethod
    def _array_steps():
        return {
            "preprocess": lambda inp: {"d^preprocess": np.arange(65536, dtype=np.float64)},
            "train_a": lambda inp: {"d^train_a": inp["d^preprocess"] * 2.0},
            "train_b": lambda inp: {"d^train_b": inp["d^preprocess"] + 1.0},
            "evaluate": lambda inp: {"d^evaluate": inp["d^train_a"] + inp["d^train_b"]},
            "report": lambda inp: {},
        }

    @pytest.mark.parametrize("mode,opts", [("spare", {"recover": "spare", "spares": ["spare0"]}),
                                           ("fold", {"recover": "fold"})])
    def test_recovery_with_live_segments_leaves_no_shm(self, plan, mode, opts, monkeypatch):
        keys = []
        sweep = SharedMemoryTransport.sweep.__func__

        def recording_sweep(cls, authkey):
            keys.append(authkey)
            return sweep(cls, authkey)

        monkeypatch.setattr(SharedMemoryTransport, "sweep", classmethod(recording_sweep))
        clean = plan.lower("multiprocess", timeout_s=60, zero_copy=True).compile(self._array_steps()).run()
        exe = plan.lower("multiprocess", timeout_s=120, zero_copy=True, _kill_at_step="report",
                         **opts).compile(self._array_steps())
        result = exe.run()
        recs = result.stats["recoveries"]
        assert len(recs) == 1 and recs[0]["mode"] == mode
        ren = recs[0]["renaming"]
        assert set(ren) == {"cpu0"}
        expected: dict = {}
        for l, d in clean.data.items():
            expected.setdefault(ren.get(l, l), {}).update(d)
        assert expected.keys() == result.data.keys()
        for loc, payloads in expected.items():
            assert result.data[loc].keys() == payloads.keys()
            for d, v in payloads.items():
                assert np.array_equal(np.asarray(result.data[loc][d]), np.asarray(v))
        _assert_no_workers_left(exe.program)
        assert len(keys) == 3  # the clean run's attempt, the killed one, the recovery
        for key in keys:
            assert glob.glob(f"/dev/shm/{shm_namespace(key)}*") == []


def test_random_instances_give_the_same_store_on_every_backend():
    """As ``tests/test_differential.py`` holds the reference's: the port's
    four backends agree on seeded layered DAGs (torch on the CPU)."""
    rng = random.Random(24)
    for _ in range(3):
        inst = random_layered_instance(rng.randrange(6, 14), seed=rng.randrange(1000))
        plan = swirl.trace(inst).optimize(("R1R2", "R3"))
        fns = identity_step_fns(inst)
        extra = {"threaded": TIMEOUT, "multiprocess": TIMEOUT, "torch": {"platform": "cpu"}}
        stores = {b: plan.lower(b, **extra.get(b, {})).compile(fns).run().data for b in available_backends()}
        want = stores.pop("multiprocess")
        for b, data in stores.items():
            assert data == want, b


def test_payloads_for_a_pickled_worker_go_as_plain_pickle():
    """A spawned worker's configuration is pickled by multiprocessing's
    ``ForkingPickler``, where torch registered its tensor reductions; the
    payloads in it go as plain pickle, so the worker's tensors own their
    bytes (on the card: through the host, never CUDA IPC)."""
    from multiprocessing.reduction import ForkingPickler

    t = torch.arange(8, dtype=torch.float32)
    shared = pickle.loads(ForkingPickler.dumps({"x": t}))["x"]
    assert shared.is_shared()  # torch's reduction moved it to shared memory
    frame = pickle.loads(ForkingPickler.dumps(tmp._HostFramed({("l0", "x"): torch.arange(8.0)})))
    assert isinstance(frame, tmp._HostFramed)  # loaded by the worker
    framed = frame.load()
    assert isinstance(framed, dict) and torch.equal(framed[("l0", "x")], t)
    assert not framed[("l0", "x")].is_shared()
