"""The port's ``threaded`` backend against the reference's.

The same plans — the quickstart plan, ``genomes_1000(2, 1, 1, 1, 1)``, the
reference's serving workload (``benchmarks/run.py``, ``_serve_workload``) and
100 seeded layered DAGs of ``test_differential.random_instance`` — run on
both packages' ``threaded`` backends with the same pure step bodies
(``conftest.identity_step_fns``: string payloads that spell out their
inputs).  Final stores must be equal (``==``), not close; so must the
transport's counts under seeded drops and delays, and the retries and
replays of a ``FaultPolicy``.  ``run_many`` must equal single runs, and two
batches at once must not collide.  Traced span schemas equal the
reference's.  Within the port, ``inprocess``, ``threaded`` and ``torch``
(on the CPU) agree with the legacy oracles, the tree-walking
``ThreadedRuntime`` over ``build_bundles`` and the reduction ``Runtime``,
rewritten and unrewritten, as ``tests/test_differential.py`` holds the
reference's.  Emitted sources equal the reference's but for the module their
header names, and run to the same stores; the legacy entry points warn as
the reference's do.  The backend moves no payload: a tensor a step returns
is the very object in every store that holds it.  Last, ``chip_smoke.py``'s
phase 16 is rehearsed on the CPU with the plain rmsnorm.
"""

from __future__ import annotations

import importlib.util
import random
import threading
import warnings
from pathlib import Path

import pytest
import torch
from conftest import identity_step_fns
from test_differential import random_instance
from test_fault_policy import chain_instance, diamond_instance, marker_fn, marker_fns
from test_torch_swirl import to_port

from repro import swirl as jswirl
from repro.backends import get_backend as j_get_backend
from repro.core.translate import genomes_1000 as j_genomes
from repro.exec import emit_program_sources as j_emit_program_sources
from repro.exec import FaultPolicy as JFaultPolicy
from repro.workflow import FlakyFn as JFlakyFn
from repro_torch import swirl as tswirl
from repro_torch._compat import suppress_deprecations
from repro_torch.backends import BackendCapabilityError, get_backend
from repro_torch.backends.base import DEFAULT_MAX_CONCURRENT
from repro_torch.core import build_bundles, compile_bundles, emit_all, emit_python_source
from repro_torch.core.translate import genomes_1000 as t_genomes
from repro_torch.exec import FaultPolicy, RunDeadlineExceeded, emit_location_source, emit_program_sources
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import rmsnorm as kops_rmsnorm
from repro_torch.workflow import ChannelRegistry, FlakyFn, Runtime, SlowFn, ThreadedRuntime
from repro_torch.workflow import threaded as tthreaded

RULES = ("R1R2", "R3")
TIMEOUT = {"timeout_s": 60}
CHUNKS, CHUNK_SIZE = 10, 10  # 100 DAGs of test_differential's generator
EDGES = {"preprocess": ["train_a", "train_b"], "train_a": ["evaluate"], "train_b": ["evaluate"],
         "evaluate": ["report"], "report": []}
MAPPING = {"preprocess": ("cpu0",), "train_a": ("gpu0",), "train_b": ("gpu1",), "evaluate": ("gpu0",),
           "report": ("cpu0",)}
SMALL_GENOMES = dict(n=2, m=1, a=1, b=1, c=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1] / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve_workload(n: int):
    """The reference benchmark's serving workload (``benchmarks/run.py``)."""
    return _load("benchmarks_run_for_threaded_tests", "benchmarks/run.py")._serve_workload(n)


def quickstart_plans(rules):
    jp, tp = jswirl.trace(EDGES, mapping=MAPPING), tswirl.trace(EDGES, mapping=MAPPING)
    return (jp.optimize(rules), tp.optimize(rules)) if rules else (jp, tp)


def instance_plans(jinst, tinst, rules=RULES):
    jp, tp = jswirl.trace(jinst), tswirl.trace(tinst)
    return (jp.optimize(rules), tp.optimize(rules)) if rules else (jp, tp)


def run_both(jplan, tplan, fns, init=None, tfns=None, **opts):
    """One run on each package's threaded backend; both results."""
    opts = {**TIMEOUT, **opts}
    jres = jplan.lower("threaded", **opts).compile(fns).run(initial_payloads=dict(init or {}))
    tres = tplan.lower("threaded", **opts).compile(tfns or fns).run(initial_payloads=dict(init or {}))
    assert tres.backend == "threaded"
    return jres, tres


def genomes_init(inst) -> dict:
    return {("l^d", d): f"in:{d}" for d in sorted(inst.g("l^d"))}


def dags(chunk: int) -> list:
    rng = random.Random(23_000 + chunk)
    return [random_instance(rng) for _ in range(CHUNK_SIZE)]


# -- stores equal to the reference's ----------------------------------------------------


@pytest.mark.parametrize("rules", [(), RULES], ids=["raw", "optimised"])
def test_quickstart_store_equals_the_references(rules):
    jp, tp = quickstart_plans(rules)
    fns = identity_step_fns(jp.instance)
    jres, tres = run_both(jp, tp, fns)
    assert tres.data == jres.data and tres.stats == jres.stats


@pytest.mark.parametrize("rules", [(), RULES], ids=["raw", "optimised"])
def test_small_genomes_store_equals_the_references(rules):
    jinst, tinst = j_genomes(**SMALL_GENOMES), t_genomes(**SMALL_GENOMES)
    jp, tp = instance_plans(jinst, tinst, rules)
    jres, tres = run_both(jp, tp, identity_step_fns(jinst), genomes_init(jinst))
    assert tres.data == jres.data and tres.stats == jres.stats


def test_serve_shape_store_equals_the_references():
    jinst, fns, inputs = _serve_workload(20)
    jp, tp = instance_plans(jinst, to_port(jinst))
    for payloads in inputs:
        jres, tres = run_both(jp, tp, fns, payloads)
        assert tres.data == jres.data


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dags_store_equal_the_references(chunk):
    for inst in dags(chunk):
        jp, tp = instance_plans(inst, to_port(inst))
        jres, tres = run_both(jp, tp, identity_step_fns(inst))
        assert tres.data == jres.data and tres.stats == jres.stats


@pytest.mark.parametrize("drop_prob, delay_s, seed", [(0.3, 0.0, 0), (0.5, 0.0, 7), (0.2, 0.001, 3)])
def test_seeded_drops_and_delays_as_the_references(drop_prob, delay_s, seed):
    """The same per-endpoint streams drop the same messages: equal stores and
    equal counts (channels, sent, dropped) — the counts the reference's tests
    treat as deterministic."""
    cases = [(inst, to_port(inst), None) for inst in dags(90 + seed)[:3]]
    cases.append((j_genomes(**SMALL_GENOMES), t_genomes(**SMALL_GENOMES), "genomes"))
    dropped = 0
    for jinst, tinst, kind in cases:
        jp, tp = instance_plans(jinst, tinst)
        init = genomes_init(jinst) if kind else None
        jres, tres = run_both(jp, tp, identity_step_fns(jinst), init, drop_prob=drop_prob,
                              delay_s=delay_s, seed=seed)
        assert tres.data == jres.data
        assert tres.stats == jres.stats
        dropped += tres.stats["dropped"]
    assert dropped > 0


def test_channel_options_are_validated_as_the_references():
    _, tp = quickstart_plans(RULES)
    fns = identity_step_fns(tp.instance)
    with pytest.raises(TypeError, match="not both"):
        tp.lower("threaded", channels=ChannelRegistry(), seed=7).compile(fns).run()
    with pytest.raises(TypeError, match="Transport instance"):
        tp.lower("threaded", transport="memory").compile(fns).run()
    assert get_backend("threaded").known_options() == j_get_backend("threaded").known_options()
    assert get_backend("threaded").capabilities == j_get_backend("threaded").capabilities
    assert DEFAULT_MAX_CONCURRENT == 8


# -- FaultPolicy -------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 23, 37])
def test_flaky_steps_retry_as_the_references(seed):
    inst = random_instance(random.Random(seed))
    jp, tp = instance_plans(inst, to_port(inst))
    base = identity_step_fns(inst)
    jfns = {s: JFlakyFn(fn, failures=1) for s, fn in base.items()}
    tfns = {s: FlakyFn(fn, failures=1) for s, fn in base.items()}
    jres = jp.lower("threaded", policy=JFaultPolicy(max_retries=3), **TIMEOUT).compile(jfns).run()
    tres = tp.lower("threaded", policy=FaultPolicy(max_retries=3), **TIMEOUT).compile(tfns).run()
    assert tres.data == jres.data
    assert tres.stats["policy"] == jres.stats["policy"] and tres.stats["policy"]["retries"] >= 1
    assert tres.stats["recoveries"] == jres.stats["recoveries"] == []


def test_crash_recovery_replays_the_location_as_the_references():
    inst = chain_instance()
    jp, tp = instance_plans(inst, to_port(inst), ())
    jfns, tfns = marker_fns(inst), marker_fns(inst)
    jfns["v"], tfns["v"] = JFlakyFn(marker_fn("v"), failures=1), FlakyFn(marker_fn("v"), failures=1)
    jres = jp.lower("threaded", timeout_s=30, policy=JFaultPolicy()).compile(jfns).run()
    tres = tp.lower("threaded", timeout_s=30, policy=FaultPolicy()).compile(tfns).run()
    assert tres.data == jres.data and tres.data["l0"]["dw"] == ["dv", "w"]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "error"} for r in rs]  # noqa: E731
    assert strip(tres.stats["recoveries"]) == strip(jres.stats["recoveries"])
    assert [r["mode"] for r in tres.stats["recoveries"]] == ["replay"]


def test_straggler_times_out_and_deadline_raises_typed():
    inst = diamond_instance()
    _, tp = instance_plans(inst, to_port(inst))
    fns = marker_fns(inst)
    fns["c_join"] = SlowFn(marker_fn("c_join"), delay_s=1.5, slow_calls=1)
    res = tp.lower("threaded", policy=FaultPolicy(max_retries=2, timeout_s=0.25), **TIMEOUT).compile(fns).run()
    assert res.stats["policy"]["timeouts"] >= 1 and res.stats["policy"]["retries"] >= 1
    want = tp.lower("inprocess").compile(marker_fns(inst)).run()
    assert res.data == want.data
    chain = tswirl.trace(to_port(chain_instance()))
    fns = marker_fns(chain.instance)
    fns["v"] = SlowFn(marker_fn("v"), delay_s=5.0, slow_calls=1)
    with pytest.raises(RunDeadlineExceeded):
        chain.lower("threaded", timeout_s=30, policy=FaultPolicy(deadline_s=0.2)).compile(fns).run()


# -- run_many --------------------------------------------------------------------------


def test_run_many_equals_single_runs_and_the_references():
    jinst, fns, inputs = _serve_workload(100)
    jp, tp = instance_plans(jinst, to_port(jinst))
    texe = tp.lower("threaded", **TIMEOUT).compile(fns)
    many = texe.run_many(inputs, max_concurrent=8)
    jmany = jp.lower("threaded", **TIMEOUT).compile(fns).run_many(inputs, max_concurrent=8)
    single = [texe.run(initial_payloads=p) for p in inputs]
    assert [r.data for r in many] == [r.data for r in single] == [r.data for r in jmany]
    assert all(r.stats["batch_instances"] == 100 for r in many)
    assert [r.stats for r in many] == [r.stats for r in jmany]


def test_two_batches_at_once_do_not_collide():
    jinst, fns, inputs = _serve_workload(40)
    exe = tswirl.trace(to_port(jinst)).optimize().lower("threaded", **TIMEOUT).compile(fns)
    assert exe.program.concurrent_batches()
    want = [exe.run(initial_payloads=p).data for p in inputs]
    got: dict[int, list] = {}
    errs: list[BaseException] = []

    def batch(k):
        try:
            got[k] = [r.data for r in exe.run_many(inputs, max_concurrent=4)]
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=batch, args=(k,), daemon=True) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errs and got == {0: want, 1: want}


def test_launch_counts_stay_exact_under_many_lanes(monkeypatch):
    """Stress: ``run_many`` over 16 lanes × 3 location threads (more threads
    than cores) with a shortened switch interval, each rmsnorm call counted
    through the locked counter (the switch forced to the kernel path): no
    count is lost and every store equals a single run's."""
    import sys

    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    jinst, _, _ = _serve_workload(1)
    w = torch.ones(8)
    fns = {
        "ingest": lambda i: {"d_ingest": kops_rmsnorm(i["d_seed"], w)},
        "work_a": lambda i: {"d_a": kops_rmsnorm(i["d_ingest"], w)},
        "work_b": lambda i: {"d_b": i["d_ingest"] * 2},
        "merge": lambda i: {},
    }
    inputs = [{("l0", "d_seed"): torch.full((4, 8), float(i))} for i in range(96)]
    exe = tswirl.trace(to_port(jinst)).optimize().lower("threaded", **TIMEOUT).compile(fns)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kops.reset_launch_counts()
        many = exe.run_many(inputs, max_concurrent=16)
        assert kops.launch_counts() == {"rmsnorm": 2 * len(inputs)}
    finally:
        sys.setswitchinterval(interval)
    for res, payloads in zip(many, inputs):
        want = exe.run(initial_payloads=payloads).data
        assert all(torch.equal(res.data[loc][d], v) for loc in want for d, v in want[loc].items())


# -- traced spans -----------------------------------------------------------------------


def test_traced_span_schemas_equal_the_references():
    cases = [quickstart_plans(RULES) + (None,)]
    jinst, tinst = j_genomes(**SMALL_GENOMES), t_genomes(**SMALL_GENOMES)
    cases.append(instance_plans(jinst, tinst) + (genomes_init(jinst),))
    for inst in dags(70)[:4]:
        cases.append(instance_plans(inst, to_port(inst)) + (None,))
    for jp, tp, init in cases:
        jres, tres = run_both(jp, tp, identity_step_fns(jp.instance), init, trace=True)
        assert tres.data == jres.data
        assert tres.profile.span_schema() == jres.profile.span_schema()
        assert tres.profile.backend == "threaded"


def test_run_many_attaches_one_profile_per_result():
    _, tp = quickstart_plans(RULES)
    results = tp.lower("threaded", trace=True, **TIMEOUT).compile(identity_step_fns(tp.instance)).run_many(
        [None, None, None])
    assert len({r.profile.span_schema() for r in results}) == 1
    assert all(len(r.profile.spans) > 0 for r in results)


def test_untraced_runs_never_settle_and_traced_exec_spans_do(monkeypatch):
    """An exec span ends after its step's device work (``_settle_outputs``);
    an untraced run never reaches it, so it never synchronises."""
    calls = []
    real = tthreaded._settle_outputs
    monkeypatch.setattr(tthreaded, "_settle_outputs", lambda out, names: (calls.append(names), real(out, names)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (_ for _ in ()).throw(AssertionError("synced")))
    _, tp = quickstart_plans(RULES)
    fns = {s: (lambda i, s=s: {d: torch.ones(2) for d in tp.instance.out_data(s)}) for s in tp.steps()}
    tp.lower("threaded", **TIMEOUT).compile(fns).run()
    assert calls == []
    res = tp.lower("threaded", trace=True, **TIMEOUT).compile(fns).run()
    assert len(calls) == sum(sp.kind == "exec" for sp in res.profile.spans) == len(tp.steps())


# -- the port's backends and the legacy oracles agree -------------------------------------


def _legacy_threaded(plan, fns) -> dict:
    with suppress_deprecations():
        rt = ThreadedRuntime(build_bundles(plan.system, fns), timeout_s=60)
        data = rt.run()
    return {loc: dict(d) for loc, d in data.items()}


def _legacy_reduction(plan, fns) -> dict:
    with suppress_deprecations():
        rt = Runtime(plan.system, fns)
        rt.run()
    return {loc: rt.location_data(loc) for loc in plan.system.locations()}


@pytest.mark.parametrize("chunk", range(4))
def test_backends_and_legacy_oracles_agree(chunk):
    for inst in dags(50 + chunk)[:5]:
        fns = identity_step_fns(inst)
        raw = tswirl.trace(to_port(inst))
        for plan in (raw, raw.optimize(RULES)):
            want = plan.lower("threaded", **TIMEOUT).compile(fns).run().data
            assert plan.lower("inprocess").compile(fns).run().data == want
            assert plan.lower("torch", platform="cpu").compile(fns).run().data == want
            assert _legacy_threaded(plan, fns) == want
            for loc, payloads in _legacy_reduction(plan, fns).items():
                assert want.get(loc, {}) == payloads
        assert raw.lower("threaded", **TIMEOUT).compile(fns).run().data == want


# -- emitted sources -----------------------------------------------------------------------


def _genomes_pair():
    jinst, tinst = j_genomes(n=3, m=2, a=2, b=2, c=2), t_genomes(n=3, m=2, a=2, b=2, c=2)
    return instance_plans(jinst, tinst, ("R1R2",)) + (jinst,)


def test_emitted_sources_equal_the_references_but_for_the_header():
    jp, tp, _ = _genomes_pair()
    want = j_emit_program_sources(jp.exec_program())
    got = emit_program_sources(tp.exec_program())
    assert set(got) == set(want)
    for loc, src in got.items():
        assert src.count("repro_torch.exec.emit") == 1
        assert src.replace("repro_torch.exec.emit", "repro.exec.emit") == want[loc]
    assert emit_location_source(tp.exec_program()["l^d"]) == got["l^d"]


def test_emitted_sources_run_to_the_reduction_runtimes_store():
    _, tp, jinst = _genomes_pair()
    fns = identity_step_fns(jinst)
    init = {("l^d", d): f"raw:{d}" for d in jinst.g("l^d")}
    with suppress_deprecations():
        rt = Runtime(tp.system, fns, initial_payloads=init)
    rt.run()
    programs = {}
    for loc, src in emit_program_sources(tp.exec_program()).items():
        ns: dict = {}
        exec(compile(src, f"<bundle:{loc}>", "exec"), ns)  # noqa: S102
        programs[loc] = ns["run"]
    channels, results, errors = ChannelRegistry(), {}, []

    def drive(loc):
        try:
            results[loc] = programs[loc](channels, fns, {d: v for (l, d), v in init.items() if l == loc})
        except Exception as e:  # noqa: BLE001
            errors.append((loc, e))

    threads = [threading.Thread(target=drive, args=(loc,), daemon=True) for loc in programs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
        assert not th.is_alive(), "a generated bundle deadlocked"
    assert not errors, errors
    for loc in programs:
        assert results[loc] == rt.location_data(loc), loc


def test_legacy_entry_points_warn_as_the_references():
    jp, tp, jinst = _genomes_pair()
    fns = identity_step_fns(jinst)
    with pytest.warns(DeprecationWarning, match="compile_bundles"):
        bundles = compile_bundles(tp.system, fns)
    assert set(bundles) == set(tp.system.locations())
    assert "sIM" in bundles["l^IM"].exec_steps() and bundles["l^IM"].channels()
    with pytest.warns(DeprecationWarning, match="emit_python_source"):
        assert emit_python_source(bundles["l^IM"]) == emit_location_source(tp.exec_program()["l^IM"])
    with pytest.warns(DeprecationWarning, match="emit_all"):
        assert emit_all(tp.system) == emit_program_sources(tp.exec_program())
    with pytest.warns(DeprecationWarning, match="threaded"):
        ThreadedRuntime(bundles)
    with pytest.warns(DeprecationWarning, match="Runtime"):
        Runtime(tp.system, fns)
    missing = dict(fns)
    del missing["sIM"]
    with pytest.raises(KeyError), suppress_deprecations():
        build_bundles(tp.system, missing)
    qp = quickstart_plans(RULES)[1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the staged pipeline warns of nothing it drives
        qp.lower("threaded").compile(identity_step_fns(qp.instance)).run()


def test_checkpoint_is_refused_as_in_the_reference():
    _, tp = quickstart_plans(RULES)
    exe = tp.lower("threaded").compile(identity_step_fns(tp.instance))
    with pytest.raises(BackendCapabilityError):
        exe.checkpoint()


# -- tensors: no payload moves ---------------------------------------------------------------


def test_a_returned_tensor_is_the_very_object_in_every_store():
    _, tp = quickstart_plans(())  # raw: the COMMs stay, so tensors cross locations
    made: dict[str, torch.Tensor] = {}

    def body(s):
        def fn(inp):
            out = {}
            for d in tp.instance.out_data(s):
                out[d] = made[d] = torch.full((3,), float(len(inp)))
            return out
        return fn

    res = tp.lower("threaded", **TIMEOUT).compile({s: body(s) for s in tp.steps()}).run()
    seen = 0
    for loc, data in res.data.items():
        for d, v in data.items():
            assert v is made[d], (loc, d)
            seen += 1
    assert seen > len(made)  # some tensor sits in two locations' stores


# -- phase 16 of chip_smoke.py, rehearsed -------------------------------------------------


def test_phase_16_rehearsed_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_threaded`` on the CPU at small shapes, the switch
    forced to the kernel path (the plain rmsnorm counts as the card's
    launch), the card's
    synchronise a no-op and its profiler stubbed (no device time here, so
    the exec-span cover check reads 0).  The phase's own checks run: stores
    against the ``torch`` backend, rmsnorm steps against the plain version,
    3 launches a run, every P-split datum the very object on both sides, G
    equal under drops with drops and resends counted, S-serve's two ways
    equal with 200 launches in ``run_many``, traced stores and schemas, and
    the failing step's error and recovery."""
    cs = _load("chip_smoke_for_threaded_tests", "chip_smoke.py")
    monkeypatch.setattr(cs, "DP_SHAPES", {"P-ref": (8, 16), "P-full": (32, 64)})
    monkeypatch.setattr(cs, "G_ELEMS", 64)
    monkeypatch.setattr(cs, "SERVE_SHAPE", (4, 32))
    monkeypatch.setattr(cs, "DP_REPEATS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms_and_copies", lambda torch_, fn: (fn(), (0.0, 0, 0))[1])
    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    out = cs.phase_threaded(torch, "cpu rehearsal", "H100 SXM", device="cpu")
    three = {"rmsnorm": cs.DP_NORMS}
    assert out["launches"] == {"P-ref": three, "P-ref/split": three, "P-full": three, "P-full/split": three,
                               "S-serve run_many": {"rmsnorm": 200}}
    assert out["P-full/split"]["sends"] == cs.DP_STEPS - 1
    assert out["G"]["locations"] == 9 and out["G"]["resends"] >= 1
    assert out["S-serve"]["instances"] == 100
    # A run starts a thread per location and per Par branch.
    assert out["threads_a_run"] == {"P-ref": 13, "P-ref/split": 14, "P-full": 13, "P-full/split": 14, "G": 52}
