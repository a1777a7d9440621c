"""The port's tracing (``repro_torch.obs``) against the reference's.

The port's recorder answers the reference's recorder unit cases; torch
tensors are sized from their metadata; and the same plans traced on the
port's ``torch`` backend (on the CPU) and on the reference's ``jax``
backend (one CPU device) give equal timing-free span schemas: the
quickstart plan, 20 seeded layered DAGs, the 12-step rmsnorm pipeline
(interpreted and fused) and 1000 Genomes.  Exporters, profiles and the
untraced path are checked on the port's side.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import identity_step_fns
from test_differential import random_instance
from test_torch_dataplane import (
    G_ELEMS,
    RULES,
    assert_stores_close,
    genomes_fns,
    jax_options,
    jax_pipeline_fns,
    pipeline,
    pipeline_input,
    torch_options,
    torch_pipeline_fns,
)
from test_torch_swirl import to_port

from repro import swirl as jswirl
from repro.core.graph import DistributedWorkflowInstance as JInstance
from repro.core.graph import make_workflow as j_make_workflow
from repro.core.translate import genomes_1000 as j_genomes
from repro.obs import TraceRecorder as JTraceRecorder
from repro_torch import swirl as tswirl
from repro_torch.backends import torch_backend
from repro_torch.core.graph import DistributedWorkflowInstance as TInstance
from repro_torch.core.graph import make_workflow as t_make_workflow
from repro_torch.core.translate import genomes_1000 as t_genomes
from repro_torch.exec.policy import FaultPolicy
from repro_torch.obs import (
    RunProfile,
    SpanEvent,
    TraceRecorder,
    chrome_trace,
    payload_nbytes,
    validate_chrome_trace,
    write_chrome_trace,
)

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
N_DAGS = 20


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
    return tswirl.trace(EDGES, mapping=MAPPING).optimize()


def traced_run(plan, **extra):
    exe = plan.lower("torch", trace=True, **torch_options(**extra)).compile(
        quickstart_steps())
    return exe.run()


def jax_traced_run(jplan, fns, init=None, **extra):
    exe = jplan.lower("jax", trace=True, **jax_options(**extra)).compile(fns)
    return exe.run(initial_payloads=init)


# -- the recorder primitive (the reference's unit cases) ---------------------------


class TestTraceRecorder:
    def test_span_roundtrip(self):
        rec = TraceRecorder()
        rec.span("exec", "l0", "s1", 0.1, 0.2)
        rec.span("send", "l0", "d1", 0.2, 0.3, src="l0", dst="l1", nbytes=8)
        assert len(rec) == 2
        spans = rec.drain()
        assert len(rec) == 0
        assert [s.kind for s in spans] == ["exec", "send"]
        assert spans[1].nbytes == 8 and spans[1].duration == pytest.approx(0.1)

    def test_absorb_applies_clock_offset(self):
        rec = TraceRecorder(t_zero=0.0)
        worker_spans = [SpanEvent("exec", "w0", "s", 10.0, 11.0)]
        rec.absorb(worker_spans, offset=-9.5)
        (merged,) = rec.drain()
        assert merged.start == pytest.approx(0.5)
        assert merged.end == pytest.approx(1.5)

    def test_drain_merge_ordered_by_location(self):
        rec = TraceRecorder()
        rec.span("exec", "z", "s1", 0.0, 1.0)
        rec.span("exec", "a", "s2", 0.0, 1.0)
        assert [s.location for s in rec.drain()] == ["a", "z"]

    def test_disabled_span_allocates_nothing(self):
        rec = TraceRecorder(enabled=False)
        rec.span("exec", "l0", "warmup", 0.0, 1.0)
        gc.disable()
        try:
            gc.collect()
            before = sys.getallocatedblocks()
            for _ in range(10_000):
                rec.span("exec", "l0", "step", 0.0, 1.0)
            after = sys.getallocatedblocks()
        finally:
            gc.enable()
        assert after - before <= 16
        assert len(rec) == 0

    def test_materialised_rows_equal_the_reference(self):
        rows = [("exec", "b", "s", 1.0, 2.0, None, None, None, None),
                ("send", "a", "d", 1.5, 1.75, "a", "b", "p", np.zeros(3)),
                ("recv", "b", "p", 1.5, 1.75, "a", "b", "p", 24)]
        t, j = TraceRecorder(t_zero=0.5), JTraceRecorder(t_zero=0.5)
        for r in rows:
            t.add(r)
            j.add(r)
        assert [tuple(e) for e in t.drain()] == [tuple(e) for e in j.drain()]


# -- sizing payloads without touching them ----------------------------------------------


class TestPayloadSizing:
    @pytest.mark.parametrize("case", ["contiguous", "strided", "bf16", "scalar", "empty"])
    def test_torch_tensors_answer_numel_times_element_size(self, case):
        base = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        t = {
            "contiguous": base,
            "strided": base[:, ::2, 1:7].transpose(0, 2),
            "bf16": base.to(torch.bfloat16)[1:, :, ::3],
            "scalar": torch.tensor(3.0, dtype=torch.float64),
            "empty": base[:0],
        }[case]
        assert payload_nbytes(t) == t.numel() * t.element_size()

    def test_numpy_and_buffers_as_the_reference(self):
        from repro.obs.events import payload_nbytes as j_payload_nbytes

        for v in (np.zeros(65536), b"x" * 4096, bytearray(8192),
                  memoryview(bytearray(1024)), {"a": 1}, [1, 2, 3]):
            assert payload_nbytes(v) == j_payload_nbytes(v)

    def test_sizing_a_tensor_never_reads_its_data(self, monkeypatch):
        t = torch.zeros(1 << 20)

        def boom(*a, **k):
            raise AssertionError("sizing read the tensor's data")

        for name in ("numpy", "tolist", "item", "cpu", "__array__"):
            monkeypatch.setattr(torch.Tensor, name, boom)
        assert payload_nbytes(t) == 4 << 20

    def test_size_model_from_payloads_sizes_tensors(self):
        from repro_torch.sched import SizeModel

        m = SizeModel.from_payloads({("l", "a"): torch.zeros(10, dtype=torch.float16)})
        assert m.bytes_of("a") == 20


# -- equal span schemas against the jax backend ---------------------------------------


def test_quickstart_span_schema_equals_jax(plan):
    tres = traced_run(plan)
    jres = jax_traced_run(jswirl.trace(EDGES, mapping=MAPPING).optimize(), quickstart_steps())
    assert isinstance(tres.profile, RunProfile) and tres.profile.backend == "torch"
    assert tres.profile.span_schema()
    assert tres.profile.span_schema() == jres.profile.span_schema()
    assert tres.data == jres.data


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("seed", range(N_DAGS))
def test_seeded_dag_span_schema_equals_jax(seed, fuse):
    inst = random_instance(random.Random(15_000 + seed))
    jres = jax_traced_run(jswirl.trace(inst).optimize(RULES), identity_step_fns(inst),
                          fuse=fuse)
    pinst = to_port(inst)
    texe = tswirl.trace(pinst).optimize(RULES).lower(
        "torch", trace=True, **torch_options(fuse=fuse)).compile(identity_step_fns(pinst))
    tres = texe.run()
    assert tres.profile.span_schema() == jres.profile.span_schema()
    assert tres.data == jres.data


@pytest.mark.parametrize("fuse", [False, True])
def test_pipeline_span_schema_equals_jax(fuse):
    jplan = jswirl.trace(pipeline(JInstance, j_make_workflow)).optimize()
    tplan = tswirl.trace(pipeline(TInstance, t_make_workflow)).optimize()
    x = pipeline_input()
    jres = jax_traced_run(jplan, jax_pipeline_fns(), {("l0", "d0"): x}, fuse=fuse)
    texe = tplan.lower("torch", trace=True, **torch_options(fuse=fuse)).compile(
        torch_pipeline_fns())
    for _ in range(2):  # the first fused call captures, the second replays
        tres = texe.run(initial_payloads={("l0", "d0"): x})
        schema = tres.profile.span_schema()
        assert schema == jres.profile.span_schema()
        assert len(schema) == 12
        assert_stores_close(tres.data, jres.data)
    if fuse:
        assert tres.stats["fused"]["fused_execs"] == 12
        spans = [s for s in tres.profile.spans if s.kind == "exec"]
        # Every exec of the segment carries the segment's interval.
        assert len({(s.start, s.end) for s in spans}) == 1


@pytest.mark.parametrize("fuse", [False, True])
def test_genomes_span_schema_equals_jax(fuse):
    kw = dict(n=4, m=3, a=2, b=2, c=2)
    jinst, tinst = j_genomes(**kw), t_genomes(**kw)
    rng = np.random.default_rng(0)
    init = {("l^d", d): rng.random(G_ELEMS).astype(np.float32) for d in sorted(jinst.g("l^d"))}
    jfns = genomes_fns(jinst, init, jnp.sum, lambda: jnp.ones(G_ELEMS, jnp.float32))
    tfns = genomes_fns(tinst, init, torch.sum, lambda: torch.ones(G_ELEMS))
    jres = jax_traced_run(jswirl.trace(jinst).optimize(RULES), jfns, dict(init), fuse=fuse)
    tres = tswirl.trace(tinst).optimize(RULES).lower(
        "torch", trace=True, **torch_options(fuse=fuse)).compile(tfns).run(
        initial_payloads=dict(init))
    assert tres.profile.span_schema() == jres.profile.span_schema()
    assert_stores_close(tres.data, jres.data)
    sends = [s for s in tres.profile.spans if s.kind == "send"]
    jsends = [s for s in jres.profile.spans if s.kind == "send"]
    assert sends and sorted((s.src, s.dst, s.name, s.nbytes) for s in sends) == sorted(
        (s.src, s.dst, s.name, s.nbytes) for s in jsends)
    assert tres.profile.cross_bytes() == jres.profile.cross_bytes()


# -- the port's profile ---------------------------------------------------------------


def test_exec_spans_cover_every_step_placement(plan):
    profile = traced_run(plan).profile
    execs = {(ev.name, ev.location) for ev in profile.spans if ev.kind == "exec"}
    assert execs == {
        (step, loc) for step, locs in plan.placement().items() for loc in locs
    }


def test_send_recv_pair_and_carry_equal_bytes(plan):
    profile = traced_run(plan).profile
    sends = [ev for ev in profile.spans if ev.kind == "send"]
    recvs = [ev for ev in profile.spans if ev.kind == "recv"]
    assert sends and len(sends) == len(recvs)
    assert sorted((s.src, s.dst, s.port, s.nbytes) for s in sends) == sorted(
        (r.src, r.dst, r.port, r.nbytes) for r in recvs)
    assert all(s.location == s.src for s in sends)
    assert all(r.location == r.dst for r in recvs)
    assert all((s.nbytes or 0) > 0 for s in sends)
    assert profile.cross_bytes() == sum(s.nbytes for s in sends)


def test_spans_stay_ordered_on_one_clock(plan):
    before = time.monotonic()
    profile = traced_run(plan).profile
    after = time.monotonic()
    spans = profile.spans
    assert all(0.0 <= s.start <= s.end for s in spans)
    assert profile.wall_s <= after - before


def test_chrome_trace_validates_and_roundtrips(plan, tmp_path):
    profile = traced_run(plan).profile
    obj = profile.chrome_trace()
    validate_chrome_trace(obj)
    path = tmp_path / "trace.json"
    profile.save_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    validate_chrome_trace(loaded)
    assert loaded == json.loads(json.dumps(obj))
    names = {
        ev["args"]["name"]
        for ev in obj["traceEvents"]
        if ev["ph"] == "M" and ev["name"] == "thread_name"
    }
    assert {"cpu0", "gpu0"} <= names
    starts = [e for e in obj["traceEvents"] if e["ph"] == "s"]
    finishes = [e for e in obj["traceEvents"] if e["ph"] == "f"]
    assert starts and {e["id"] for e in starts} == {e["id"] for e in finishes}


def test_chrome_trace_validator_and_bare_export(tmp_path):
    with pytest.raises(ValueError):
        validate_chrome_trace({"no": "traceEvents"})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "pid": 1, "tid": 1}]})
    spans = (SpanEvent("exec", "l0", "s1", 0.0, 0.5), SpanEvent("exec", "l0", "s2", 0.5, 0.9))
    path = tmp_path / "bare.json"
    write_chrome_trace(str(path), spans, phases=(("lower", 0.001),))
    validate_chrome_trace(json.loads(path.read_text()))
    from repro.obs import chrome_trace as j_chrome_trace

    assert chrome_trace(spans, phases=(("lower", 0.001),)) == j_chrome_trace(
        spans, phases=(("lower", 0.001),))


def test_untraced_run_has_no_profile(plan):
    exe = plan.lower("torch", **torch_options()).compile(quickstart_steps())
    assert exe.run().profile is None


@pytest.mark.parametrize("fuse", [False, True])
def test_untraced_run_reads_no_span_clock_and_syncs_nothing(monkeypatch, fuse):
    """With ``trace`` off the reducer gains no work: no ``time.monotonic``
    and no synchronise on tracing's behalf."""

    def boom(*a):
        raise AssertionError("an untraced run touched the tracing path")

    monkeypatch.setattr(torch_backend, "time", types.SimpleNamespace(
        perf_counter=time.perf_counter, monotonic=boom))
    monkeypatch.setattr(torch_backend, "_settle", boom)
    tplan = tswirl.trace(pipeline(TInstance, t_make_workflow)).optimize()
    for policy in (None, FaultPolicy(max_retries=1)):
        exe = tplan.lower("torch", **torch_options(fuse=fuse, policy=policy)).compile(
            torch_pipeline_fns())
        res = exe.run(initial_payloads={("l0", "d0"): pipeline_input()})
        assert res.profile is None and res.stats["execs"] == 12


def test_policy_retries_are_recorded():
    attempts = {"n": 0}

    def flaky(inp):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("transient")
        return {"d^preprocess": list(range(10))}

    fns = dict(quickstart_steps(), preprocess=flaky)
    tplan = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    res = tplan.lower("torch", trace=True, **torch_options(
        policy=FaultPolicy(max_retries=2, backoff_s=0.0))).compile(fns).run()
    policy = [s for s in res.profile.spans if s.kind == "policy"]
    assert [(s.location, s.name) for s in policy] == [("-", "retry:preprocess")]
    assert res.stats["policy"]["retries"] == 1


def test_run_many_attaches_one_profile_per_result(plan):
    exe = plan.lower("torch", trace=True, **torch_options()).compile(quickstart_steps())
    results = exe.run_many([None, None, None])
    assert len({r.profile.span_schema() for r in results}) == 1
    assert all(len(r.profile.spans) > 0 for r in results)
    assert len({id(r.profile) for r in results}) == 3


def test_profile_carries_pipeline_phases(plan):
    result = traced_run(plan)
    labels = [label for label, _ in result.profile.phases]
    assert "lower" in labels and "compile[torch]" in labels
    assert "compile[torch]" in plan.explain()
    assert "profile[torch]" in result.profile.summary()


# -- service metrics ------------------------------------------------------------------


def _fill(registry_cls, ops):
    reg = registry_cls()
    for kind, name, args, labels in ops:
        metric = getattr(reg, kind)(name, f"help for {name}")
        getattr(metric, args[0])(*args[1:], **labels)
    return reg


def test_metrics_registry_renders_as_the_reference():
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry as TRegistry

    rng = np.random.default_rng(3)
    ops = [("counter", "runs_total", ("inc",), {"backend": "torch"}),
           ("counter", "runs_total", ("inc", 2.0), {"backend": 'q"x\\y'}),
           ("gauge", "in_flight", ("set", 3.0), {}),
           ("gauge", "in_flight", ("dec",), {}),
           ("counter", "bytes_total", ("set", 1e12), {})]
    ops += [("histogram", "run_seconds", ("observe", float(v)), {"plan": f"p{i % 3}"})
            for i, v in enumerate(rng.exponential(0.05, 40))]
    treg, jreg = _fill(TRegistry, ops), _fill(JRegistry, ops)
    assert treg.render() == jreg.render()
    assert treg.CONTENT_TYPE == jreg.CONTENT_TYPE
    with pytest.raises(TypeError, match="already registered"):
        treg.gauge("runs_total")
    with pytest.raises(TypeError, match="already registered"):
        treg.histogram("in_flight")
