"""The port's own spans (``repro_torch.obs``'s process recorder).

Off by default: with no profiler recording, a span site reads no clock,
appends no row and allocates nothing, on the serving step, the MoE FFN, the
int8 compression and the trainer's iteration.  Inside ``torch.profiler``
the spans are recorded on every thread with the thread's native id, on a
clock that maps onto the profiler's trace, nested as the program runs; an
``inprocess`` run lowered without ``trace`` records into the process
recorder and still has no profile.
"""

from __future__ import annotations

import json
import threading
import time
import tracemalloc
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from repro_torch import obs
from repro_torch import swirl as tswirl
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.launch.train import Trainer
from repro_torch.models import Model
from repro_torch.models.moe import apply_moe
from repro_torch.obs import events
from repro_torch.optim.compress import compress


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.take()
    yield
    obs.take()
    torch.set_num_threads(n)


def profiling():
    """The profiler as the benchmark runs it: host ops on every thread."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def spans(rows, kind="span"):
    return [r for r in rows if r[0] == kind]


def inside(inner, outer) -> bool:
    return outer[3] <= inner[3] and inner[4] <= outer[4]


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_config("deepseek-moe-16b", smoke=True)
    model = Model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def prefilled(moe_model):
    model, params = moe_model
    cache = model.init_cache(2, 12)
    with torch.inference_mode():
        tok, cache = make_prefill_step(model)(params, {"tokens": torch.arange(8, dtype=torch.int32).view(2, 4)},
                                              cache)
    return tok[:, None], cache


@pytest.fixture(scope="module")
def trainer():
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    return Trainer(cfg, steps=10, n_pods=2, global_batch=4, seq_len=16, ckpt_dir=None, device="cpu")


# -- off by default ------------------------------------------------------------------


def test_off_a_span_site_reads_no_clock_appends_no_row_and_allocates_nothing(monkeypatch):
    def boom():
        raise AssertionError("a span site read the clock with no profiler recording")

    monkeypatch.setattr(events, "time", types.SimpleNamespace(monotonic=boom, time_ns=boom))
    assert obs.active() is None
    for site in (obs.span, obs.step_span):
        with site("probe"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with obs.span("probe"):
                pass
            with obs.step_span("probe"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == events.__file__ and s.size_diff > 0]
    assert grown == []
    assert len(events._PROCESS) == 0 and obs.take() == (None, [])


def test_off_the_program_records_nothing(monkeypatch, moe_model, trainer):
    """``serve_step``, ``apply_moe``, ``compress`` and ``Trainer.iteration``
    with no profiler recording: no clock read on tracing's behalf, no row."""
    def boom():
        raise AssertionError("the program read the span clock with no profiler recording")

    monkeypatch.setattr(events, "time", types.SimpleNamespace(monotonic=boom, time_ns=boom))
    model, params = moe_model
    tok, cache = prefilled(moe_model)
    with torch.inference_mode():
        make_serve_step(model)(params, cache, tok)
    cfg = model.cfg
    moe_p = next(lp["ffn"] for lp in params["layers"] if "router" in lp["ffn"])
    apply_moe(cfg, moe_p, torch.randn(2, 3, cfg.d_model))
    compress({"w": torch.randn(4, 8)})
    trainer.iteration(0)
    assert len(events._PROCESS) == 0


# -- on inside a profiler --------------------------------------------------------------


def test_on_inside_a_profiler_on_the_main_thread_and_a_pool_thread():
    def record(name):
        with obs.span(name):
            pass
        return threading.get_native_id()

    assert obs.active() is None
    with profiling():
        assert obs.active() is events._PROCESS
        main = record("main")
        with ThreadPoolExecutor(1) as pool:
            worker = pool.submit(record, "worker").result()
    assert obs.active() is None
    anchor, rows = obs.take()
    assert anchor is not None and main != worker
    # Each row carries its thread's native id as its location.
    assert sorted((r[1], r[2]) for r in spans(rows)) == sorted([(str(main), "main"), (str(worker), "worker")])
    assert all(r[3] <= r[4] for r in rows)


def test_a_span_lies_within_2_ms_of_its_profiler_range(tmp_path):
    with profiling() as prof:
        with obs.step_span("probe.warm"):
            pass
        with obs.step_span("probe.step"):
            time.sleep(0.005)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    ranges = [e for e in trace["traceEvents"] if e.get("name") == "probe.step" and e.get("ph") == "X"]
    anchor, rows = obs.take()
    row = next(r for r in spans(rows) if r[2] == "probe.step")
    assert len(ranges) == 1 and ranges[0]["tid"] == int(row[1])
    start_us = (obs.unix_ns(anchor, row[3]) - base) * 1e-3
    end_us = (obs.unix_ns(anchor, row[4]) - base) * 1e-3
    assert abs(start_us - ranges[0]["ts"]) < 2000
    assert abs(end_us - (ranges[0]["ts"] + ranges[0]["dur"])) < 2000


def test_a_decode_step_nests_every_moe_stage_inside_it(moe_model):
    model, params = moe_model
    tok, cache = prefilled(moe_model)
    step = make_serve_step(model)
    with profiling(), torch.inference_mode():
        step(params, cache, tok)
    _, rows = obs.take()
    decode = [r for r in spans(rows) if r[2] == "serve.decode"]
    moe = [r for r in spans(rows) if r[2].startswith("model.moe.")]
    assert len(decode) == 1
    n_moe = sum(1 for lp in params["layers"] if "router" in lp["ffn"])
    stages = ("route", "dispatch", "experts", "combine", "shared")
    assert sorted(r[2] for r in moe) == sorted(f"model.moe.{s}" for s in stages for _ in range(n_moe))
    assert all(inside(r, decode[0]) and r[1] == decode[0][1] for r in moe)
    assert {r[2] for r in spans(rows)} == {"serve.decode"} | {f"model.moe.{s}" for s in stages}


def test_an_iteration_spans_the_plan_and_one_exec_firing_a_step(trainer):
    with profiling():
        trainer.iteration(1)
    _, rows = obs.take()
    it = [r for r in spans(rows) if r[2] == "train.iteration"]
    compiled = [r for r in spans(rows) if r[2] == "plan.compile"]
    assert len(it) == 1 and len(compiled) == 1 and inside(compiled[0], it[0])
    fires = {}
    for r in spans(rows, "exec"):
        fires.setdefault(r[2], set()).add((r[3], r[4]))
        assert inside(r, it[0])
    steps = {f"{s}_{i}" for s in ("shard", "fwdbwd", "update") for i in range(2)} | {"gradsync"}
    assert set(fires) == steps and all(len(f) == 1 for f in fires.values())
    names = [r[2] for r in spans(rows)]
    assert names.count("optim.compress") == 2
    assert names.count("optim.decompress") == 2 and names.count("optim.allreduce_mean") == 1
    assert {n for n in names if not n.startswith("model.moe.")} == {
        "train.iteration", "plan.compile", "optim.compress", "optim.decompress", "optim.allreduce_mean"}


def test_an_untraced_inprocess_run_records_into_the_process_recorder_and_has_no_profile():
    fns = {
        "a": lambda inp: {"d^a": 1},
        "b": lambda inp: {"d^b": inp["d^a"] + 1},
    }
    plan = tswirl.trace({"a": ["b"], "b": []}, mapping={"a": ("l0",), "b": ("l1",)}).optimize()
    exe = plan.lower("inprocess").compile(fns)
    assert exe.run().profile is None and obs.take() == (None, [])
    with profiling():
        untraced = exe.run()
        traced = plan.lower("inprocess", trace=True).compile(fns).run()
    assert untraced.profile is None
    assert {s.name for s in traced.profile.spans if s.kind == "exec"} == {"a", "b"}
    _, rows = obs.take()
    # The untraced run's exec spans only: no comm or policy row, so no row
    # holds a payload, and the traced run records into its own recorder.
    assert sorted(r[2] for r in rows) == ["a", "b"] and {r[0] for r in rows} == {"exec"}
    assert all(r[5:] == (None, None, None, None) for r in rows)


def test_each_profiler_session_starts_the_process_recorder_empty():
    """Rows a session left untaken are dropped as the next one starts, and
    the anchor is read anew."""
    with profiling():
        with obs.span("first"):
            pass
    first = events._PROCESS.anchor
    with profiling():
        assert len(events._PROCESS) == 0
        with obs.span("second"):
            pass
    anchor, rows = obs.take()
    assert anchor is not None and anchor != first
    assert [r[2] for r in rows] == ["second"]
