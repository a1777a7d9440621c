"""The readers of the program's own spans (``bench/harness/spans.py`` and
the six metrics that read it), on synthetic records and recorder rows; the
trace's clock base; and on the card, a traced run of each cell."""

import json
import subprocess
import sys
import time

import pytest

from bench.harness import core, spans
from repro_torch import obs

BASE_NS = 230 * spans.TRIMONTH_S * 1_000_000_000
ANCHOR = (100.0, BASE_NS + 1_000_000_000)  # trace us 1e6 is monotonic 100 s


def raw(us: float) -> float:
    """The monotonic stamp that lands at trace ``us`` through ``ANCHOR``."""
    return 100.0 + (us - 1e6) * 1e-6


def row(name, thread, s, e, kind="span"):
    return (kind, str(thread) if kind == "span" else thread, name, raw(1e6 + s), raw(1e6 + e),
            None, None, None, None)


def record(device):
    """``device``: ``(start, dur, launch thread, launch ts)``, offsets from 1e6 us."""
    return {
        "stretch": (1e6, 1e6 + 1000.0),
        "device": [(f"k{i}", 1e6 + s, d, i) for i, (s, d, _, _) in enumerate(device)],
        "launches": {i: (tid, 1e6 + ts) for i, (_, _, tid, ts) in enumerate(device)},
    }


def decode_case():
    rows = [row("serve.decode", 7, 100, 400), row("serve.decode", 7, 500, 800),
            row("model.moe.route", 7, 150, 250), row("model.moe.experts", 7, 250, 300),
            row("model.moe.combine", 7, 550, 650), row("model.moe.route", 8, 120, 140)]
    rec = record([(200, 100, 7, 120), (350, 100, 7, 310), (600, 150, 7, 560), (760, 40, 7, 700)])
    return rec, rows


def train_case():
    rows = [row("train.iteration", 1, 10, 990), row("plan.compile", 1, 10, 60),
            row("fwdbwd_0", "pod0", 100, 500, "exec"), row("fwdbwd_1", "pod1", 120, 520, "exec"),
            row("gradsync", "pod0", 550, 600, "exec"), row("gradsync", "pod1", 550, 600, "exec"),
            row("update_0", "pod0", 620, 700, "exec"), row("update_1", "pod1", 630, 720, "exec"),
            row("model.moe.route", 2, 150, 200), row("model.moe.route", 4, 300, 320),
            row("optim.compress", 2, 450, 500), row("optim.compress", 3, 470, 515),
            row("optim.decompress", 2, 555, 570), row("optim.allreduce_mean", 2, 575, 590)]
    rec = record([(170, 10, 2, 160), (330, 20, 4, 310), (180, 30, 3, 160), (470, 40, 2, 460),
                  (490, 50, 3, 480), (565, 60, 2, 560), (585, 70, 2, 580), (700, 80, 2, 650)])
    return rec, rows


def read(monkeypatch, metric, case, anchor=ANCHOR):
    rec, rows = case
    monkeypatch.setattr(obs, "take", lambda: (anchor, list(rows)))
    return core.load_reader(metric).read(rec)


DECODE = {
    "step_host_ms.decode": 0.3,  # two steps of 300 us
    # idle [0,200] [300,350] [450,600] [750,760] [800,1000] = 610 us; outside the steps 100 + 50 + 200
    "idle_between_steps_share.decode": 100 * 350 / 610,
    # MoE on the steps' thread 100 + 50 + 100 us of 600 (thread 8's span is not the step's)
    "moe_host_share.decode": 100 * 250 / 600,
}
TRAIN = {
    # exec spans cover [100,520] [550,600] [620,720] = 570 of the iteration's 980 us
    "plan_host_share.train": 100 * (1 - 570 / 980),
    # route: thread 2's launch at 160 and autograd thread 4's at 310 (thread 3's at 160 is not in a route span)
    "moe_route_share.train": 100 * 30 / 360,
    "int8_sync_share.train": 100 * (40 + 50 + 60 + 70) / 360,
}


@pytest.mark.parametrize("metric, case", [(m, decode_case) for m in DECODE] + [(m, train_case) for m in TRAIN])
def test_each_reader_reads_its_synthetic_record(monkeypatch, metric, case):
    want = {**DECODE, **TRAIN}[metric]
    assert read(monkeypatch, metric, case()) == pytest.approx(want)


@pytest.mark.parametrize("metric, case", [(m, decode_case) for m in DECODE] + [(m, train_case) for m in TRAIN])
def test_a_shifted_clock_reads_nothing(monkeypatch, metric, case):
    # 2 ms late: the spans leave the stretch, or the launches leave the steps
    assert read(monkeypatch, metric, case(), anchor=(ANCHOR[0], ANCHOR[1] + 2_000_000)) is None
    assert read(monkeypatch, metric, case(), anchor=(ANCHOR[0], ANCHOR[1] - 150_000)) is None


def test_launches_outside_the_steps_read_nothing(monkeypatch):
    rec, rows = decode_case()
    rec["launches"][3] = (7, 1e6 + 450)  # one launch in four between the steps: 75 % inside
    assert read(monkeypatch, "step_host_ms.decode", (rec, rows)) is None
    rec["launches"][3] = (8, 1e6 + 700)  # inside a step's time, on another thread
    assert read(monkeypatch, "step_host_ms.decode", (rec, rows)) is None


def test_launches_from_a_thread_without_spans_read_nothing(monkeypatch):
    # As Kineto gives a new thread an ended thread's id: inside the iteration, but no span on 9 or 5
    rec, rows = train_case()
    rec["launches"] = {k: ((9 if tid == 2 else 5), ts) for k, (tid, ts) in rec["launches"].items()}
    assert read(monkeypatch, "int8_sync_share.train", (rec, rows)) is None


def test_a_stretch_without_device_work_or_a_program_without_spans_reads_nothing(monkeypatch):
    rec, rows = decode_case()
    assert read(monkeypatch, "step_host_ms.decode", (dict(rec, device=[]), rows)) is None
    assert read(monkeypatch, "step_host_ms.decode", (rec, [])) is None
    monkeypatch.delattr(obs, "take")  # a program without the process recorder
    assert core.load_reader("step_host_ms.decode").read(decode_case()[0]) is None


def test_rows_are_taken_once_a_record(monkeypatch):
    rec, rows = decode_case()
    calls = []
    monkeypatch.setattr(obs, "take", lambda: calls.append(1) or (ANCHOR, list(rows)))
    for metric in DECODE:
        assert core.load_reader(metric).read(rec) == pytest.approx(DECODE[metric])
    assert len(calls) == 1


def base_of_an_export(tmp_path, device: str) -> tuple[int, int]:
    """``baseTimeNanoseconds`` of a real export, and the helper's base for
    the time it was taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    now = time.time_ns()
    with profile(activities=acts) as prof:
        torch.ones(4, device=device).sum()
        if device == "cuda":
            torch.cuda.synchronize()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    return int(json.loads(path.read_text())["baseTimeNanoseconds"]), spans.base_ns(now)


def test_the_trace_base_is_the_helpers_on_the_cpu(tmp_path):
    got, want = base_of_an_export(tmp_path, "cpu")
    assert got == want


@pytest.mark.card
def test_the_trace_base_is_the_helpers_on_the_card(card, tmp_path):
    got, want = base_of_an_export(tmp_path, "cuda")
    assert got == want


NEW = {"deepseek-moe-16b.decode": set(DECODE), "granite-moe-1b-a400m.train": set(TRAIN)}


@pytest.mark.card
@pytest.mark.parametrize("cell, seed", [("deepseek-moe-16b.decode", 2147483701), ("granite-moe-1b-a400m.train", 3000000113)])
def test_a_traced_run_of_each_cell_prints_its_span_metrics(card, cell, seed):
    # A process of its own, as the benchmark runs: the profiler's first session in it.
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed", str(seed), "--seconds", "3",
                          "--trace", "1"], cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    assert NEW[cell] <= set(got), (sorted(got), out.stderr[-4000:])
    if cell.endswith(".decode"):
        # A replayed step runs the eager step's 3144 ops and two `_foreach_copy_`s, one in and one out: 3146.
        # Tracing adds no device op and no synchronise: an added op a step reads 3147 or more. The profiler
        # may drop a record of the stretch's 25,168 (one eager run read 3143.875 of 3144), never add one.
        assert 3145 <= got["device_ops_per_step.decode"]["value"] <= 3146
