"""Whole runs of the harness on the CPU at a tiny size: a cell added by
files alone is found and run by name, and the check that decides
``correct`` fails each fault planted under the timed path."""

import io
import json
from functools import partial

import pytest

from bench.drivers import serve, train
from bench.harness import core
from bench.tests import faults
from bench.tests.conftest import write_cell


def run_cell(root, cell, seed=7, seconds=0.5, trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = core.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                  root=root, device="cpu", stdout=out, stderr=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), err.getvalue()


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_a_cell_added_by_files_alone_is_found_and_run(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    config = json.loads((tiny_root / "bench" / "configs" / "tiny-ds.json").read_text())
    config["name"] = "tiny-ds-wide"
    config["model"]["d_model"] = 96
    workload = json.loads((tiny_root / "bench" / "workloads" / "tiny-ds.decode.json").read_text())
    workload.update(config="tiny-ds-wide", batch=2)
    entry = dict(next(w for w in spec["workloads"] if w["name"] == "tiny-ds.decode"),
                 name="tiny-ds-wide.decode", config="tiny-ds-wide")
    write_cell(tiny_root, "tiny-ds-wide.decode", config, workload, entry)
    cell = core.find_cell(core.load_spec(tiny_root), "tiny-ds-wide.decode", tiny_root)
    assert cell.model["d_model"] == 96 and cell.workload["batch"] == 2
    # It reports setup_s (on every cell) and no metric it was not given.
    assert [m["name"] for m in core.metrics_of(core.load_spec(tiny_root), cell.name, False)] == ["setup_s"]
    rc, res, err = run_cell(tiny_root, "tiny-ds-wide.decode")
    assert rc == 0 and res["correct"] and set(res["metrics"]) == {"setup_s"}, err


@pytest.mark.parametrize("cell, e2e", [("tiny-ds.decode", {"serve_tok_s", "itl_p95_ms", "setup_s"}),
                                       ("tiny-gr.train", {"train_tok_s", "setup_s"})])
def test_a_sound_run_is_correct_and_prints_the_contract_line(tiny_root, cell, e2e):
    rc, res, err = run_cell(tiny_root, cell, seed=2**31 + 11)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == e2e and all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks" and res["device"]["count"] == 1
    # The numbers compared are the last lines of standard error, each beside its limit.
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "limit" in line for line in tail)


def test_a_traced_run_reads_its_per_layer_metrics(tiny_root):
    rc, res, err = run_cell(tiny_root, "tiny-ds.decode", trace=1)
    assert rc == 0, err
    # On the CPU no device operation is recorded, so only the host-clock metric reads.
    assert set(res["metrics"]) == {"mfu.serve"} and "breakdown" in res
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0


def test_a_run_without_a_card_prints_no_result(tiny_root):
    out, err = io.StringIO(), io.StringIO()
    rc = core.run(["--workload", "tiny-ds.decode", "--seed", "1", "--seconds", "1"], root=tiny_root,
                  stdout=out, stderr=err)
    assert rc != 0 and out.getvalue() == "" and "CUDA" in err.getvalue()


def test_a_directory_with_only_the_benchmark_prints_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    repo = core.ROOT
    shutil.copy(repo / "BENCHMARK.json", tmp_path)
    shutil.copytree(repo / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "deepseek-moe-16b.decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_each_serving_fault_fails_the_check(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(serve, "setup", partial(serve.setup, plant=faults.SERVE[fault]))
    rc, res, err = run_cell(tiny_root, "tiny-ds.decode")
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_each_training_fault_fails_the_check(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(train, "setup", partial(train.setup, plant=faults.TRAIN[fault]))
    rc, res, err = run_cell(tiny_root, "tiny-gr.train")
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] > 0
