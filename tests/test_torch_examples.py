"""The port's examples against the reference's.

Each ``examples/torch_*.py`` runs in a subprocess with ``--device cpu``
beside the reference example it mirrors, and what both print of their runs
must agree: the quickstart's scores on the backends they share; the traced
1000 Genomes run's span counts and steps; the schedule's simulation,
placement and message counts; 1000 Genomes' plan, message counts, the
``inprocess`` cross-check and the generated bundle, whose header names its
own emitter; the trainer's progress; the pipeline's plan, transfers and
schedule; the serving batch's checks; the gateway's answers line for line;
the multiprocess example's workers, pinning and crash.  Timings, PIDs and
losses (each package inits its own weights) are not compared.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def run_example(name: str, cwd: Path, *args: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout.splitlines()


def pair(name: str, tmp_path: Path, *args: str) -> tuple[list[str], list[str]]:
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    return (run_example(name, tmp_path / "ref", *args),
            run_example(f"torch_{name}", tmp_path / "port", *args, "--device", "cpu"))


def matching(lines: list[str], pattern: str) -> list[tuple]:
    return [m.groups() for m in map(re.compile(pattern).search, lines) if m]


def test_quickstart_scores_equal_the_references(tmp_path):
    ref, port = pair("quickstart", tmp_path)
    scores = r"^\s*(\w+): score = (\d+)$"
    want = dict(matching(ref, scores))
    got = dict(matching(port, scores))
    assert set(got) == {"inprocess", "threaded", "torch"}
    assert {b: got[b] for b in ("inprocess", "threaded")} == {b: want[b] for b in ("inprocess", "threaded")}
    assert got["torch"] == want["jax"] == "54"
    assert port[-1] == ref[-1] == "OK"
    # The plan it explains is the reference's, line for line but the phases' timings.
    explained = lambda ls: [l for l in ls[:ls.index(next(l for l in ls if "score" in l))]  # noqa: E731
                            if not re.search(r"\d ms$", l)]
    assert explained(port) == explained(ref)


def test_profile_run_spans_equal_the_references(tmp_path):
    ref, port = pair("profile_run", tmp_path)
    assert port[0] == ref[0]  # profile[threaded]: N spans (x exec, y comm) over z location(s)
    steps = r"^  (s\w+)\s+[\d.]+m\s+[\d.]+m"
    assert sorted(matching(port, steps)) == sorted(matching(ref, steps))
    wrote = r"^wrote genomes_trace\.json \((\d+) spans\)"
    assert matching(port, wrote) == matching(ref, wrote) != []
    assert (tmp_path / "port" / "genomes_trace.json").is_file()


def test_schedule_placement_equals_the_references(tmp_path):
    ref, port = pair("schedule_placement", tmp_path)
    deterministic = [l for l in ref if "search:" not in l and " ms wall" not in l]
    assert [l for l in port if "search:" not in l and " ms wall" not in l] == deterministic
    counts = r"^(\w+)\s*:\s+[\d.]+ ms wall, (\d+) messages, (\d+) comms planned$"
    assert matching(port, counts) == matching(ref, counts) != []


def test_genomes_1000_equals_the_references(tmp_path):
    ref, port = pair("genomes_1000", tmp_path)
    timed = re.compile(r"^(unoptimised|optimised)\s*:\s+[\d.]+ ms, (\d+) messages$")
    strip = lambda ls: [(m.groups() if (m := timed.match(l)) else l) for l in ls]  # noqa: E731
    cut = lambda ls: ls.index(next(l for l in ls if l.startswith("--- generated bundle")))  # noqa: E731
    assert strip(port[:cut(port)]) == strip(ref[:cut(ref)])
    # The bundle's first 400 characters: the header names the port's emitter,
    # six characters longer, so the port's cut ends six characters sooner.
    got = "\n".join(port[cut(port):])
    want = "\n".join(ref[cut(ref):])
    assert "repro_torch.exec.emit" in got
    got = got.replace("repro_torch.exec.emit", "repro.exec.emit")
    assert want.startswith(got) and len(want) - len(got) == len("_torch")


def test_train_e2e_makes_progress_as_the_references(tmp_path):
    ref, port = pair("train_e2e", tmp_path, "--steps", "100")
    curve = r"^loss: ([\d.]+) → ([\d.]+) \(best-half Δ ([\d.]+)\)$"
    (got,), (want,) = matching(port, curve), matching(ref, curve)
    assert float(got[2]) > 0.05 and float(want[2]) > 0.05
    logged = r"^step\s+(\d+) loss="
    assert matching(port, logged) == matching(ref, logged) != []
    assert port[-1] == ref[-1] == "OK"


def test_pipeline_parallel_equals_the_references(tmp_path):
    ref, port = pair("pipeline_parallel", tmp_path)
    order = lambda ls: next(l for l in ls if l.startswith("execution order:")).split()[2:]  # noqa: E731
    head = lambda ls: [l for l in ls if not l.startswith("execution order:")]  # noqa: E731
    assert head(port) == head(ref)
    assert sorted(order(port)) == sorted(order(ref))
    # Each package's order is a schedule: a microbatch's stages in order.
    for lines in (port, ref):
        seen = order(lines)
        for k in range(3):
            stages = [s for s in seen if s.endswith(f"_mb{k}")]
            assert stages == [f"stage{j}_mb{k}" for j in range(4)]
    assert port[-1] == "pipeline outputs match sequential execution ✓"


def test_serve_batched_equals_the_references(tmp_path):
    ref, port = pair("serve_batched", tmp_path)
    untimed = lambda ls: [l for l in ls if "instances/s" not in l and not l.startswith(("speedup", "[serve]"))]  # noqa: E731
    assert untimed(port) == untimed(ref) == ["OK"]
    rates = r"^(per-request pipeline|compile-once run_many):\s+[\d.]+ instances/s"
    assert matching(port, rates) == matching(ref, rates) != []
    served = r"^\[serve\] arch=(\S+) device=\S+ batch=(\d+) prefill=(\d+) gen=(\d+)"
    assert matching(port, served) != []


def test_gateway_client_equals_the_references(tmp_path):
    ref, port = pair("gateway_client", tmp_path)
    assert port[1:] == ref[1:]  # all but the address it listens on
    assert port[-1] == "gateway drained and closed. OK"


def test_distributed_multiprocess_equals_the_references(tmp_path):
    ref, port = pair("distributed_multiprocess", tmp_path)
    workers = r"^  worker (\d+)(?: \(pid \d+\))?: (.+)$"
    assert matching(port, workers) == matching(ref, workers) != []
    same = ["multiprocess == threaded: identical final stores", "resumed run matches the clean run", "OK"]
    for line in same:
        assert line in port and line in ref
    crash = r"^injected crash: (.+)$"
    assert matching(port, crash) == matching(ref, crash) != []
    held = r"^checkpoint holds (\d+) completed steps"
    assert matching(port, held) and matching(ref, held)
    pinned = r"^two-rack schedule → (\d+) pinned workers:$"
    assert matching(port, pinned) == matching(ref, pinned) != []


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_profile_run", "torch_schedule_placement",
                                  "torch_genomes_1000", "torch_train_e2e", "torch_pipeline_parallel",
                                  "torch_serve_batched", "torch_gateway_client",
                                  "torch_distributed_multiprocess"])
def test_examples_default_to_cuda_and_raise_without_it(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "is_available() is False" in out.stderr
