"""``BENCHMARK.json`` against the contract's static rules, and every cell,
driver, reader, reference, layer kind and file it names found under
``bench/``."""

import json
import re
from pathlib import Path

import pytest

from bench.counts.flops import layer_seq

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32 and all(line(w) for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    # 24 cells must fit the check's budget: 2 + 14 x 24 runs, 2 x 90 s of compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(spec):
    assert 1 <= len(spec["configs"]) <= 24
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("bench/") and (REPO / c["file"]).is_file()
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        ref = Path(conf["reference"])
        assert ref.parent == Path("bench/reference") and (REPO / ref).is_file(), conf["reference"]
        for kind in {k for layer in layer_seq(conf["model"]) for k in layer}:
            assert (REPO / "bench" / "layers" / f"{kind}.py").is_file(), (c["name"], kind)
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    assert len({c["file"] for c in spec["configs"]}) == len(spec["configs"])


def test_cells(spec):
    names = [w["name"] for w in spec["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(names)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(names) // 4)
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs and line(w["why"])
        wl = json.loads((REPO / "bench" / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"] and wl["why"] == w["why"]
        assert (REPO / "bench" / "drivers" / f"{wl['driver']}.py").is_file()


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e, per = spec["end_to_end"], spec["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"]) and m["moves"] in {e["name"] for e in e2e}
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
        layers.setdefault(m["layer"], m["layer"])
    for m in e2e + per:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [m["name"] for m in e2e if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        moved = [m for m in per if cell in m.get("workloads", cells if m["moves"] in mine else [])]
        assert moved and all(m["moves"] in mine for m in moved), cell
