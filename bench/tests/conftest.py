"""Fixtures of the benchmark's own tests: a checkout with two tiny cells,
and the ``card`` marker for tests that need a CUDA device.

Run them from the root of the repository:

    python -m pytest bench/tests -q                 # here: the card tests skip
    python -m pytest bench/tests -q -m card         # on the card
"""

from __future__ import annotations

import copy
import json
import os
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Two cells of the benchmark's own configurations cut to a CPU test's size,
# in bf16 as the real ones; their limits are set from this size's readings.
TINY_MODELS = {
    "tiny-ds": ("deepseek-moe-16b", dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        moe={"n_experts": 7, "top_k": 2, "d_expert": 32, "n_shared": 2, "capacity_factor": 1.25,
             "router_aux_weight": 0.01})),
    "tiny-gr": ("granite-moe-1b-a400m", dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=500,
        moe={"n_experts": 5, "top_k": 2, "d_expert": 32, "n_shared": 0, "capacity_factor": 1.25,
             "router_aux_weight": 0.01})),
}
TINY_CELLS = {
    "tiny-ds.decode": ("tiny-ds", "deepseek-moe-16b.decode", dict(
        batch=3, prompt_len=8, gen=6, warmup_steps=2, profile_after=1, profile_steps=2,
        limits={"gap_max": 0.05, "gap_mean": 0.005})),
    "tiny-gr.train": ("tiny-gr", "granite-moe-1b-a400m.train", dict(
        global_batch=4, seq_len=16,
        limits={"loss_gap": 0.003, "grad_norm_gap": 0.025, "update_norm_gap": 0.1, "grad_diff_median": 0.1})),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA device (decided here, at run time).
    Afterwards hand the card's cached memory back, so that a later test's
    run in a process of its own finds the card free."""
    import gc

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m card")
    yield
    gc.collect()
    torch.cuda.empty_cache()


def write_cell(root: Path, name: str, config: dict, workload: dict, entry: dict) -> None:
    """Add a cell to the checkout at ``root`` by files alone: its
    configuration file (if new), its workload file and its entries."""
    spec_path = root / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    cfile = root / "bench" / "configs" / f"{config['name']}.json"
    if not any(c["name"] == config["name"] for c in spec["configs"]):
        cfile.parent.mkdir(parents=True, exist_ok=True)
        cfile.write_text(json.dumps(config, indent=1))
        spec["configs"].append({"name": config["name"], "source": config["source"],
                                "file": f"bench/configs/{config['name']}.json", "reduced": [], "why": "test"})
    wfile = root / "bench" / "workloads" / f"{name}.json"
    wfile.parent.mkdir(parents=True, exist_ok=True)
    wfile.write_text(json.dumps(workload, indent=1))
    spec["workloads"].append(entry)
    spec_path.write_text(json.dumps(spec, indent=1))


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path) -> Path:
    """A checkout holding the benchmark's files and two tiny cells, each on
    every metric its real sibling has."""
    (tmp_path / "bench").mkdir()
    os.symlink(REPO / "src", tmp_path / "src")
    for part in ("metrics", "reference"):
        os.symlink(REPO / "bench" / part, tmp_path / "bench" / part)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell, (cname, sibling, over) in TINY_CELLS.items():
        arch_conf, model = TINY_MODELS[cname]
        config = json.loads((REPO / "bench" / "configs" / f"{arch_conf}.json").read_text())
        config["name"] = cname
        config["model"].update(copy.deepcopy(model))
        workload = json.loads((REPO / "bench" / "workloads" / f"{sibling}.json").read_text())
        workload.update(copy.deepcopy(over), config=cname)
        entry = dict(next(w for w in spec["workloads"] if w["name"] == sibling), name=cell, config=cname)
        write_cell(tmp_path, cell, config, workload, entry)
        spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
        for m in spec["end_to_end"] + spec["per_layer"]:
            if sibling in m.get("workloads", []):
                m["workloads"].append(cell)
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
