"""The DeepSeek-V2-Lite configuration's cell on the CPU at a tiny size, added
by files alone: a sound run is correct against its MLA reference, a traced
run reads the metrics the cell lists (none of the device's on the CPU), and
each planted serving fault fails the check."""

import copy
import json
from functools import partial

import pytest

from bench.drivers import serve
from bench.harness import core
from bench.tests import faults
from bench.tests.conftest import REPO, write_cell
from bench.tests.test_bench_cells import run_cell

CELL = "tiny-v2.long-prompt"
TINY = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
            moe={"n_experts": 8, "top_k": 2, "d_expert": 32, "n_shared": 2, "capacity_factor": 1.25,
                 "router_aux_weight": 0.01},
            mla={"kv_lora_rank": 32, "q_lora_rank": 0, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                 "v_head_dim": 16, "factor": 40.0, "original_max_position": 4096, "beta_fast": 32.0,
                 "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707})


@pytest.fixture
def mla_root(tiny_root):
    config = json.loads((REPO / "bench" / "configs" / "deepseek-v2-lite.json").read_text())
    config["name"] = "tiny-v2"
    config["model"].update(copy.deepcopy(TINY))
    workload = json.loads((REPO / "bench" / "workloads" / "deepseek-v2-lite.long-prompt.json").read_text())
    # bf16 at this size: the limits of the tiny deepseek cell (conftest), from its readings
    workload.update(config="tiny-v2", batch=3, prompt_len=9, gen=6, warmup_steps=2, profile_after=1,
                    profile_steps=2, limits={"gap_max": 0.05, "gap_mean": 0.005})
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    entry = dict(next(w for w in spec["workloads"] if w["name"] == "deepseek-v2-lite.long-prompt"), name=CELL,
                 config="tiny-v2")
    write_cell(tiny_root, CELL, config, workload, entry)
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "deepseek-v2-lite.long-prompt" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_the_configuration_names_its_mla_reference_and_layer_kind():
    conf = json.loads((REPO / "bench" / "configs" / "deepseek-v2-lite.json").read_text())
    ref = core.load_reference(conf)
    assert ref.__name__ == "bench.reference.mla_decoder"
    for fn in ("serve_logits", "gaps", "forward_loss", "fp32_mm", "fp8_mm", "exact_fp32"):
        assert callable(getattr(ref, fn))
    with pytest.raises(ValueError, match="does not compute"):
        ref.block(conf["model"], ("attn", "moe"), {}, None, [], ref.fp32_mm)


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(mla_root):
    rc, res, err = run_cell(mla_root, CELL, seed=2**31 + 29)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"serve_tok_s", "itl_p95_ms", "setup_s"}


def test_a_traced_run_reads_only_the_host_clocks_metric_on_the_cpu(mla_root):
    rc, res, err = run_cell(mla_root, CELL, trace=1)
    assert rc == 0, err
    # No device operation on the CPU: the MLA kernel's readers and the device's read nothing.
    assert set(res["metrics"]) == {"mfu.serve"} and res["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_each_serving_fault_fails_the_check(mla_root, monkeypatch, fault):
    monkeypatch.setattr(serve, "setup", partial(serve.setup, plant=faults.SERVE[fault]))
    rc, res, err = run_cell(mla_root, CELL)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] > 0
