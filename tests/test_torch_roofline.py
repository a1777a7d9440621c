"""The port's roofline (``repro_torch.roofline``) against the reference's.

``analytic``, ``param_count``/``active_param_count``, ``model_flops`` and the
ring terms are pure arithmetic, held equal to the reference's for every
arch and shape.  The roofline's terms use the H100's constants (the
reference's v5e ones are not the port's), so they are held as
``tests/test_roofline.py`` holds the reference's, under the port's
constants.  The collective counter runs DTensor redistributes and explicit
collectives on meta tensors over a ``"fake"`` process group of 64 ranks in
this process (destroyed after): its counts equal ``CommDebugMode``'s, and
its bytes the ring formulas.  ``report`` renders the reference's tables,
character for character, from the same records.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
from datetime import timedelta

import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic
from repro.roofline import hlo as jhlo
from repro.roofline import report as jreport
from repro_torch.configs import get_config as tget
from repro_torch.configs.shapes import SHAPES
from repro_torch.roofline import CHIPS, chip_sku, model_flops, roofline, slstm_extra_flops
from repro_torch.roofline import analytic as tanalytic
from repro_torch.roofline import report as treport
from repro_torch.roofline.collectives import CollectiveCounter, _op_table, _ring_traffic

WAYS = ((16, 16), (16, 32), (1, 1))
H100 = CHIPS["H100 SXM"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_models_equal_the_reference(arch, shape):
    j, t = jget(arch), tget(arch)
    assert tanalytic.analytic_flops_global(t, SHAPES[shape]) == pytest.approx(
        janalytic.analytic_flops_global(j, JSHAPES[shape]), rel=1e-12)
    for mw, dw in WAYS:
        jm = janalytic.analytic_hbm_bytes_per_device(j, JSHAPES[shape], model_ways=mw, data_ways=dw)
        tm = tanalytic.analytic_hbm_bytes_per_device(t, SHAPES[shape], model_ways=mw, data_ways=dw)
        for f in ("params_bytes", "opt_bytes", "grad_bytes", "act_bytes", "kv_bytes", "logits_bytes", "total"):
            assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=1e-12, abs=0.0), (f, mw, dw)
    assert tanalytic.VOCAB_PAD == janalytic.VOCAB_PAD


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_model_flops_equal_the_reference(arch):
    from repro.models.config import unrolled_variant as junrolled
    from repro_torch.models import unrolled_variant as tunrolled

    j, t = jget(arch), tget(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for name, s in SHAPES.items():
        assert model_flops(t, s) == pytest.approx(janalysis.model_flops(j, JSHAPES[name]), rel=1e-12)
        assert slstm_extra_flops(t, s) == pytest.approx(janalysis.slstm_extra_flops(j, JSHAPES[name]), rel=1e-12)
    for chunk in (None, 2048):
        ju, tu = dataclasses.asdict(junrolled(j, ssm_chunk=chunk)), dataclasses.asdict(tunrolled(t, ssm_chunk=chunk))
        assert tu == ju
        tu = tunrolled(t, ssm_chunk=chunk)
        assert tu.layer_seq() == t.layer_seq() and tu.param_count() == t.param_count()


@pytest.mark.parametrize("op", ["all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute"])
def test_ring_traffic_equals_the_reference(op):
    for n in (1, 2, 16, 512):
        for nbytes in (0, 6, 8 * 256 * 2, 12345):
            assert _ring_traffic(op, nbytes, n) == jhlo._ring_traffic(op, nbytes, n), (n, nbytes)


def test_roofline_terms_and_dominant_on_h100():
    """``tests/test_roofline.py``'s terms, under the H100 SXM's constants."""
    r = roofline(
        sku="H100 SXM",
        flops_per_device=H100.peak_flops,  # 1 second of compute
        hbm_bytes_per_device=H100.hbm_bytes_per_s / 2,
        link_bytes_per_device=H100.nvlink_bytes_per_s / 4,
        model_flops_global=H100.peak_flops * 256 * 0.5,
        chips=256,
    )
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.dominant == "compute" and r.bound_s == pytest.approx(1.0)
    assert r.mfu_bound == pytest.approx(0.5)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    # the reference's keys, and the port's two
    keys = set(janalysis.roofline(flops_per_device=1, hbm_bytes_per_device=1, link_bytes_per_device=1,
                                  model_flops_global=1, chips=1).as_dict())
    assert set(r.as_dict()) == keys | {"sku", "network_bytes_per_device"}


def test_network_bytes_take_the_network_rate_and_the_levels_overlap():
    nv, net = H100.nvlink_bytes_per_s, H100.network_bytes_per_s
    r = roofline(sku="H100 SXM", flops_per_device=0.0, hbm_bytes_per_device=0.0,
                 link_bytes_per_device=3 * nv + net, network_bytes_per_device=net,
                 model_flops_global=1.0, chips=16)
    assert r.collective_s == pytest.approx(3.0) and r.dominant == "collective"
    r = roofline(sku="H100 SXM", flops_per_device=0.0, hbm_bytes_per_device=0.0,
                 link_bytes_per_device=nv + 2 * net, network_bytes_per_device=2 * net,
                 model_flops_global=1.0, chips=16)
    assert r.collective_s == pytest.approx(2.0)
    with pytest.raises(ValueError, match="network bytes"):
        roofline(sku="H100 SXM", flops_per_device=0, hbm_bytes_per_device=0, link_bytes_per_device=1,
                 network_bytes_per_device=2, model_flops_global=1, chips=1)
    with pytest.raises(TypeError):
        roofline(flops_per_device=1, hbm_bytes_per_device=1, link_bytes_per_device=1,  # no SKU, no default
                 model_flops_global=1, chips=1)


def test_chip_constants_and_sku_names():
    assert (H100.peak_flops, H100.hbm_bytes_per_s, H100.gpus_per_node) == (989e12, 3.35e12, 8)
    assert H100.nvlink_bytes_per_s > H100.network_bytes_per_s
    assert chip_sku("NVIDIA H100 80GB HBM3") == "H100 SXM"
    assert chip_sku("NVIDIA H100 PCIe") == "H100 PCIe"
    assert chip_sku("NVIDIA A100-SXM4-80GB") is None
    assert janalysis.PEAK_FLOPS != H100.peak_flops  # no v5e constant is the port's


def test_model_flops_train_vs_decode_and_moe():
    """``tests/test_roofline.py``'s model-FLOPs cases on the port."""
    cfg = tget("llama3.2-3b")
    assert model_flops(cfg, SHAPES["train_4k"]) == pytest.approx(6 * cfg.param_count() * 4096 * 256, rel=1e-6)
    assert model_flops(cfg, SHAPES["decode_32k"]) == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)
    cfg = tget("deepseek-moe-16b")
    assert model_flops(cfg, SHAPES["train_4k"]) == pytest.approx(6 * cfg.active_param_count() * 4096 * 256, rel=1e-6)


# ---------------------------------------------------------------------------
# The collective counter on a fake 64-rank mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh64():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=64, timeout=timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (8, 8), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def _program(mesh):
    """Collectives of known shapes on meta tensors: DTensor redistributes
    (all-gather, reduce-scatter, all-reduce), a functional all-to-all and a
    ``torch.distributed`` all-reduce."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def dt(local, pl, shape):
        return DTensor.from_local(torch.empty(local, dtype=torch.bfloat16, device="meta"), mesh, pl,
                                  run_check=False, shape=shape, stride=torch.empty(shape, device="meta").stride())

    a = dt((4, 64), [Replicate(), Shard(0)], (32, 64))
    a.redistribute(mesh, [Replicate(), Replicate()])  # all-gather over model: 32·64·2 bytes out
    b = dt((32, 64), [Replicate(), Partial()], (32, 64))
    b.redistribute(mesh, [Replicate(), Shard(0)])  # reduce-scatter over model: 4·64·2 bytes out
    c = dt((16, 8), [Partial(), Replicate()], (16, 8))
    c.redistribute(mesh, [Replicate(), Replicate()])  # all-reduce over data: 16·8·2 bytes
    fc.all_to_all_single(torch.empty(16, 8, device="meta"), None, None, mesh.get_group(1))  # 16·8·4 bytes
    dist.all_reduce(torch.empty(10, device="meta"), group=mesh.get_group(0))  # 40 bytes


def test_collective_counter_bytes_are_the_ring_terms_and_counts_are_comm_debug_modes(mesh64):
    from torch.distributed.tensor.debug import CommDebugMode

    with CollectiveCounter(gpus_per_node=8) as cc:
        _program(mesh64)
    with CommDebugMode() as cdm:
        _program(mesh64)
    names = _op_table()
    want = Counter()
    for op, n in cdm.get_comm_counts().items():
        want[names[op]] += n
    st = cc.stats
    assert dict(st.count) == dict(want) == {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 2, "all-to-all": 1}
    ag, rs, ar1, ar2, a2a = 32 * 64 * 2, 4 * 64 * 2, 16 * 8 * 2, 40, 16 * 8 * 4
    assert st.result_bytes == {"all-gather": ag, "reduce-scatter": rs, "all-reduce": ar1 + ar2, "all-to-all": a2a}
    assert st.link_bytes["all-gather"] == ag * 7 / 8
    assert st.link_bytes["reduce-scatter"] == rs * 7
    assert st.link_bytes["all-reduce"] == 2 * ar1 * 7 / 8 + 2 * ar2 * 7 / 8
    assert st.link_bytes["all-to-all"] == a2a * 7 / 8
    # rank 0's model group (ranks 0-7) is one node; its data group (0, 8, ..., 56) spans eight
    assert dict(st.network_bytes) == {"all-reduce": st.link_bytes["all-reduce"]}
    assert st.total_link_bytes == sum(st.link_bytes.values())
    d = st.as_dict()
    assert {t["op"] for t in d["top"]} == set(st.count) and all(t["op_name"] for t in d["top"])
    assert any(t["op_name"].startswith("redistribute") for t in d["top"])
    json.dumps(d)


def test_collective_counter_counts_the_ops_dtensor_issues_inside_an_op(mesh64):
    """A matmul whose operands DTensor must move first: the counter sees the
    collectives DTensor issues while it dispatches the op, named by it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    def prog():
        # x's rows and w's rows both sharded over data: w must be gathered
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh64, [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh64, [Shard(0), Replicate()], run_check=False)
        return x @ w

    with CollectiveCounter() as cc:
        prog()
    with CommDebugMode() as cdm:
        prog()
    assert sum(cc.stats.count.values()) == cdm.get_total_counts() > 0
    assert any("aten." in t[4] for t in cc.stats.top)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def _records() -> list[dict]:
    def ok(arch, shape, mesh, flops, coll, terms, mfu, temp=3 * 2**30):
        c, m, k = terms
        return {
            "arch": arch, "shape": shape, "mesh": mesh, "status": "ok", "compile_s": 0.0,
            "cost_analysis": {"flops": flops, "bytes_accessed": 1.0},
            "memory_analysis": {"argument_bytes": 5 * 2**30, "temp_bytes": temp},
            "collectives": {"count": coll},
            "roofline": {"compute_s": c, "memory_s": m, "collective_s": k,
                         "dominant": max(("compute", c), ("memory", m), ("collective", k), key=lambda x: x[1])[0],
                         "bound_s": max(c, m, k), "useful_flops_fraction": 0.75, "mfu_bound": mfu},
        }

    return [
        ok("llama3.2-3b", "decode_32k", "pod1", 9.34e10, {"all-gather": 199, "reduce-scatter": 56}, (0.003, 0.2, 0.58), 0.0004),
        ok("llama3.2-3b", "train_4k", "pod1", 4.98e14, {"all-reduce": 542, "all-gather": 627}, (120.5, 0.01, 6.1), 0.0131),
        ok("llama3.2-3b", "train_4k", "pod2", 2.49e14, {}, (0.0, 1.5, 0.0), 0.2),
        {"arch": "llama3.2-3b", "shape": "long_500k", "mesh": "pod1", "status": "skipped",
         "reason": "pure full-attention arch: 500k decode is quadratic-cost (assignment: skip)"},
        ok("granite-moe-1b-a400m", "prefill_32k", "pod1", 1.2e13, {"all-to-all": 3}, (0.5, 0.25, 0.125), 0.6),
    ]


def test_report_tables_equal_the_references_on_the_same_records(tmp_path):
    recs = _records()
    for i, r in enumerate(reversed(recs)):  # load sorts them
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    tl, jl = treport.load(tmp_path), jreport.load(tmp_path)
    assert tl == jl and [r["shape"] for r in tl if r["arch"] == "llama3.2-3b"] == [
        "train_4k", "train_4k", "decode_32k", "long_500k"]
    assert treport.dryrun_table(tl) == jreport.dryrun_table(jl)
    for mesh in ("pod1", "pod2"):
        assert treport.roofline_table(tl, mesh) == jreport.roofline_table(jl, mesh)
    assert treport.interesting_cells(tl) == jreport.interesting_cells(jl)
    for x in (0, 0.000123, 0.5, 1, 3.14159, 99.9, 100, 12345.6):
        assert treport._f(x) == jreport._f(x)


def test_report_renders_the_ports_null_temp_bytes_and_errors(tmp_path, capsys, monkeypatch):
    recs = _records()
    recs[0]["memory_analysis"]["temp_bytes"] = None
    recs.append({"arch": "xlstm-125m", "shape": "train_4k", "mesh": "pod1", "status": "error",
                 "error": "RuntimeError: a propagation rule refused"})
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    table = treport.dryrun_table(treport.load(tmp_path))
    assert "| 5.0 | n/a | all-gather:199, reduce-scatter:56 |" in table
    assert "| xlstm-125m | train_4k | pod1 | ERROR (RuntimeError: a propagation rule refused…) |" in table
    monkeypatch.setattr("sys.argv", ["report", str(tmp_path)])
    treport.main()
    out = capsys.readouterr().out
    assert out.startswith("## Dry-run: 4 stepped, 1 documented skips, 1 errors")
    assert "## Roofline (single-pod 16×16, per step)" in out
