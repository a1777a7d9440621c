"""The port's dry-run (``repro_torch.launch.dryrun``) and its input specs.

``input_specs``, ``make_batch_specs`` and the ``abstract_*`` trees are held
to the reference's ``jax.ShapeDtypeStruct`` trees: the same leaves, shapes
and dtypes (a stacked layer of the reference is the port's unstacked
layers, named by the reference's path as ``tests/test_torch_sharding.py``
names them), every leaf a ``meta`` tensor.

``count_cell`` runs in this process on small meshes of a ``"fake"`` process
group, which it makes and destroys: on one rank the local and global counts
are the plain path's, on a 2 × 2 mesh the global count is the unsharded
program's (no op is counted at two levels), and the sLSTM scaling equals
running every step.  ``run_cell`` on the production meshes and the CLI run in
a subprocess: llama3.2-3b's ``train_4k`` counts, baseline and ``opt``, are
held to the reference's unrolled compile (3.0368e16, the calibration of
``tests/test_roofline.py``) within 15 % and to each other within 1 %.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.data.pipeline import make_batch_specs as jmake_batch_specs
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro_torch._bridge import tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as S
from repro_torch.models import Model

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(jdt) -> torch.dtype:
    return {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}[np.dtype(jdt).name]


def _jflat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsh._path_str(p): leaf for p, leaf in flat}


def _held(cfg, jtree, ttree, layer_keys):
    """Every leaf of the port's tree has the reference's shape (a stacked
    layer's inner shape) and dtype at its path, every reference path is
    reached, and every port leaf is a meta tensor."""
    jflat = _jflat(jtree)
    seen = set()
    for path, leaf in tsh._reference_paths(ttree, cfg, layer_keys):
        want = jflat[path]
        shape = tuple(want.shape)[1:] if "/body/" in f"/{path}/" else tuple(want.shape)
        assert tuple(leaf.shape) == shape, path
        assert leaf.dtype == _dtype(want.dtype), path
        assert leaf.device.type == "meta", path
        seen.add(path)
    assert seen == set(jflat)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch):
    for name, shape in SHAPES.items():
        want = jsteps.input_specs(jget(arch), JSHAPES[name])
        got = S.input_specs(tget(arch), shape)
        assert set(got) == set(want), name
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape) and v.dtype == _dtype(want[k].dtype), (name, k)
            assert v.device.type == "meta"


def test_make_batch_specs_equal_the_reference():
    for vocab, seq, batch in ((512, 16, 4), (128256, 4096, 256)):
        want, got = jmake_batch_specs(vocab, seq, batch), make_batch_specs(vocab, seq, batch)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape) and got[k].dtype == torch.int32
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_and_opt_state_equal_the_reference(arch):
    """``Model.init`` run with its factories on meta: the reference's tree,
    nothing allocated (qwen1.5-110b alone is 222 GB)."""
    cfg = tget(arch)
    jm = JModel(jget(arch))
    jparams = jsteps.abstract_params(jm)
    params = S.abstract_params(Model(cfg, "meta"))
    _held(cfg, jparams, params, {"layers": "decoder", "enc_layers": "encoder"})
    jopt, opt = jsteps.abstract_opt_state(jparams), S.abstract_opt_state(params)
    assert opt.step.shape == () and opt.step.dtype == _dtype(jopt.step.dtype) and opt.step.device.type == "meta"
    for jt, tt in ((jopt.m, opt.m), (jopt.v, opt.v)):
        _held(cfg, jt, tt, {"layers": "decoder", "enc_layers": "encoder"})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_cache_equals_the_reference(arch):
    cfg = tget(arch)
    jm = JModel(jget(arch))
    for batch, max_len in ((128, 32768), (1, 524288)):
        jc = jsteps.abstract_cache(jm, batch, max_len)
        tc = S.abstract_cache(Model(cfg, "meta"), batch, max_len)
        _held(cfg, jc, tc, {"layers": "decoder"})


# ---------------------------------------------------------------------------
# count_cell on small meshes, in this process
# ---------------------------------------------------------------------------


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def _plain_count(cfg, shape):
    """The step on plain meta tensors, counted off any mesh."""
    from repro_torch.models import layers
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline.counting import count_step

    model = Model(cfg, "meta")
    params = S.abstract_params(model)
    batch = S.input_specs(cfg, shape)
    prev = layers.get_attn_impl()
    layers.set_attn_impl("plain")
    try:
        cache = S.abstract_cache(model, shape.global_batch, shape.seq_len)
        if shape.kind == "train":
            fn, args = S.make_train_step(model, AdamWConfig()), (params, S.abstract_opt_state(params), batch)
        elif shape.kind == "prefill":
            fn, args = S.make_prefill_step(model), (params, batch, cache)
        else:
            fn, args = S.make_serve_step(model), (params, cache, batch["tokens"])
        with count_step() as cost:
            fn(*args)
    finally:
        layers.set_attn_impl(prev)
    return cost


def _no_group_left():
    import torch.distributed as dist

    from repro_torch.models.hints import get_hints

    assert not dist.is_initialized() and get_hints() is None


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_counts_equal_the_plain_path(kind):
    """On a 1 × 1 mesh the local and the global count are both the count of
    the same step on plain tensors: what the card's plain path runs."""
    cfg, shape = _bf16(tget("llama3.2-3b", smoke=True)), Shape("s", kind, 32, 4)
    rec, stats = dryrun.count_cell(cfg, shape, (1, 1), ("data", "model"), device="cpu")
    _no_group_left()
    plain = _plain_count(cfg, shape)
    c = rec["cost_analysis"]
    assert c["flops"] == c["flops_global"] == plain.flops > 0
    assert rec["chips"] == 1 and stats.total_link_bytes == 0


@pytest.mark.parametrize("variant", ["baseline", "opt"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b"])
def test_global_count_on_a_mesh_is_the_unsharded_programs(arch, variant):
    """On a 2 × 2 mesh each op is counted once: the global count equals the
    plain path's count of the same step at the same global shapes, baseline
    and hinted, while each rank runs at least a quarter of it."""
    cfg, shape = _bf16(tget(arch, smoke=True)), Shape("s", "train", 32, 4)
    rec, stats = dryrun.count_cell(cfg, shape, (2, 2), ("data", "model"), variant=variant, device="cpu")
    _no_group_left()
    c = rec["cost_analysis"]
    assert c["flops_global"] == pytest.approx(_plain_count(cfg, shape).flops, rel=1e-12)
    assert c["flops"] * 4 >= c["flops_global"] * (1 - 1e-12)
    assert stats.total_link_bytes > 0 and rec["slstm_steps_scaled"] is None


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_scaling_equals_running_every_step(kind):
    cfg, shape = _bf16(tget("xlstm-125m", smoke=True)), Shape("s", kind, 8, 4)
    full, fs = dryrun.count_cell(cfg, shape, (2, 2), ("data", "model"), device="cpu", slstm_scaling=False)
    scaled, ss = dryrun.count_cell(cfg, shape, (2, 2), ("data", "model"), device="cpu")
    _no_group_left()
    assert full["slstm_steps_scaled"] is None
    assert scaled["slstm_steps_scaled"] == {"steps": 8, "counted_at": [2, 3], "layers": 1}
    for k in ("flops", "flops_global", "bytes_accessed", "ops"):
        assert scaled["cost_analysis"][k] == pytest.approx(full["cost_analysis"][k], rel=1e-12), k
    assert dict(ss.count) == dict(fs.count)
    assert ss.total_link_bytes == pytest.approx(fs.total_link_bytes, rel=1e-12)


def test_count_cell_refuses_a_live_group_and_cleans_up_after_an_error():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.count_cell(tget("llama3.2-3b", smoke=True), Shape("s", "decode", 8, 2), (1, 2), ("data", "model"),
                              device="cpu")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="same length"):  # a bad mesh: the group goes anyway
        dryrun.count_cell(tget("llama3.2-3b", smoke=True), Shape("s", "decode", 8, 2), (2, 2), ("data",),
                          device="cpu")
    _no_group_left()


# ---------------------------------------------------------------------------
# run_cell on the production meshes and the CLI, in a subprocess
# ---------------------------------------------------------------------------

_CELLS = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.dryrun import run_cell
out = {}
for arch, shape, mesh, variant in json.loads(sys.argv[1]):
    out[f"{arch} {shape} {mesh} {variant}"] = run_cell(arch, shape, mesh, variant=variant, device="cpu")
    assert not dist.is_initialized()
print(json.dumps(out))
"""

CELLS = [
    ("llama3.2-3b", "decode_32k", "pod1", "baseline"),
    ("llama3.2-3b", "decode_32k", "pod1", "opt"),
    ("llama3.2-3b", "train_4k", "pod1", "baseline"),
    ("llama3.2-3b", "train_4k", "pod1", "opt"),
    ("llama3.2-3b", "long_500k", "pod1", "baseline"),
    ("gemma2-27b", "train_4k", "pod1", "opt"),
]


@pytest.fixture(scope="module")
def cells():
    out = subprocess.run([sys.executable, "-c", _CELLS, json.dumps(CELLS)], capture_output=True, text=True,
                         timeout=900, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_llama_train_counts_the_references_unrolled_compile_at_one_level(cells):
    base, opt = cells["llama3.2-3b train_4k pod1 baseline"], cells["llama3.2-3b train_4k pod1 opt"]
    for r in (base, opt):
        assert r["status"] == "ok" and r["chips"] == 256 and r["compile_s"] == 0.0
    g = base["cost_analysis"]["flops_global"]
    assert abs(g - 3.0368e16) / 3.0368e16 < 0.15
    assert opt["cost_analysis"]["flops_global"] == pytest.approx(g, rel=0.01)
    # each rank runs at least its 1/256; the baseline repeats its attention on every model rank
    for r in (base, opt):
        assert r["cost_analysis"]["flops"] * 256 >= r["cost_analysis"]["flops_global"]
    assert base["cost_analysis"]["flops"] > opt["cost_analysis"]["flops"]


def test_a_record_has_the_references_keys_and_the_rooflines_terms(cells):
    r = cells["llama3.2-3b train_4k pod1 baseline"]
    ref_keys = {"variant", "arch", "shape", "mesh", "kind", "chips", "params", "params_active", "lower_s",
                "compile_s", "cost_analysis", "memory_analysis", "collectives", "hlo_bytes", "analytic",
                "roofline", "status", "total_s"}
    assert ref_keys <= set(r)
    assert {"flops", "bytes_accessed", "utilization_ops"} <= set(r["cost_analysis"])
    m = r["memory_analysis"]
    assert m["temp_bytes"] is None and m["generated_code_bytes"] is None and m["null_reason"]
    assert 0 < m["argument_bytes"] and 0 < m["output_bytes"]
    assert r["params"] == tget("llama3.2-3b").param_count()
    rl = r["roofline"]
    assert rl["sku"] == "H100 SXM" and rl["bound_s"] == max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    assert rl["flops_per_device"] == pytest.approx(r["analytic"]["flops_global"] / 256)
    coll = r["collectives"]
    assert set(coll["count"]) <= {"all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute"}
    assert rl["link_bytes_per_device"] == pytest.approx(coll["total_link_bytes"])
    # a 16-wide model axis spans two 8-card nodes: every group crosses the network
    assert coll["total_network_bytes"] == pytest.approx(coll["total_link_bytes"])


def test_decode_cells_and_the_skipped_long_context(cells):
    for v in ("baseline", "opt"):
        r = cells[f"llama3.2-3b decode_32k pod1 {v}"]
        assert r["status"] == "ok" and r["kind"] == "decode"
        assert r["cost_analysis"]["flops_global"] == pytest.approx(r["analytic"]["flops_global"], rel=0.05)
    skip = cells["llama3.2-3b long_500k pod1 baseline"]
    assert skip == {"arch": "llama3.2-3b", "shape": "long_500k", "mesh": "pod1", "status": "skipped",
                    "reason": "pure full-attention arch: 500k decode is quadratic-cost (assignment: skip)"}


def test_hinted_gemma2_trains_on_the_production_mesh(cells):
    """At production sizes, H1's backward handed a matmul's reshape a
    gradient whose local shard is not contiguous (``hints.pin`` makes it
    so); each rank runs its share of the work and no more."""
    r = cells["gemma2-27b train_4k pod1 opt"]
    assert r["status"] == "ok"
    c = r["cost_analysis"]
    assert c["flops"] * 256 == pytest.approx(c["flops_global"], rel=1e-3)
    assert abs(c["flops_global"] / r["analytic"]["flops_global"] - 1) < 0.15


def test_pin_hands_back_a_contiguous_local_gradient(mesh11):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.hints import pin

    x = DTensor.from_local(torch.randn(4, 6), mesh11, [Shard(0), Replicate()]).requires_grad_()
    g = torch.randn(6, 4).t()  # not contiguous
    pin(x).backward(DTensor.from_local(g, mesh11, [Shard(0), Replicate()]))
    assert x.grad.to_local().is_contiguous() and torch.equal(x.grad.to_local(), g)


def test_cli_single_cell_writes_its_record(tmp_path):
    out = tmp_path / "cell.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-moe-1b-a400m", "--shape",
         "decode_32k", "--mesh", "pod1", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
    )
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["arch"] == "granite-moe-1b-a400m" and rec["device"] == "cpu"
    assert json.loads(run.stdout[run.stdout.index("{"):]) == rec


def test_import_sets_nothing():
    code = ("import os, torch.distributed as dist, repro_torch.launch.dryrun, repro_torch.roofline.report, "
            "repro_torch.roofline.counting; print(dist.is_initialized(), 'XLA_FLAGS' in os.environ)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.split() == ["False", "False"], out.stderr


# ---------------------------------------------------------------------------
# The model's DTensor paths that the dry-run takes, with real values
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh11():
    """A one-rank gloo group from a ``HashStore`` and a 1 × 1 cpu mesh,
    destroyed afterwards: every DTensor path runs, on real values."""
    import torch.distributed as dist
    from datetime import timedelta

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("optimized", [False, True], ids=["baseline", "opt"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "xlstm-125m", "jamba-v0.1-52b"])
def test_serving_on_dtensors_equals_plain_tensors(arch, optimized, mesh11):
    """Prefill and two decode steps with params and cache placed as
    DTensors (the optimized cache spec shards the sequence: the cache write
    gathers and re-places it) equal the plain run, greedy step for step."""
    from repro_torch.launch.sharding import batch_specs, cache_specs, distribute_params, param_specs
    from repro_torch.models.hints import ShardHints, set_hints

    cfg = tget(arch, smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    prefill, serve = S.make_prefill_step(model), S.make_serve_step(model)

    def run(p, cache, batch):
        tok, cache = prefill(p, batch, cache)
        toks = [tok]
        tok = tok[:, None]
        for _ in range(2):
            tok, cache = serve(p, cache, tok)
            toks.append(tok[:, 0])
        return torch.stack([t.full_tensor() if hasattr(t, "full_tensor") else t for t in toks], 1)

    want = run(params, model.init_cache(2, 16), {"tokens": prompts})
    placed = distribute_params(params, param_specs(cfg, params, mesh11), mesh11)
    cache = model.init_cache(2, 16)
    specs = cache_specs(cfg, cache, mesh11, optimized=optimized)
    cache = {**cache, "layers": distribute_params(cache["layers"], specs["layers"], mesh11)}
    set_hints(ShardHints(mesh=mesh11, dp_axes=("data",)) if optimized else None)
    try:
        got = run(placed, cache, distribute_params({"tokens": prompts}, batch_specs(cfg, {"tokens": prompts}, mesh11),
                                                   mesh11))
    finally:
        set_hints(None)
    assert torch.equal(got, want)


def test_xlstm_loss_and_grads_on_dtensors_equal_plain_tensors(mesh11):
    """The mLSTM chunk on each rank's batch rows, its log-sigmoid on shards
    and the fresh recurrent states placed on the mesh give the plain run's
    loss and grads."""
    from repro_torch.launch.sharding import batch_specs, distribute_params, param_specs

    cfg = dataclasses.replace(tget("xlstm-125m", smoke=True), remat=True)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (loss, _), grads = S.value_and_grad(model, params, batch)
    placed = distribute_params(params, param_specs(cfg, params, mesh11), mesh11)
    pbatch = distribute_params(batch, batch_specs(cfg, batch, mesh11), mesh11)
    (dloss, _), dgrads = S.value_and_grad(model, placed, pbatch)
    assert float(dloss.full_tensor()) == pytest.approx(float(loss), rel=1e-6)
    for g, d in zip(tree_leaves(grads), tree_leaves(dgrads), strict=True):
        torch.testing.assert_close(d.full_tensor(), g, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_phase_15_r_train_and_dry_cells_rehearsed(monkeypatch):
    """``chip_smoke.r_train`` on the CPU at llama's smoke widths (bf16, remat,
    2 × 16 tokens) with the switch forced to the kernel path unless it is
    ``"plain"`` (each wrapper's plain stand-in counts as the card's launch;
    the plain count takes the plain path): its launches equal
    ``train_launches``, it measures above its bound, and the plain path's
    FLOPs equal the 1 × 1 meta dry-run's (the phase raises otherwise).  Then
    ``dry_cell`` holds a decode cell and the skipped one on a cpu mesh."""
    import functools

    import repro_torch.configs as tconfigs
    from repro_torch.kernels import ops as kops
    from test_torch_families import _chip_smoke

    cs = _chip_smoke()
    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config",
                        lambda arch, smoke=False: dataclasses.replace(real(arch, smoke=True), dtype="bfloat16",
                                                                      remat=True))
    monkeypatch.setattr(cs, "R_BATCH", 2)
    monkeypatch.setattr(cs, "R_SEQ", 16)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    monkeypatch.setattr(kops, "use_kernel", lambda x: kops.get_attn_impl() != "plain")
    out = cs.r_train(torch, "cpu rehearsal", "H100 SXM", device="cpu")
    assert out["launches"] == {"rmsnorm": 9, "flash_attention": 4}
    assert out["flops_plain"] == out["flops_dryrun"] > 0 and out["ratio"] >= cs.R_FLOOR
    _no_group_left()

    run_cell = functools.partial(dryrun.run_cell, device="cpu")
    monkeypatch.setattr(tconfigs, "get_config", real)
    rec = cs.dry_cell(run_cell, ("llama3.2-3b", "decode_32k", "pod1", "baseline"))
    assert rec["status"] == "ok"
    assert cs.dry_cell(run_cell, ("llama3.2-3b", "long_500k", "pod1", "baseline"))["status"] == "skipped"
    _no_group_left()
