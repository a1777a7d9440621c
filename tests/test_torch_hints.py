"""The port's distribution hints (``repro_torch.models.hints``: H1 attention,
H2 expert-local MoE, H4 the sequence-parallel residual) against the
reference's, on real meshes.

The inputs are ``tests/test_hints.py``'s two MoE configs and a dense GQA
config, fp32, 2 × 16 tokens, with the reference's own init carried across.
Loss and aux are held within 1e-5 and every grad leaf within 1e-4, the
tolerances of ``tests/test_hints.py``.

* **1 × 1**, in this process: a one-rank gloo group from a ``HashStore``.
  The port's hinted run (params placed as DTensors by ``param_specs``)
  against its unhinted run on plain tensors and against the reference's
  hinted run on a mesh with ``AxisType.Auto`` axes (jax 0.9's default
  ``Explicit`` axes refuse the reference's sharding constraints: ROADMAP
  queue C), remat off and on.
* **2 × 2 and 1 × 4**, in 4 spawned processes on gloo:
  ``tests/test_torch_hints_mesh.py``, on this file's configs and helpers.
* Phase 14 of ``chip_smoke.py`` rehearsed on the CPU with the kernel path
  patched in: its launch counts, hinted and not, equal
  ``chip_smoke.dist_launches``.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import Model as JModel
from repro.models import ModelConfig as JConfig
from repro.models import MoECfg as JMoE
from repro.models import hints as jhints
from repro_torch._bridge import to_numpy, tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import batch_specs, distribute_params, param_specs
from repro_torch.models import Model, ModelConfig, MoECfg, params_from_jax, params_to_jax
from repro_torch.models.hints import ShardHints, get_hints, set_hints
from test_torch_families import _chip_smoke

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_hints.py

# name → (ModelConfig kwargs, MoECfg kwargs or None)
CASES = {
    "moe-shared": (dict(name="hinted", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=0, vocab=128,
                        dtype="float32", remat=False, pattern=(("attn", "moe"),)),
                   dict(n_experts=4, top_k=2, d_expert=16, n_shared=1, capacity_factor=4.0)),
    "moe-top1": (dict(name="hinted-g", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0, vocab=128,
                      dtype="float32", remat=False, pattern=(("attn", "moe"),)),
                 dict(n_experts=2, top_k=1, d_expert=16, capacity_factor=4.0)),
    "dense-gqa": (dict(name="gqa", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                       dtype="float32", remat=False), None),
}
REMATS = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name: str, remat: bool):
    kw, moe = CASES[name]
    kw = dict(kw, remat=remat)
    if moe is None:
        return JConfig(**kw), ModelConfig(**kw)
    return JConfig(**kw, moe=JMoE(**moe)), ModelConfig(**kw, moe=MoECfg(**moe))


@pytest.fixture(scope="module")
def inputs():
    """name → (the reference's params as numpy, tokens [2, 16]), as
    ``tests/test_hints.py`` makes them."""
    out = {}
    for name in CASES:
        jcfg, _ = _cfgs(name, False)
        params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(0)))
        tokens = np.asarray(jax.random.randint(jax.random.key(1), (2, 16), 0, jcfg.vocab))
        out[name] = (params, tokens)
    return out


def _port_fwdbwd(model, params, batch):
    """``(loss, aux, grads in the reference's layout and leaf order)``."""
    leaves = tree_leaves(params)
    loss, met = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    full = [g.full_tensor() if hasattr(g, "full_tensor") else g for g in grads]
    loss, aux = (t.full_tensor() if hasattr(t, "full_tensor") else t for t in (loss, met["aux"]))
    grads = tree_leaves(params_to_jax(tree_unflatten(params, full), model.cfg))
    return float(loss.detach()), float(aux.detach()), [to_numpy(g) for g in grads]


def _unsharded(name: str, remat: bool, inputs):
    _, cfg = _cfgs(name, remat)
    params, tokens = inputs[name]
    p = tree_map(lambda t: t.requires_grad_(), params_from_jax(params, cfg, "cpu"))
    t = torch.tensor(tokens)
    return _port_fwdbwd(Model(cfg, "cpu"), p, {"tokens": t, "labels": t})


def _held(got, want, what):
    (l1, a1, g1), (l0, a0, g0) = got, want
    assert abs(l1 - l0) < LOSS_TOL, (what, l1, l0)
    assert abs(a1 - a0) < LOSS_TOL, (what, a1, a0)
    assert len(g1) == len(g0)
    worst = max(float(np.max(np.abs(a - b))) for a, b in zip(g1, g0))
    assert worst < GRAD_TOL, (what, worst)


# -- 1 × 1, in this process ---------------------------------------------------------


@pytest.fixture
def unit_mesh():
    """A one-rank gloo group from an in-process store, and its 1 × 1 mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        set_hints(None)
        dist.destroy_process_group()


def _reference_hinted_1x1(name: str, remat: bool, inputs):
    from jax.sharding import AxisType

    jcfg, _ = _cfgs(name, remat)
    params, tokens = inputs[name]
    m = JModel(jcfg)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jhints.set_hints(jhints.ShardHints(mesh=mesh, dp_axes=("data",)))
    try:
        with mesh:
            (loss, met), grads = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(
                jax.tree.map(jnp.asarray, params), batch)
    finally:
        jhints.set_hints(None)
    return float(loss), float(met["aux"]), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("remat", REMATS, ids=["remat-off", "remat-on"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_hinted_on_a_unit_mesh_matches_unhinted_and_the_reference(name, remat, inputs, unit_mesh):
    _, cfg = _cfgs(name, remat)
    params, tokens = inputs[name]
    model = Model(cfg, "cpu")
    plain = _unsharded(name, remat, inputs)
    placed = params_from_jax(params, cfg, "cpu")
    placed = distribute_params(tree_map(lambda t: t.requires_grad_(), placed),
                               param_specs(cfg, placed, unit_mesh), unit_mesh)
    t = torch.tensor(tokens)
    batch = {"tokens": t, "labels": t}
    batch = distribute_params(batch, batch_specs(cfg, batch, unit_mesh), unit_mesh)
    set_hints(ShardHints(mesh=unit_mesh, dp_axes=("data",)))
    try:
        hinted = _port_fwdbwd(model, placed, batch)
    finally:
        set_hints(None)
    ref = _reference_hinted_1x1(name, remat, inputs)
    _held(hinted, plain, "port hinted vs unhinted")
    _held(hinted, ref, "port hinted vs reference hinted")
    _held(plain, ref, "port unhinted vs reference hinted")


def test_hints_refuse_plain_tensors_and_dtensors_never_reach_a_kernel(unit_mesh):
    """Under hints a plain tensor raises (nothing is converted silently), and
    a DTensor handed to a kernel wrapper raises: it takes local shards."""
    from repro_torch.models.hints import constrain

    _, cfg = _cfgs("dense-gqa", False)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    t = torch.zeros((2, 16), dtype=torch.int64)
    set_hints(ShardHints(mesh=unit_mesh, dp_axes=("data",)))
    try:
        with pytest.raises(TypeError, match="plain tensor"):
            constrain(torch.zeros(2, 16, 8), "data", "model", None)
        with pytest.raises((TypeError, RuntimeError)):
            model.loss(params, {"tokens": t, "labels": t})
    finally:
        set_hints(None)
    from torch.distributed.tensor import Replicate, distribute_tensor

    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.ones(4, cfg.d_model), unit_mesh, rep)
    with pytest.raises(TypeError, match="DTensor reached a kernel"):
        kops.rmsnorm(x, distribute_tensor(torch.zeros(cfg.d_model), unit_mesh, rep))
    q = distribute_tensor(torch.ones(1, 4, 2, 64), unit_mesh, rep)
    with pytest.raises(TypeError, match="DTensor reached a kernel"):
        kops.flash_attention(q, q, q)
    assert get_hints() is None


# -- phase 14 of chip_smoke.py, rehearsed --------------------------------------------------


def test_phase_14_launches_rehearsed_on_the_kernel_path(monkeypatch):
    """``chip_smoke.phase_distribution`` on the CPU (gloo, a 1 × 1 mesh) with
    each D cell's arch at its smoke widths and depth, 2 × 16 tokens, and the
    switch forced to the kernel path: each wrapper's plain stand-in counts as
    the card's launch.  The phase's own checks run (it raises on a
    failure): hinted and unhinted counts equal ``chip_smoke.dist_launches``
    of each mode (H2 takes no slot kernel), H1 is taken and H2 for granite, hinted
    equals unhinted, params and grads are placed as the specs, and the
    ZeRO-1 AdamW step equals the unsharded one."""
    import repro_torch.configs as tconfigs

    cs = _chip_smoke()
    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config", lambda arch, smoke=False: real(arch, smoke=True))
    monkeypatch.setattr(cs, "DIST_BATCH", 2)
    monkeypatch.setattr(cs, "DIST_SEQ", 16)

    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    out = cs.phase_distribution(torch, "cpu rehearsal", "H100 SXM", device="cpu")
    assert not dist.is_initialized()
    for cell, (arch, depth) in cs.DIST_CELLS.items():
        cfg = dataclasses.replace(real(arch, smoke=True), n_layers=depth, remat=True)
        want = cs.dist_launches(cfg, hinted=False)
        assert out[cell]["launches"] == {"unhinted": want, "hinted": cs.dist_launches(cfg, hinted=True)}, (
            cell, out[cell]["launches"])
        assert want.get("moe_slots", 0) == (2 * depth if cell == "D-granite" else 0)
        assert want["rmsnorm"] == 2 * (2 * depth + 1) - 1 and want["flash_attention"] == 2 * depth
        assert out[cell]["branches_hinted"]["H1"] == 2 * depth
        assert out[cell]["branches_hinted"]["H2"] == (2 * depth if cell == "D-granite" else 0)
