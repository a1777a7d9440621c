"""The port's distribution hints on real meshes: 2 × 2 and 1 × 4, in 4
spawned processes on gloo (a ``file://`` store, no ports).

The port's hinted and unhinted runs on DTensors placed by ``param_specs``
are held against the reference's hinted run on the same mesh shape (a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, on
a mesh with ``AxisType.Auto`` axes) and against the port's own unsharded
run, for ``tests/test_torch_hints.py``'s configs, remat off and on: loss
and aux within 1e-5, every grad leaf within 1e-4.  The 1 × 4 mesh takes
H1's sequence-parallel branch (Hkv 2 does not divide TP 4), H2 and H4's
``reduce_scatter``; one AdamW step with ``zero1_specs`` moments equals the
unsharded step.  Each mesh shape is one spawn, with the reference's
subprocess beside it, under a time limit; every process destroys its
process group.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from test_torch_hints import CASES, GRAD_TOL, REMATS, _held, _unsharded, inputs  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240  # seconds for a mesh's spawn and its reference subprocess


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WORKER = textwrap.dedent('''
    import pickle, sys
    from datetime import timedelta
    import torch, torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    torch.set_num_threads(1)
    rank, world, store, inp, out, shape = sys.argv[1:7]
    rank, world = int(rank), int(world)
    shape = tuple(int(s) for s in shape.split("x"))
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        from repro_torch._bridge import to_numpy, tree_leaves, tree_map, tree_unflatten
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.sharding import batch_specs, distribute_params, param_specs, redistribute_like
        from repro_torch.models import Model, ModelConfig, MoECfg, layers, moe, params_from_jax, params_to_jax
        from repro_torch.models.hints import ShardHints, set_hints
        from repro_torch.optim import adamw, zero1_specs

        cases = pickle.load(open(inp, "rb"))
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        counts = {}
        wrapped = (layers, "sdpa_on_shards"), (moe, "apply_moe_sharded"), (dnn, "reduce_scatter")

        def counting(mod, fn):
            orig = getattr(mod, fn)
            def call(*a, **k):
                if fn == "sdpa_on_shards":  # (h, q_spec, ...): q sharded along the sequence?
                    key = "H1 seq" if a[1][1] == a[0].tp_axis else "H1 head"
                    counts[key] = counts.get(key, 0) + 1
                else:
                    counts[fn] = counts.get(fn, 0) + 1
                return orig(*a, **k)
            setattr(mod, fn, call)

        for mod, fn in wrapped:
            counting(mod, fn)

        def fwdbwd(model, params, batch):
            leaves = tree_leaves(params)
            loss, met = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss, met["aux"], list(grads)

        res = {"branches": {}, "runs": {}, "placed_ok": True}
        for name, (kw, moe_kw, params, tokens) in cases.items():
            for remat in (False, True):
                cfg = ModelConfig(**dict(kw, remat=remat), **({"moe": MoECfg(**moe_kw)} if moe_kw else {}))
                model = Model(cfg, "cpu")
                base = params_from_jax(params, cfg, "cpu")
                specs = param_specs(cfg, base, mesh)
                placed = distribute_params(tree_map(lambda t: t.requires_grad_(), base), specs, mesh)
                res["placed_ok"] &= all(torch.equal(p.full_tensor(), b) for p, b in
                                        zip(tree_leaves(placed), tree_leaves(base)))
                t = torch.tensor(tokens)
                batch = {"tokens": t, "labels": t}
                batch = distribute_params(batch, batch_specs(cfg, batch, mesh), mesh)
                for hinted in (False, True):
                    counts.clear()
                    set_hints(ShardHints(mesh=mesh, dp_axes=("data",)) if hinted else None)
                    try:
                        loss, aux, grads = fwdbwd(model, placed, batch)
                    finally:
                        set_hints(None)
                    full = [g.full_tensor() for g in grads]
                    ref = params_to_jax(tree_unflatten(base, full), cfg)
                    res["runs"][(name, remat, hinted)] = (
                        float(loss.full_tensor()), float(aux.full_tensor()),
                        [to_numpy(g) for g in tree_leaves(ref)])
                    res["branches"][(name, remat, hinted)] = dict(counts)
                    if name == "moe-shared" and not remat and hinted:
                        # One AdamW step: moments placed by zero1_specs, against the unsharded step.
                        ocfg = adamw.AdamWConfig(warmup_steps=0)
                        plain_base = tree_map(lambda t: t.detach(), base)
                        with torch.no_grad():
                            g0 = tree_unflatten(base, full)
                            new0, _, _ = adamw.update(ocfg, g0, adamw.init(plain_base), plain_base)
                            zs = zero1_specs(specs, base, data_size=shape[0])
                            mom = adamw.init(plain_base)
                            state = adamw.AdamWState(step=mom.step, m=distribute_params(mom.m, zs, mesh),
                                                     v=distribute_params(mom.v, zs, mesh))
                            g1 = redistribute_like(tree_unflatten(placed, grads), placed)
                            new1, st1, _ = adamw.update(ocfg, g1, state, placed)
                            res["adamw"] = {
                                "max_abs_err": max(float((a.full_tensor() - b).abs().max())
                                                   for a, b in zip(tree_leaves(new1), tree_leaves(new0))),
                                "params_placed": all(a.placements == b.placements for a, b in
                                                     zip(tree_leaves(new1), tree_leaves(placed))),
                                "grads_placed": all(a.placements == b.placements for a, b in
                                                    zip(tree_leaves(g1), tree_leaves(placed))),
                                "moments_placed": all(a.placements == b.placements for a, b in
                                                      zip(tree_leaves(st1.m), tree_leaves(state.m))),
                                "moments_sharded_over_data": sum(
                                    any(p.is_shard() for p in m.placements[:1]) for m in tree_leaves(st1.m)),
                            }
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')

_REFERENCE = textwrap.dedent('''
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.models import Model, ModelConfig, MoECfg
    from repro.models.hints import ShardHints, set_hints

    inp, out, shape = sys.argv[1:4]
    shape = tuple(int(s) for s in shape.split("x"))
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:n])
    res = {}
    for name, (kw, moe_kw, params, tokens) in pickle.load(open(inp, "rb")).items():
        for remat in (False, True):
            cfg = ModelConfig(**dict(kw, remat=remat), **({"moe": MoECfg(**moe_kw)} if moe_kw else {}))
            m = Model(cfg)
            batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
            set_hints(ShardHints(mesh=mesh, dp_axes=("data",)))
            try:
                with mesh:
                    (loss, met), grads = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(
                        jax.tree.map(jnp.asarray, params), batch)
            finally:
                set_hints(None)
            res[(name, remat)] = (float(loss), float(met["aux"]), [np.asarray(g) for g in jax.tree.leaves(grads)])
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')

_RUNS: dict = {}


def _run_mesh(shape: tuple[int, int], inputs, tmp: Path) -> tuple[dict, dict]:
    """``(the port's results, the reference's)`` on a mesh of ``shape``: 4
    gloo workers and the reference's subprocess at once, each under
    SPAWN_TIMEOUT; cached for the module."""
    if shape in _RUNS:
        return _RUNS[shape]
    tag = f"{shape[0]}x{shape[1]}"
    world = shape[0] * shape[1]
    inp = tmp / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump({name: (*CASES[name], *inputs[name]) for name in CASES}, f)
    (tmp / "worker.py").write_text(_WORKER)
    (tmp / "reference.py").write_text(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")  # the ranks meet on the loopback
    procs = [subprocess.Popen([sys.executable, str(tmp / "reference.py"), str(inp), str(tmp / "ref.pkl"), tag],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), str(world), str(tmp / "store"),
                                str(inp), str(tmp / "port.pkl"), tag],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(i, p.returncode, log[-3000:]) for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, failed
    with open(tmp / "port.pkl", "rb") as f:
        port = pickle.load(f)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    _RUNS[shape] = port, ref
    return port, ref


MESH_SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.mark.parametrize("mesh", sorted(MESH_SHAPES))
def test_sharded_runs_match_the_reference_and_the_unsharded_port(mesh, inputs, tmp_path):
    """Every config, remat off and on, hinted and not, on DTensors placed by
    ``param_specs``: against the reference's hinted run on the same mesh
    shape and against the port's unsharded run."""
    port, ref = _run_mesh(MESH_SHAPES[mesh], inputs, tmp_path)
    assert port["placed_ok"]
    for name in CASES:
        for remat in REMATS:
            plain = _unsharded(name, remat, inputs)
            _held(plain, ref[(name, remat)], f"{name} remat={remat}: port unsharded vs reference hinted")
            for hinted in (False, True):
                got = port["runs"][(name, remat, hinted)]
                what = f"{mesh} {name} remat={remat} hinted={hinted}"
                _held(got, ref[(name, remat)], f"{what}: port vs reference hinted")
                _held(got, plain, f"{what}: port vs port unsharded")


@pytest.mark.parametrize("mesh", sorted(MESH_SHAPES))
def test_hinted_branches_taken_on_each_mesh(mesh, inputs, tmp_path):
    """2 × 2: H1 head-parallel (Hkv 2 divides TP 2), H2 for both MoE configs,
    and H4's reduce_scatter (16 % 2² == 0).  1 × 4: H1 sequence-parallel
    (Hkv 2 does not divide TP 4), H2 where the experts divide TP (4 of 4; the
    2-expert config falls back to ``apply_moe``), and H4's reduce_scatter
    (16 % 4² == 0).  Without hints none is taken.  Under remat each block's
    forward runs again in the backward, up to the last tensor the backward
    needs: the MoE's closing reduce_scatter is not run again."""
    port, _ = _run_mesh(MESH_SHAPES[mesh], inputs, tmp_path)
    br = port["branches"]
    head = "H1 head" if mesh == "2x2" else "H1 seq"
    for name in CASES:
        moe_h2 = name == "moe-shared" or (name == "moe-top1" and mesh == "2x2")
        for remat in REMATS:
            k = 2 if remat else 1
            assert br[(name, remat, False)] == {}, (name, remat)
            want = {head: 2 * k}
            if moe_h2:
                want.update({"apply_moe_sharded": 2 * k, "reduce_scatter": 2})
            assert br[(name, remat, True)] == want, (mesh, name, remat, br[(name, remat, True)])


def test_zero1_adamw_step_equals_the_unsharded_step(inputs, tmp_path):
    """On the 2 × 2 mesh, moments placed by ``zero1_specs`` (data size 2):
    one AdamW step on the hinted grads (placed as their params) equals the
    unsharded step, and params, grads and moments keep their placements."""
    port, _ = _run_mesh((2, 2), inputs, tmp_path)
    a = port["adamw"]
    assert a["max_abs_err"] < GRAD_TOL, a
    assert a["params_placed"] and a["grads_placed"] and a["moments_placed"], a
    assert a["moments_sharded_over_data"] > 0, a
