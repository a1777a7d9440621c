"""Multi-pod dry-run: step every (arch × shape × mesh) cell on meta DTensors
and count it.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step for 256 or 512 placeholder devices and reads XLA's cost and
memory analyses.  The port runs the step itself, eagerly, on a ``"fake"``
process group of as many ranks (rank 0 of it, in this one process), on
DTensors whose local shards are ``meta`` tensors: DTensor propagates the
sharding and issues the collectives, nothing is allocated or computed, and
:func:`repro_torch.roofline.counting.count_step` counts what rank 0 runs.
Importing this module starts no process group and sets no environment
variable; :func:`run_cell` makes the group and destroys it before it
returns.

Single-cell mode::

    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \\
        --mesh pod1 --out experiments/dryrun_torch/llama3.2-3b__train_4k__pod1.json

Fleet mode (fans out one subprocess a cell, collects JSON)::

    python -m repro_torch.launch.dryrun --all --jobs 4 --out-dir experiments/dryrun_torch

``--device`` is the mesh's device type, ``cuda`` unless ``cpu`` is asked
for (no tensor is made on it either way).  The cell's step is the one the
reference lowers: ``make_train_step`` (AdamW, moments placed by
``zero1_specs``), ``make_prefill_step`` or ``make_serve_step``, on the
plain path (no kernel: a ``ctypes`` kernel is invisible to any dispatch
mode), as the reference's dry-run uses ``attn_impl="xla"``.

A record has the reference's keys.  What differs, and why:

* ``lower_s`` is the time of the counted meta step (after an uncounted
  one: DTensor's first dispatch of an op runs more local ops than later
  ones); ``compile_s`` is 0 (eager PyTorch compiles nothing);
* ``cost_analysis.flops`` is the FLOPs rank 0 runs (matmuls and attention,
  as ``FlopCounterMode`` counts them), ``flops_global`` each op once over
  the mesh (see :mod:`repro_torch.roofline.counting`), ``bytes_accessed``
  every op's operand and result bytes on local shards (unfused, as the
  reference's CPU backend reports them); ``utilization_ops`` is ``null``;
* ``memory_analysis.argument_bytes`` and ``output_bytes`` are the step's
  inputs and outputs on rank 0's shards; ``temp_bytes`` and
  ``generated_code_bytes`` are ``null`` (``null_reason`` says why): eager
  PyTorch has no buffer assignment and generates no code;
* ``hlo_bytes`` is ``null``: there is no HLO;
* ``roofline`` uses the H100 SXM's constants (``roofline.analysis``);
* a cell with sLSTM layers and more than three time steps is counted at
  two and at three steps of the sLSTM loop and scaled
  (``models.recurrent.slstm_step_limit``); ``slstm_steps_scaled`` records
  it (``null`` elsewhere).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

MESHES = ("pod1", "pod2")  # 16×16 single pod; 2×16×16 multi-pod
SKU = "H100 SXM"  # the cards of the production meshes, 8 a node
NULL_REASON = "eager PyTorch has no buffer assignment and generates no code"


def _place(tree, specs, mesh):
    """Each meta leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    spec, its local shard rank 0's, on ``meta`` (nothing is scattered).  A
    0-dim leaf (a cache's length) stays a plain tensor, as the optimizer's
    step does: DTensor reads a 0-dim tensor as a replicated scalar."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch._bridge import tree_flatten_with_path, tree_unflatten

    from .sharding import NamedSharding

    leaves, placed = tree_flatten_with_path(tree), []
    for (_, t), (_, spec) in zip(leaves, tree_flatten_with_path(specs), strict=True):
        if t.ndim == 0:
            placed.append(t)
            continue
        pl = NamedSharding(mesh, spec).placements
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        placed.append(DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
                                         run_check=False, shape=t.shape, stride=t.stride()))
    return tree_unflatten(tree, placed)


def _local_bytes(*trees) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch._bridge import tree_leaves

    n = 0
    for tree in trees:
        for t in tree_leaves(tree):
            if hasattr(t, "numel"):
                t = t.to_local() if isinstance(t, DTensor) else t
                n += t.numel() * t.element_size()
    return n


def _scale(c2, c3, steps: int):
    """The cost of ``steps`` sLSTM steps from counts at 2 and 3 steps (the
    first step's backward differs from the others': nothing to accumulate
    into yet; from the second on, each step costs the same)."""
    from repro_torch.roofline.collectives import CollectiveStats
    from repro_torch.roofline.counting import StepCost

    ex = lambda a, b: a + (steps - 2) * (b - a)  # noqa: E731
    out = StepCost(flops=ex(c2.flops, c3.flops), flops_global=ex(c2.flops_global, c3.flops_global),
                   bytes_accessed=ex(c2.bytes_accessed, c3.bytes_accessed), ops=ex(c2.ops, c3.ops),
                   collectives=CollectiveStats())
    s2, s3, st = c2.collectives, c3.collectives, out.collectives
    for name in ("count", "result_bytes", "link_bytes", "network_bytes"):
        a, b, o = getattr(s2, name), getattr(s3, name), getattr(st, name)
        for k in set(a) | set(b):
            o[k] = ex(a.get(k, 0), b.get(k, 0))
    st.top = list(s3.top)
    return out


def count_cell(cfg, shape, mesh_shape: tuple[int, ...], mesh_axes: tuple[str, ...], *,
               variant: str = "baseline", device: str = "cuda", slstm_scaling: bool = True) -> tuple[dict, object]:
    """Step ``cfg`` at ``shape`` (a ``configs.shapes.Shape``) on meta
    DTensors over a ``"fake"`` group of ``prod(mesh_shape)`` ranks, made
    here and destroyed before returning, and count it.  Returns the record's
    counted keys and the :class:`CollectiveStats`.  ``slstm_scaling=False``
    runs every sLSTM step (the tests hold the scaling to it)."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import Model, hints, layers, recurrent
    from repro_torch.optim import AdamWConfig, AdamWState, zero1_specs
    from repro_torch.roofline.analysis import CHIPS
    from repro_torch.roofline.counting import count_step

    from . import steps as S
    from .mesh import axis_size, data_axes, make_mesh
    from .sharding import batch_specs, cache_specs, param_specs

    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own process group; one is already initialized")
    chips = math.prod(mesh_shape)
    model = Model(cfg, "meta")
    optimized = variant == "opt"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips, timeout=timedelta(seconds=60))
    prev_impl = layers.get_attn_impl()
    try:
        mesh = make_mesh(mesh_shape, mesh_axes, device_type=device)
        hints.set_hints(hints.ShardHints(mesh=mesh, dp_axes=data_axes(mesh)) if optimized else None)
        layers.set_attn_impl("plain")

        p_shape = S.abstract_params(model)
        params = _place(p_shape, param_specs(cfg, p_shape, mesh), mesh)
        b_shape = S.input_specs(cfg, shape)
        batch = _place(b_shape, batch_specs(cfg, b_shape, mesh), mesh)
        if shape.kind == "train":
            mv_spec = zero1_specs(param_specs(cfg, p_shape, mesh), p_shape,
                                  data_axis="data", data_size=axis_size(mesh, "data"))
            o_shape = S.abstract_opt_state(p_shape)
            args = (params, AdamWState(step=o_shape.step, m=_place(o_shape.m, mv_spec, mesh),
                                       v=_place(o_shape.v, mv_spec, mesh)), batch)
            fn = S.make_train_step(model, AdamWConfig())
        else:
            c_shape = S.abstract_cache(model, shape.global_batch, shape.seq_len)
            cache = _place(c_shape, cache_specs(cfg, c_shape, mesh, optimized=optimized), mesh)
            if shape.kind == "prefill":
                args, fn = (params, batch, cache), S.make_prefill_step(model)
            else:
                args, fn = (params, cache, batch["tokens"]), S.make_serve_step(model)

        def counted():
            with count_step(chips=chips, gpus_per_node=CHIPS[SKU].gpus_per_node) as cost:
                out = fn(*args)
            return cost, out

        n_slstm = sum(1 for m, _ in cfg.layer_seq() if m == "slstm")
        steps = shape.seq_len if shape.kind != "decode" else 1
        scaled = slstm_scaling and n_slstm > 0 and steps > 3
        # A first, uncounted step: DTensor's first dispatch of an op runs
        # more local ops than later ones do (its caches fill), and a step is
        # counted as it runs every time.
        with recurrent.slstm_step_limit(2 if scaled else steps):
            fn(*args)
        rec: dict = {"chips": chips}
        t0 = time.monotonic()
        if scaled:
            with recurrent.slstm_step_limit(2):
                c2, _ = counted()
            with recurrent.slstm_step_limit(3):
                c3, out = counted()
            cost = _scale(c2, c3, steps)
            rec["slstm_steps_scaled"] = {"steps": steps, "counted_at": [2, 3], "layers": n_slstm}
        else:
            cost, out = counted()
            rec["slstm_steps_scaled"] = None
        rec["lower_s"] = time.monotonic() - t0
        rec["compile_s"] = 0.0
        rec["cost_analysis"] = {
            "flops": cost.flops,
            "flops_global": cost.flops_global,
            "bytes_accessed": cost.bytes_accessed,
            "utilization_ops": None,
            "ops": cost.ops,
        }
        rec["memory_analysis"] = {
            "argument_bytes": _local_bytes(*args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": None,
            "generated_code_bytes": None,
            "null_reason": NULL_REASON,
        }
        rec["collectives"] = cost.collectives.as_dict()
        rec["hlo_bytes"] = None
        return rec, cost.collectives
    finally:
        hints.set_hints(None)
        layers.set_attn_impl(prev_impl)
        dist.destroy_process_group()


def run_cell(
    arch: str, shape_name: str, mesh_name: str,
    *, unroll: bool = False, variant: str = "baseline", device: str = "cuda",
) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, shape_applicable
    from repro_torch.models import unrolled_variant
    from repro_torch.roofline import model_flops, roofline
    from repro_torch.roofline.analytic import analytic_flops_global, analytic_hbm_bytes_per_device

    from .mesh import production_mesh_shape

    t_start = time.monotonic()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape_name)
    if not ok:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "skipped", "reason": why,
        }
    ssm_chunk = cfg.ssm.chunk
    if shape.kind in ("train", "prefill"):
        ssm_chunk = max(cfg.ssm.chunk, shape.seq_len // 16)
    if unroll:
        cfg = unrolled_variant(cfg, ssm_chunk=ssm_chunk)
    elif ssm_chunk != cfg.ssm.chunk:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    mesh_shape, mesh_axes = production_mesh_shape(multi_pod=(mesh_name == "pod2"))
    rec: dict = {
        "variant": variant,
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "device": device,
        "params": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    counted, stats = count_cell(cfg, shape, mesh_shape, mesh_axes, variant=variant, device=device)
    rec.update(counted)
    chips = rec["chips"]

    base_cfg = get_config(arch)
    a_flops = analytic_flops_global(base_cfg, shape)
    model_ways = mesh_shape[mesh_axes.index("model")]
    mm = analytic_hbm_bytes_per_device(base_cfg, shape, model_ways=model_ways, data_ways=chips // model_ways)
    rec["analytic"] = {
        "flops_global": a_flops,
        "hbm_bytes_per_device": mm.total,
        "hbm_breakdown": {
            "params": mm.params_bytes,
            "opt": mm.opt_bytes,
            "grads": mm.grad_bytes,
            "acts": mm.act_bytes,
            "kv": mm.kv_bytes,
            "logits": mm.logits_bytes,
        },
    }
    rl = roofline(
        sku=SKU,
        flops_per_device=a_flops / chips,
        hbm_bytes_per_device=mm.total,
        link_bytes_per_device=stats.total_link_bytes,
        network_bytes_per_device=stats.total_network_bytes,
        model_flops_global=model_flops(base_cfg, shape),
        chips=chips,
    )
    rec["roofline"] = rl.as_dict()
    rec["status"] = "ok"
    rec["total_s"] = time.monotonic() - t_start
    return rec


def _cell_out(out_dir: Path, arch: str, shape: str, mesh: str) -> Path:
    safe = arch.replace("/", "_")
    return out_dir / f"{safe}__{shape}__{mesh}.json"


def run_all(out_dir: Path, jobs: int, meshes: tuple[str, ...], timeout: int, force: bool,
            variant: str = "baseline", device: str = "cuda") -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES

    out_dir.mkdir(parents=True, exist_ok=True)
    cells = [
        (a, s, m)
        for a in ARCHS
        for s in SHAPES
        for m in meshes
    ]
    pending = []
    for cell in cells:
        out = _cell_out(out_dir, *cell)
        if force or not out.exists():
            pending.append(cell)
    print(f"{len(cells)} cells total, {len(pending)} to run, jobs={jobs}", flush=True)

    procs: dict = {}
    failures = []
    queue = list(pending)
    while queue or procs:
        while queue and len(procs) < jobs:
            cell = queue.pop(0)
            out = _cell_out(out_dir, *cell)
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                "--out", str(out), "--variant", variant, "--device", device,
            ]
            procs[subprocess.Popen(cmd, stdout=subprocess.DEVNULL)] = (cell, out, time.monotonic())
        done = [p for p in procs if p.poll() is not None]
        for p in done:
            cell, out, t0 = procs.pop(p)
            dt = time.monotonic() - t0
            if p.returncode != 0 or not out.exists():
                failures.append(cell)
                print(f"FAIL {cell} rc={p.returncode} ({dt:.0f}s)", flush=True)
            else:
                rec = json.loads(out.read_text())
                print(
                    f"ok   {cell} status={rec.get('status')} "
                    f"step={rec.get('lower_s', 0):.0f}s ({dt:.0f}s)", flush=True
                )
        for p, (cell, out, t0) in list(procs.items()):
            if time.monotonic() - t0 > timeout:
                p.kill()
                p.wait()
                failures.append(cell)
                print(f"TIMEOUT {cell}", flush=True)
                procs.pop(p)
        time.sleep(0.5)
    print(f"done; {len(failures)} failures: {failures}", flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESHES, default="pod1")
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", choices=("baseline", "opt"), default="baseline")
    ap.add_argument("--unroll", action="store_true",
                    help="the unrolled config (the port's stack is unrolled already: the same model)")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (no tensor is made on it)")
    args = ap.parse_args(argv)

    if args.all:
        return run_all(
            Path(args.out_dir), args.jobs, MESHES, args.timeout, args.force,
            variant=args.variant, device=args.device,
        )

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, unroll=args.unroll, variant=args.variant,
                       device=args.device)
    except Exception as e:  # noqa: BLE001 — a cell's failure is its record
        rec = {
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh, "variant": args.variant,
            "status": "error", "error": f"{type(e).__name__}: {e}",
        }
    text = json.dumps(rec, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
