"""The port's ``torch`` backend against the reference's ``jax`` backend.

Both packages run the same plans on the same payloads: the identity step
bodies of the conftest on seeded random DAGs (string payloads), the
reference data-plane benchmark's 12-step rmsnorm pipeline at (64, 256)
(``benchmarks/run.py``; here the port's plain rmsnorm against the Pallas
kernel in interpret mode, as ``repro.kernels.ops`` runs it on the CPU), and
the 1000 Genomes instance with float32 array payloads.  Stores must agree
(exactly for strings, at the benchmark's ``rtol=1e-5, atol=1e-6`` for
arrays) and the counts in ``stats`` must be equal, interpreted and fused.
The ``jax`` side is given one CPU device, as the ``torch`` side has.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import identity_step_fns
from test_torch_swirl import CHUNKS, RULES, dags, to_port

from repro import swirl as jswirl
from repro.core.graph import DistributedWorkflowInstance as JInstance
from repro.core.graph import make_workflow as j_make_workflow
from repro.core.translate import genomes_1000 as j_genomes
from repro.exec.policy import FaultPolicy as JFaultPolicy
from repro.kernels.ops import rmsnorm as j_rmsnorm
from repro_torch import swirl as tswirl
from repro_torch.core.graph import DistributedWorkflowInstance as TInstance
from repro_torch.core.graph import make_workflow as t_make_workflow
from repro_torch.core.translate import genomes_1000 as t_genomes
from repro_torch.exec.policy import FaultPolicy as TFaultPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels._build import KernelError

RTOL, ATOL = 1e-5, 1e-6  # the reference benchmark's fused-vs-interpreted gate
COUNTS = ("execs", "comms", "device_puts", "bytes_moved")
FUSED_COUNTS = ("segments_planned", "fused_calls", "fused_execs", "fallbacks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_options(**kw):
    return dict(devices=jax.devices("cpu")[:1], **kw)


def torch_options(**kw):
    return dict(platform="cpu", **kw)


def counts(stats) -> dict:
    out = {k: stats[k] for k in COUNTS}
    if "fused" in stats:
        f = stats["fused"]
        out.update({k: f[k] for k in FUSED_COUNTS})
        out["locations"] = {
            loc: (ls["calls"], ls["execs"]) for loc, ls in f["locations"].items()
        }
    if "policy" in stats:
        out["policy"] = stats["policy"]
    return out


def as_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def assert_stores_close(tdata, jdata):
    assert tdata.keys() == jdata.keys()
    for loc in jdata:
        assert tdata[loc].keys() == jdata[loc].keys(), loc
        for d, jv in jdata[loc].items():
            tv = tdata[loc][d]
            assert isinstance(tv, torch.Tensor), (loc, d, type(tv))
            np.testing.assert_allclose(as_numpy(tv), as_numpy(jv), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{loc}/{d}")


# -- identity stores on random DAGs ---------------------------------------------


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_identity_stores_and_counts_match_jax(chunk, fuse):
    for inst in dags(chunk):
        jexe = jswirl.trace(inst).optimize(RULES).lower(
            "jax", **jax_options(fuse=fuse)).compile(identity_step_fns(inst))
        pinst = to_port(inst)
        texe = tswirl.trace(pinst).optimize(RULES).lower(
            "torch", **torch_options(fuse=fuse)).compile(identity_step_fns(pinst))
        for _ in range(2):  # the second run reuses the cached verdicts
            jres, tres = jexe.run(), texe.run()
            assert tres.backend == "torch"
            assert tres.data == jres.data
            assert counts(tres.stats) == counts(jres.stats)


# -- the reference data-plane pipeline ----------------------------------------------


N_STEPS, SHAPE = 12, (64, 256)


def pipeline(make_instance, make_workflow):
    """``benchmarks/run.py``'s 12-step pipeline on one location ``l0``."""
    steps = [f"s{i}" for i in range(1, N_STEPS + 1)]
    ports = [f"p{i}" for i in range(N_STEPS + 1)]
    deps = []
    for i, s in enumerate(steps):
        deps += [(f"p{i}", s), (s, f"p{i + 1}")]
    return make_instance(
        workflow=make_workflow(steps, ports, deps),
        locations=frozenset({"l0"}),
        mapping={s: ("l0",) for s in steps},
        data=frozenset(f"d{i}" for i in range(N_STEPS + 1)),
        placement={f"d{i}": f"p{i}" for i in range(N_STEPS + 1)},
        initial_data={"l0": frozenset({"d0"})},
    )


def pipeline_fns(norm, mix):
    """rmsnorm on steps k = 0, 4, 8 (s1, s5, s9), ``mix`` on the others."""
    return {
        f"s{k + 1}": (
            lambda i, a=f"d{k}", b=f"d{k + 1}", f=(norm if k % 4 == 0 else mix): {b: f(i[a])}
        )
        for k in range(N_STEPS)
    }


def jax_pipeline_fns():
    w = jnp.ones((SHAPE[1],), jnp.float32)
    return pipeline_fns(lambda v: j_rmsnorm(v, w), lambda v: 0.5 * v + 0.1 * jnp.tanh(v))


def torch_pipeline_fns():
    w = torch.ones(SHAPE[1])
    return pipeline_fns(lambda v: tops.rmsnorm(v, w), lambda v: 0.5 * v + 0.1 * torch.tanh(v))


def pipeline_input(seed=7):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def jax_pipeline_results():
    jplan = jswirl.trace(pipeline(JInstance, j_make_workflow)).optimize()
    x = pipeline_input()
    return {
        fuse: jplan.lower("jax", **jax_options(fuse=fuse)).compile(jax_pipeline_fns()).run(
            initial_payloads={("l0", "d0"): x})
        for fuse in (False, True)
    }


@pytest.fixture(scope="module")
def torch_pipeline_plan():
    return tswirl.trace(pipeline(TInstance, t_make_workflow)).optimize()


@pytest.mark.parametrize("fuse", [False, True])
def test_pipeline_matches_jax(fuse, jax_pipeline_results, torch_pipeline_plan):
    jres = jax_pipeline_results[fuse]
    exe = torch_pipeline_plan.lower("torch", **torch_options(fuse=fuse)).compile(
        torch_pipeline_fns())
    tops.reset_launch_counts()
    tres = exe.run(initial_payloads={("l0", "d0"): pipeline_input()})
    assert_stores_close(tres.data, jres.data)
    assert counts(tres.stats) == counts(jres.stats)
    assert tops.launch_counts()["rmsnorm"] == 0  # CPU tensors take the plain version
    if fuse:
        f = tres.stats["fused"]
        assert (f["segments_planned"], f["fused_calls"], f["fused_execs"], f["fallbacks"]) == (
            1, 1, 12, 0)
        roof = f["roofline"]["l0"]
        assert roof["theoretical_bytes_per_s"] is None and roof["fraction_of_roof"] is None


def test_fused_pipeline_warm_calls_count_toward_the_roofline(torch_pipeline_plan):
    exe = torch_pipeline_plan.lower("torch", **torch_options(fuse=True)).compile(
        torch_pipeline_fns())
    feed = {("l0", "d0"): pipeline_input()}
    first = exe.run(initial_payloads=feed).stats["fused"]["locations"]["l0"]
    assert (first["calls"], first["bytes"], first["seconds"]) == (1, 0, 0.0)
    warm = exe.run(initial_payloads=feed).stats["fused"]["locations"]["l0"]
    assert warm["bytes"] == 13 * 64 * 256 * 4  # the input and 12 outputs
    assert warm["seconds"] > 0


def test_a_second_run_leaves_the_first_store_unchanged(torch_pipeline_plan):
    exe = torch_pipeline_plan.lower("torch", **torch_options(fuse=True)).compile(
        torch_pipeline_fns())
    first = exe.run(initial_payloads={("l0", "d0"): pipeline_input(7)})
    kept = {d: v.clone() for d, v in first.data["l0"].items()}
    second = exe.run(initial_payloads={("l0", "d0"): pipeline_input(8)})
    assert not torch.equal(second.data["l0"]["d12"], kept["d12"])
    for d, v in kept.items():
        assert torch.equal(first.data["l0"][d], v), d


def test_numpy_inputs_are_copied_and_keep_their_dtype(torch_pipeline_plan):
    x = pipeline_input()
    exe = torch_pipeline_plan.lower("torch", **torch_options()).compile(torch_pipeline_fns())
    res = exe.run(initial_payloads={("l0", "d0"): x})
    d0 = res.data["l0"]["d0"]
    assert d0.dtype == torch.float32 and d0.data_ptr() != x.ctypes.data
    x64 = x.astype(np.float64)  # kept float64, where the reference stores float32
    res = exe.run(initial_payloads={("l0", "d0"): x64})
    assert res.data["l0"]["d12"].dtype == torch.float64


def test_policy_turns_fusion_off(torch_pipeline_plan, jax_pipeline_results):
    exe = torch_pipeline_plan.lower(
        "torch", **torch_options(fuse=True, policy=TFaultPolicy(max_retries=1))
    ).compile(torch_pipeline_fns())
    tres = exe.run(initial_payloads={("l0", "d0"): pipeline_input()})
    jplan = jswirl.trace(pipeline(JInstance, j_make_workflow)).optimize()
    jres = jplan.lower("jax", **jax_options(fuse=True, policy=JFaultPolicy(max_retries=1))).compile(
        jax_pipeline_fns()).run(initial_payloads={("l0", "d0"): pipeline_input()})
    assert "fused" not in tres.stats and "fused" not in jres.stats
    assert counts(tres.stats) == counts(jres.stats)
    assert_stores_close(tres.data, jax_pipeline_results[False].data)


def test_segments_that_cannot_be_fused_fall_back(torch_pipeline_plan):
    def to_list(v):  # a non-array output: the next segment call sees a list
        return v.tolist()

    fns = torch_pipeline_fns()
    fns["s2"] = lambda i: {"d2": to_list(i["d1"])}
    fns["s3"] = lambda i: {"d3": torch.tensor(i["d2"])}
    exe = torch_pipeline_plan.lower("torch", **torch_options(fuse=True)).compile(fns)
    res = exe.run(initial_payloads={("l0", "d0"): pipeline_input()})
    f = res.stats["fused"]
    assert (f["fused_calls"], f["fallbacks"], res.stats["execs"]) == (0, 1, 12)
    again = exe.run(initial_payloads={("l0", "d0"): pipeline_input()}).stats["fused"]
    assert (again["fused_calls"], again["fallbacks"]) == (0, 0)  # the verdict is cached


def test_kernel_errors_propagate_out_of_a_fused_segment(torch_pipeline_plan):
    def broken(v):
        raise KernelError("rmsnorm kernel launch failed: CUDA error 1 (invalid argument)")

    fns = torch_pipeline_fns()
    fns["s5"] = lambda i: {"d5": broken(i["d4"])}
    exe = torch_pipeline_plan.lower("torch", **torch_options(fuse=True)).compile(fns)
    with pytest.raises(KernelError, match="rmsnorm kernel launch failed"):
        exe.run(initial_payloads={("l0", "d0"): pipeline_input()})


def test_run_many_and_run_async_match_run(torch_pipeline_plan):
    exe = torch_pipeline_plan.lower("torch", **torch_options(fuse=True)).compile(
        torch_pipeline_fns())
    feeds = [{("l0", "d0"): pipeline_input(s)} for s in (1, 2, 3)]
    many = exe.run_many(feeds, max_concurrent=3)
    one = [exe.run(initial_payloads=f) for f in feeds]
    fut = exe.run_async(initial_payloads=feeds[0]).result(timeout=60)
    for a, b in zip(many + [fut], one + [one[0]]):
        for d in b.data["l0"]:
            assert torch.equal(a.data["l0"][d], b.data["l0"][d])


def test_non_termination_is_reported(torch_pipeline_plan):
    fns = torch_pipeline_fns()
    exe = torch_pipeline_plan.lower("torch", **torch_options(max_rounds=3)).compile(fns)
    with pytest.raises(RuntimeError, match="torch backend: workflow did not terminate"):
        exe.run(initial_payloads={("l0", "d0"): pipeline_input()})


# -- 1000 Genomes with array payloads ------------------------------------------------


G_ELEMS = 65536


def genomes_fns(inst, init, xp_sum, ones):
    """``benchmarks/run.py``'s genomes bodies: ``s0`` hands out its inputs,
    every other step sums its inputs into a vector of ones."""
    fns = {}
    for s in inst.workflow.steps:
        outs = inst.out_data(s)
        if s == "s0":
            fns[s] = lambda i, outs=outs: {o: init[("l^d", o)] for o in outs}
        else:
            fns[s] = lambda i, outs=outs: {
                o: sum(xp_sum(v) for v in i.values()) * ones() for o in outs
            }
    return fns


@pytest.mark.parametrize("fuse", [False, True])
def test_genomes_arrays_match_jax(fuse):
    kw = dict(n=4, m=3, a=2, b=2, c=2)
    jinst, tinst = j_genomes(**kw), t_genomes(**kw)
    rng = np.random.default_rng(0)
    init = {("l^d", d): rng.random(G_ELEMS).astype(np.float32) for d in sorted(jinst.g("l^d"))}
    jfns = genomes_fns(jinst, init, jnp.sum, lambda: jnp.ones(G_ELEMS, jnp.float32))
    tfns = genomes_fns(tinst, init, torch.sum, lambda: torch.ones(G_ELEMS))
    jres = jswirl.trace(jinst).optimize(RULES).lower("jax", **jax_options(fuse=fuse)).compile(
        jfns).run(initial_payloads=dict(init))
    tres = tswirl.trace(tinst).optimize(RULES).lower("torch", **torch_options(fuse=fuse)).compile(
        tfns).run(initial_payloads=dict(init))
    assert_stores_close(tres.data, jres.data)
    assert counts(tres.stats) == counts(jres.stats)
    assert tres.stats["comms"] > 0 and len(tres.stats["devices"]) == 9
