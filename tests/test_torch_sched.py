"""The port's placement scheduler (``repro_torch.sched``) against the reference's.

Network presets and binds, the size and cost models, simulated makespans
on the reference's own test systems, ``Plan.schedule`` and
``auto_placement`` on the quickstart plan, 1000 Genomes and seeded random
DAGs: every number, placement and fingerprint must be equal, not close.
Then the scheduled plans run on the port's ``torch`` backend (on the CPU):
stores equal the reference's ``jax`` stores, the device map of a schedule
equals the ``jax`` backend's, and ``Plan.profile`` predicts the same
timeline as the reference's.
"""

from __future__ import annotations

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_differential import random_instance
from test_torch_dataplane import G_ELEMS, RULES, assert_stores_close, genomes_fns
from test_torch_swirl import to_port

import repro.configs.shapes as j_shapes
import repro.core.syntax as jsyn
import repro.sched as jsched
from repro import swirl as jswirl
from repro.backends.jax_backend import JaxMeshProgram
from repro.core.compile import StepMeta as JStepMeta
from repro.core.translate import TrainPipelineTranslator as JTrainPipeline
from repro.core.translate import genomes_1000 as j_genomes
import repro_torch.configs.shapes as t_shapes
import repro_torch.core.syntax as tsyn
import repro_torch.sched as tsched
from repro_torch import swirl as tswirl
from repro_torch.backends import torch_backend
from repro_torch.backends.torch_backend import TorchDeviceProgram
from repro_torch.core.compile import StepMeta as TStepMeta
from repro_torch.core.translate import TrainPipelineTranslator as TTrainPipeline
from repro_torch.core.translate import genomes_1000 as t_genomes
from repro_torch.models.config import ModelConfig

EDGES = {
    "preprocess": ["train_a", "train_b"],
    "train_a": ["evaluate"],
    "train_b": ["evaluate"],
    "evaluate": ["report"],
    "report": [],
}
MAPPING = {
    "preprocess": ("cpu0",),
    "train_a": ("gpu0",),
    "train_b": ("gpu1",),
    "evaluate": ("gpu0",),
    "report": ("cpu0",),
}
GKW = dict(n=4, m=3, a=2, b=2, c=2)
PRESETS = {
    "uniform": {},
    "two-rack": {},
    "cpu+accelerator": {},
    "uniform-slow": {"bandwidth": 1e6, "latency": 2e-3},
    "two-rack-explicit": {"racks": {"rack0": ["cpu0", "gpu0"], "rack1": ["gpu1"]}},
    "cpu+accelerator-explicit": {"cpu": ["gpu1"]},
}
N_DAGS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def preset(sched, key):
    name = key.replace("-slow", "").replace("-explicit", "")
    return sched.NetworkModel.preset(name, **PRESETS[key])


def canon(x):
    """A dataclass (Simulation, NetworkModel, ...) as nested plain values."""
    return dataclasses.asdict(x)


def report_canon(report) -> dict:
    out = canon(report)
    out.pop("search_seconds")  # wall clock
    return out


def quickstart_steps():
    return {
        "preprocess": lambda inp: {"d^preprocess": list(range(10))},
        "train_a": lambda inp: {"d^train_a": sum(inp["d^preprocess"])},
        "train_b": lambda inp: {"d^train_b": max(inp["d^preprocess"])},
        "evaluate": lambda inp: {"d^evaluate": inp["d^train_a"] + inp["d^train_b"]},
        "report": lambda inp: {},
    }


# -- the network model ------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(PRESETS))
def test_presets_and_binds_equal_the_reference(key):
    locs = ["cpu0", "gpu0", "gpu1", "host", "l^d", "z9"]
    jn, tn = preset(jsched, key), preset(tsched, key)
    assert canon(tn) == canon(jn)
    jb, tb = jn.bind(locs), tn.bind(locs)
    assert canon(tb) == canon(jb)
    assert tb.describe() == jb.describe()
    for a in locs:
        assert tb.group_of(a) == jb.group_of(a)
        for b in locs:
            assert tb.transfer_s(12345, a, b) == jb.transfer_s(12345, a, b)


def test_links_and_refusals_equal_the_reference():
    for sched in (jsched, tsched):
        link = sched.Link(bandwidth=1000.0, latency=0.5)
        assert link.transfer_s(1000) == 1.5
        assert sched.Link(float("inf"), 0.25).transfer_s(10**12) == 0.25
        assert sched.LOCAL_LINK == sched.Link(float("inf"), 0.0)
        with pytest.raises(ValueError):
            sched.Link(bandwidth=0.0)
        with pytest.raises(ValueError):
            sched.Link(bandwidth=1.0, latency=-1.0)
        with pytest.raises(ValueError, match="unknown network preset"):
            sched.NetworkModel.preset("warp")
        with pytest.raises(TypeError, match="unknown arguments"):
            sched.NetworkModel.preset("uniform", racks={})
        with pytest.raises(ValueError, match="in groups"):
            sched.NetworkModel(groups={"g1": frozenset({"a"}), "g2": frozenset({"a"})})
    pair = dict(default=(1.0, 10.0), links={("a", "b"): (float("inf"), 0.0)})
    nets = [
        s.NetworkModel(default=s.Link(*pair["default"]),
                       links={k: s.Link(*v) for k, v in pair["links"].items()})
        for s in (jsched, tsched)
    ]
    assert canon(nets[0]) == canon(nets[1])
    assert [n.transfer_s(100, "b", "a") for n in nets] == [110.0, 110.0]


# -- the estimators ---------------------------------------------------------------------


def test_size_and_cost_models_equal_the_reference():
    payloads = {("loc", "arr"): np.zeros(10), "plain": 3, ("l", "t"): torch.zeros(3, 5)}
    for jm, tm in (
        (jsched.SizeModel(default_bytes=7, sizes={"d": 100}),
         tsched.SizeModel(default_bytes=7, sizes={"d": 100})),
        (jsched.SizeModel.from_step_metas(
            {"s1": JStepMeta(fn=len, output_bytes={"d1": 42}), "s2": len}, default_bytes=9),
         tsched.SizeModel.from_step_metas(
            {"s1": TStepMeta(fn=len, output_bytes={"d1": 42}), "s2": len}, default_bytes=9)),
        (jsched.SizeModel.from_payloads(payloads), tsched.SizeModel.from_payloads(payloads)),
    ):
        assert canon(tm) == canon(jm)
        assert canon(tm.updated({"e": 5})) == canon(jm.updated({"e": 5}))
    assert tsched.SizeModel.from_payloads(payloads).bytes_of("t") == 60
    jc = jsched.CostModel.from_step_metas(
        {"fast": JStepMeta(fn=len, expected_seconds=0.25), "plain": len}, default_exec_s=1.0)
    tc = tsched.CostModel.from_step_metas(
        {"fast": TStepMeta(fn=len, expected_seconds=0.25), "plain": len}, default_exec_s=1.0)
    assert canon(tc) == canon(jc)
    m = {"a": 0.5, "b": [0.1, 0.3]}
    assert canon(tsched.CostModel.from_profile(m)) == canon(jsched.CostModel.from_profile(m))
    with pytest.raises(TypeError):
        tsched.CostModel.from_profile(42)


@pytest.mark.parametrize("shape", sorted(j_shapes.SHAPES))
def test_for_shape_through_the_ports_own_shapes(shape):
    assert dataclasses.asdict(t_shapes.SHAPES[shape]) == dataclasses.asdict(
        j_shapes.SHAPES[shape])
    for arch in ("llama3.2-3b", "xlstm-125m"):
        assert t_shapes.shape_applicable(arch, shape) == j_shapes.shape_applicable(arch, shape)
    for d_model in (8, 128, 3072):
        assert canon(tsched.SizeModel.for_shape(shape, d_model=d_model)) == canon(
            jsched.SizeModel.for_shape(shape, d_model=d_model))
    cfg = ModelConfig(name="t", d_model=96, n_layers=2, n_heads=4,
                      n_kv_heads=2, head_dim=24, d_ff=128, vocab=256)
    assert tsched.SizeModel.for_shape(t_shapes.SHAPES[shape], cfg=cfg).default_bytes == (
        jsched.SizeModel.for_shape(shape, d_model=96).default_bytes)
    with pytest.raises(TypeError, match="d_model"):
        tsched.SizeModel.for_shape(shape)
    assert list(t_shapes.cells(["llama3.2-3b", "xlstm-125m"])) == [
        (a, t_shapes.SHAPES[s.name]) for a, s in j_shapes.cells(["llama3.2-3b", "xlstm-125m"])]


# -- the simulator on the reference's test systems ------------------------------------------


def chain(syn):
    return syn.system(
        syn.config("a", {"x"}, syn.seq(
            syn.Exec("s1", frozenset({"x"}), frozenset({"y"}), ("a",)),
            syn.Send("y", "p", "a", "b"))),
        syn.config("b", set(), syn.seq(
            syn.Recv("p", "a", "b"),
            syn.Exec("s2", frozenset({"y"}), frozenset({"z"}), ("b",)))),
    )


def local(syn):
    return syn.system(syn.config("a", {"x"}, syn.seq(
        syn.Exec("s1", frozenset({"x"}), frozenset({"y"}), ("a",)),
        syn.Send("y", "p", "a", "a"),
        syn.Recv("p", "a", "a"))))


def parallel(syn):
    return syn.system(syn.config("a", {"x"}, syn.par(
        syn.Exec("s1", frozenset({"x"}), frozenset(), ("a",)),
        syn.Exec("s2", frozenset({"x"}), frozenset(), ("a",)))))


def synchronised(syn):
    act = syn.Exec("sync", frozenset(), frozenset({"o"}), ("a", "b"))
    return syn.system(
        syn.config("a", {"y"}, syn.seq(syn.Send("y", "p", "a", "b"), act)),
        syn.config("b", set(), syn.seq(syn.Recv("p", "a", "b"), act)),
    )


def genomes_raw(syn):
    mod = jswirl if syn is jsyn else tswirl
    genomes = j_genomes if syn is jsyn else t_genomes
    return mod.trace(genomes(**GKW)).system


def genomes_opt(syn):
    mod = jswirl if syn is jsyn else tswirl
    genomes = j_genomes if syn is jsyn else t_genomes
    return mod.trace(genomes(**GKW)).optimize(RULES).system


SYSTEMS = {
    "chain": chain, "local": local, "parallel": parallel,
    "synchronised": synchronised, "genomes": genomes_raw, "genomes-R1R2R3": genomes_opt,
}


@pytest.mark.parametrize("slots", [None, 1])
@pytest.mark.parametrize("net", ["uniform", "uniform-slow", "two-rack", "cpu+accelerator"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_simulations_equal_the_reference(name, net, slots):
    kw = {}
    sims = []
    for syn, sched in ((jsyn, jsched), (tsyn, tsched)):
        kw = dict(
            network=preset(sched, net),
            sizes=sched.SizeModel(default_bytes=1000, sizes={"y": 1 << 19}),
            costs=sched.CostModel(default_exec_s=1.0, costs={"s1": 0.25}),
            exec_slots=slots,
        )
        sims.append(sched.simulate(SYSTEMS[name](syn), **kw))
    jsim, tsim = sims
    assert canon(tsim) == canon(jsim)
    assert tsim.summary() == jsim.summary()


def test_unmatched_recv_raises_as_the_reference():
    for syn, sched in ((jsyn, jsched), (tsyn, tsched)):
        w = syn.system(syn.config("b", set(), syn.Recv("p", "a", "b")))
        with pytest.raises(sched.SimulationError, match="no matching send"):
            sched.simulate(w)


# -- the placement search and Plan.schedule ------------------------------------------------


def instances(which):
    if which == "quickstart":
        return (jswirl.trace(EDGES, mapping=MAPPING).instance,
                tswirl.trace(EDGES, mapping=MAPPING).instance)
    if which == "genomes":
        return j_genomes(**GKW), t_genomes(**GKW)
    if which == "genomes-small":
        return j_genomes(n=2, m=2, a=1, b=1, c=1), t_genomes(n=2, m=2, a=1, b=1, c=1)
    return JTrainPipeline(n_pods=4).instance(), TTrainPipeline(n_pods=4).instance()


@pytest.mark.parametrize("objective", ["makespan", "bytes"])
@pytest.mark.parametrize("net", ["two-rack", "cpu+accelerator"])
@pytest.mark.parametrize("which", ["quickstart", "genomes", "train-pipeline"])
def test_plan_schedule_equals_the_reference(which, net, objective):
    jinst, tinst = instances(which)
    sizes = dict(default_bytes=8 * 65536)
    jplan = jswirl.trace(jinst).optimize(RULES).schedule(
        preset(jsched, net), objective=objective, sizes=jsched.SizeModel(**sizes),
        costs=jsched.CostModel(default_exec_s=5e-3))
    tplan = tswirl.trace(tinst).optimize(RULES).schedule(
        preset(tsched, net), objective=objective, sizes=tsched.SizeModel(**sizes),
        costs=tsched.CostModel(default_exec_s=5e-3))
    jr, tr = jplan.schedule_report, tplan.schedule_report
    assert report_canon(tr) == report_canon(jr)
    assert tr.bytes_saved_frac == jr.bytes_saved_frac
    assert tr.makespan_speedup == jr.makespan_speedup
    assert tplan.fingerprint() == jplan.fingerprint()
    assert [r.rule for r in tplan.rewrites] == [r.rule for r in jplan.rewrites]
    cut = "search:"  # the summary's first line carries the search's wall clock
    assert tr.summary().split("\n", 1)[1] == jr.summary().split("\n", 1)[1]
    assert tr.summary().split(cut)[0] == jr.summary().split(cut)[0]
    assert "-- schedule --" in tplan.explain()
    assert [label for label, _ in tplan.timings][0] == "schedule"


def test_plan_schedule_defaults_pins_and_step_registry_equal_the_reference():
    jp = jswirl.trace(EDGES, mapping=MAPPING)
    tp = tswirl.trace(EDGES, mapping=MAPPING)
    assert report_canon(tp.schedule().schedule_report) == report_canon(
        jp.schedule().schedule_report)
    assert [r.rule for r in tp.schedule().rewrites] == ["R1R2"]
    jmetas = {n: JStepMeta(fn=f, expected_seconds=0.01, output_bytes={f"d^{n}": 64})
              for n, f in quickstart_steps().items()}
    tmetas = {n: TStepMeta(fn=f, expected_seconds=0.01, output_bytes={f"d^{n}": 64})
              for n, f in quickstart_steps().items()}
    js, ts = jp.optimize().schedule(steps=jmetas), tp.optimize().schedule(steps=tmetas)
    assert report_canon(ts.schedule_report) == report_canon(js.schedule_report)
    jt = jswirl.trace(JTrainPipeline(n_pods=2)).schedule(pin=("shard_0",))
    tt = tswirl.trace(TTrainPipeline(n_pods=2)).schedule(pin=("shard_0",))
    assert tt.placement() == jt.placement() and tt.fingerprint() == jt.fingerprint()
    with pytest.raises(ValueError, match="objective"):
        tsched.auto_placement(t_genomes(n=2, m=2, a=1, b=1, c=1), objective="latency")
    with pytest.raises(ValueError, match="front-end instance"):
        tswirl.trace(tp.system).schedule()


@pytest.mark.parametrize("objective", ["makespan", "bytes"])
@pytest.mark.parametrize("seed", range(N_DAGS))
def test_auto_placement_on_seeded_dags_equals_the_reference(seed, objective):
    inst = random_instance(random.Random(16_000 + seed))
    pinst = to_port(inst)
    jr = jsched.auto_placement(inst, jsched.NetworkModel.preset("two-rack"),
                               objective=objective, rules=RULES)
    tr = tsched.auto_placement(pinst, tsched.NetworkModel.preset("two-rack"),
                               objective=objective, rules=RULES)
    assert report_canon(tr) == report_canon(jr)
    assert tsched.round_robin_placement(pinst) == jsched.round_robin_placement(inst)
    jg = jsched.greedy_placement(
        inst, jsched.NetworkModel.preset("uniform"), objective=objective,
        sizes=jsched.SizeModel(default_bytes=1 << 20), costs=jsched.CostModel())
    tg = tsched.greedy_placement(
        pinst, tsched.NetworkModel.preset("uniform"), objective=objective,
        sizes=tsched.SizeModel(default_bytes=1 << 20), costs=tsched.CostModel())
    assert tg == jg
    jp = jswirl.trace(inst).optimize(RULES).schedule(jsched.NetworkModel.preset("two-rack"))
    tp = tswirl.trace(pinst).optimize(RULES).schedule(tsched.NetworkModel.preset("two-rack"))
    assert tp.fingerprint() == jp.fingerprint()


# -- scheduled plans on the torch backend --------------------------------------------------


def genomes_payloads(jinst):
    rng = np.random.default_rng(0)
    return {("l^d", d): rng.random(G_ELEMS).astype(np.float32) for d in sorted(jinst.g("l^d"))}


@pytest.mark.parametrize("fuse", [False, True])
def test_auto_placement_runs_on_torch_and_equals_the_jax_store(fuse):
    jinst, tinst = j_genomes(**GKW), t_genomes(**GKW)
    init = genomes_payloads(jinst)
    jl = jswirl.trace(jinst).optimize(RULES).lower(
        "jax", placement="auto", network=jsched.NetworkModel.preset("two-rack"),
        devices=jax.devices("cpu")[:1], fuse=fuse)
    tl = tswirl.trace(tinst).optimize(RULES).lower(
        "torch", placement="auto", network=tsched.NetworkModel.preset("two-rack"),
        platform="cpu", fuse=fuse)
    assert tl.options["schedule"] is tl.plan.schedule_report
    assert tl.plan.fingerprint() == jl.plan.fingerprint()
    jres = jl.compile(genomes_fns(jinst, init, jnp.sum, lambda: jnp.ones(G_ELEMS, jnp.float32))
                      ).run(initial_payloads=dict(init))
    tres = tl.compile(genomes_fns(tinst, init, torch.sum, lambda: torch.ones(G_ELEMS))
                      ).run(initial_payloads=dict(init))
    assert_stores_close(tres.data, jres.data)
    assert tres.stats["comms"] == jres.stats["comms"]
    hand = tswirl.trace(tinst).optimize(RULES).lower("torch", platform="cpu").compile(
        genomes_fns(tinst, init, torch.sum, lambda: torch.ones(G_ELEMS))).run(
        initial_payloads=dict(init))
    assert tres.stats["comms"] <= hand.stats["comms"]


def test_lower_auto_quickstart_and_its_refusals():
    plan = tswirl.trace(EDGES, mapping=MAPPING).optimize()
    lowered = plan.lower("torch", placement="auto",
                         network=tsched.NetworkModel.preset("two-rack"), platform="cpu")
    res = lowered.compile(quickstart_steps()).run()
    assert res.payload(lowered.plan.placement()["evaluate"][0], "d^evaluate") == 54
    with pytest.raises(ValueError, match="auto"):
        plan.lower("torch", placement="automatic")
    with pytest.raises(TypeError, match="network"):
        plan.lower("torch", network=tsched.NetworkModel.preset("uniform"))
    with pytest.raises(TypeError, match="objective"):
        plan.lower("torch", placement={"evaluate": ("gpu1",)}, objective="bytes")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 9])
@pytest.mark.parametrize("net", ["two-rack", "cpu+accelerator", "two-rack-explicit"])
def test_device_map_of_a_schedule_equals_the_jax_backends(monkeypatch, net, k):
    monkeypatch.setattr(torch_backend, "resolve_device", lambda d: d)
    jinst, tinst = j_genomes(**GKW), t_genomes(**GKW)
    jplan = jswirl.trace(jinst).optimize(RULES).schedule(preset(jsched, net))
    tplan = tswirl.trace(tinst).optimize(RULES).schedule(preset(tsched, net))
    devices = list(range(k))  # stand-ins: the map only indexes the list
    jmap = JaxMeshProgram(program=jplan.exec_program(), steps={}, options={
        "devices": devices, "schedule": jplan.schedule_report})._device_map()
    tmap = TorchDeviceProgram(program=tplan.exec_program(), steps={}, options={
        "devices": devices, "schedule": tplan.schedule_report})._device_map()
    assert tmap == jmap
    plain = TorchDeviceProgram(program=tplan.exec_program(), steps={},
                               options={"devices": devices})._device_map()
    locs = sorted(tplan.exec_program().locations())
    assert plain == {loc: i % k for i, loc in enumerate(locs)}  # round-robin, no schedule


def test_plan_profile_predicts_the_reference_timeline():
    jinst, tinst = j_genomes(**GKW), t_genomes(**GKW)
    init = genomes_payloads(jinst)
    jplan = jswirl.trace(jinst).optimize(RULES).schedule(jsched.NetworkModel.preset("two-rack"))
    tplan = tswirl.trace(tinst).optimize(RULES).schedule(tsched.NetworkModel.preset("two-rack"))
    jres = jplan.lower("jax", trace=True, devices=jax.devices("cpu")[:1]).compile(
        genomes_fns(jinst, init, jnp.sum, lambda: jnp.ones(G_ELEMS, jnp.float32))).run(
        initial_payloads=dict(init))
    tres = tplan.lower("torch", trace=True, platform="cpu").compile(
        genomes_fns(tinst, init, torch.sum, lambda: torch.ones(G_ELEMS))).run(
        initial_payloads=dict(init))
    jnet, tnet = jplan.schedule_report.network, tplan.schedule_report.network
    for kw in ({}, {"exec_slots": 1}):
        jrep = jplan.profile(jres, network=jnet, **kw)
        trep = tplan.profile(tres, network=tnet, **kw)
        assert trep.backend == "torch"
        assert trep.predicted_makespan == jrep.predicted_makespan
        assert trep.predicted_cross_bytes == jrep.predicted_cross_bytes
        assert trep.actual_cross_bytes == jrep.actual_cross_bytes
        assert [(d.step, d.predicted_start, d.predicted_s) for d in trep.drifts] == [
            (d.step, d.predicted_start, d.predicted_s) for d in jrep.drifts]
        assert trep.unmatched_predicted == jrep.unmatched_predicted == ()
        assert trep.unmatched_actual == jrep.unmatched_actual == ()
        assert "predicted vs actual [torch]" in trep.summary()
    with pytest.raises(ValueError, match="trace=True"):
        tplan.profile(tplan.lower("torch", platform="cpu").compile(
            genomes_fns(tinst, init, torch.sum, lambda: torch.ones(G_ELEMS))).run(
            initial_payloads=dict(init)))


def test_cost_model_from_the_ports_profile():
    tinst = t_genomes(n=2, m=2, a=1, b=1, c=1)
    init = {("l^d", d): np.ones(256, np.float32) for d in tinst.g("l^d")}
    plan = tswirl.trace(tinst).optimize()
    res = plan.lower("torch", trace=True, platform="cpu").compile(
        genomes_fns(tinst, init, torch.sum, lambda: torch.ones(256))).run(
        initial_payloads=dict(init))
    model = tsched.CostModel.from_profile(res.profile)
    durations = res.profile.exec_durations()
    assert set(model.costs) == set(plan.steps()) == set(durations)
    for step, samples in durations.items():
        assert model.exec_s(step) == sum(samples) / len(samples) > 0
    replan = tswirl.trace(tinst).optimize().schedule(costs=model)
    assert replan.profile(res, costs=model).predicted_makespan > 0
