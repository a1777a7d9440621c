"""The MLA mixer's spans (``model.mla.kv``, ``.attend``, ``.out``) in the
port's process recorder, as ``test_torch_obs_program.py`` holds the MoE's:
off with no profiler, and inside one nested in the serving step that runs
them, once a layer."""

import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import Model
from repro_torch.obs import events

STAGES = ("kv", "attend", "out")


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.take()
    yield
    obs.take()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mla_model():
    cfg = get_config("deepseek-v2-lite", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = Model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def profiling():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def spans(rows):
    return [r for r in rows if r[0] == "span"]


def inside(inner, outer) -> bool:
    return outer[3] <= inner[3] and inner[4] <= outer[4] and inner[1] == outer[1]


def serve(model, params, steps=1):
    cache = model.init_cache(2, 12)
    step = make_serve_step(model)
    with torch.inference_mode():
        tok, cache = make_prefill_step(model)(params, {"tokens": torch.arange(8, dtype=torch.int32).view(2, 4)}, cache)
        tok = tok[:, None]
        for _ in range(steps):
            tok, cache = step(params, cache, tok)


def test_off_the_mla_mixer_reads_no_clock_and_records_nothing(monkeypatch, mla_model):
    def boom():
        raise AssertionError("the MLA mixer read the span clock with no profiler recording")

    monkeypatch.setattr(events, "time", types.SimpleNamespace(monotonic=boom, time_ns=boom))
    serve(*mla_model, steps=2)
    assert len(events._PROCESS) == 0


@pytest.mark.parametrize("step", ["serve.prefill", "serve.decode"])
def test_each_step_nests_the_three_mla_stages_once_a_layer(mla_model, step):
    model, params = mla_model
    with profiling():
        serve(model, params)
    _, rows = obs.take()
    outer = [r for r in spans(rows) if r[2] == step]
    assert len(outer) == 1
    mine = [r for r in spans(rows) if r[2].startswith("model.mla.") and inside(r, outer[0])]
    n = model.cfg.n_layers
    assert sorted(r[2] for r in mine) == sorted(f"model.mla.{s}" for s in STAGES for _ in range(n))
    # In each layer the three follow one another: kv, then attend, then out.
    ordered = sorted(mine, key=lambda r: r[3])
    assert [r[2] for r in ordered] == [f"model.mla.{s}" for _ in range(n) for s in STAGES]
    assert all(a[4] <= b[3] for a, b in zip(ordered, ordered[1:]))
