"""The decode step replayed from a CUDA graph (``launch/steps.ServeStep``).

On the CPU: the rule that chooses between the graph and the eager step, the
eager path's counters, and the reader of ``graph_replay_share.decode`` on a
synthetic record.  On the card (``-m card``; they skip here): replayed steps
equal eager ones bit for bit and launch the same kernels, a profiled replay
records its kernels, a new cache or new params bring a new capture, and
dropping the step frees its graph and the params it held::

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_serve_graph.py
"""

from __future__ import annotations

import dataclasses
import gc
import json
import weakref

import pytest
import torch

from bench.harness import core
from repro_torch import obs
from repro_torch._bridge import tree_leaves
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch.steps import (
    ServeStep,
    _addresses,
    abstract_cache,
    abstract_params,
    make_prefill_step,
    make_serve_step,
    why_eager,
)
from repro_torch.models import Model
from repro_torch.models.hints import ShardHints, set_hints

OFF_CARD = "the token or the cache is not on a CUDA device"
RECURRENT = "the cache holds an entry that the step replaces (a recurrent state)"


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA device (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m card")


def smoke(arch: str, device: str = "cpu"):
    model = Model(get_config(arch, smoke=True), device)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


def prefilled(model, params, batch: int, prompt: int, rows: int, seed: int = 1):
    """A cache after a prefill of random prompts, and the prefill's token [B, 1]."""
    dev = model.device
    prompts = torch.randint(0, model.cfg.vocab, (batch, prompt), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    cache = model.init_cache(batch, rows)
    tok, cache = make_prefill_step(model)(params, {"tokens": prompts}, cache)
    return tok[:, None], cache


# -- the rule (CPU) ----------------------------------------------------------------------


def test_an_attention_cache_passes_every_rule_but_the_device():
    model, params = smoke("llama3.2-3b")
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 2, 5, 8)
        assert why_eager(params, cache, tok) == OFF_CARD
        assert _addresses(cache) == tuple((t.data_ptr(), t.shape, t.stride())
                                          for e in cache["layers"] for t in (e["k"], e["v"]))
    with torch.no_grad():
        assert why_eager(params, cache, tok) == OFF_CARD
    assert why_eager(params, cache, tok) == "grad is on"


def test_meta_inputs_run_eagerly():
    model, _ = smoke("deepseek-moe-16b")
    params, cache = abstract_params(model), abstract_cache(model, 2, 8)
    with torch.inference_mode():
        assert why_eager(params, cache, torch.empty((2, 1), dtype=torch.int32, device="meta")) == OFF_CARD


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_a_recurrent_state_keeps_the_eager_step(arch):
    model, params = smoke(arch)
    with torch.inference_mode():
        cache = model.init_cache(2, 8)
        assert why_eager(params, cache, torch.zeros((2, 1), dtype=torch.int32)) == RECURRENT
        assert _addresses(cache) is None


def test_hints_keep_the_eager_step():
    model, params = smoke("llama3.2-3b")
    with torch.inference_mode():
        cache = model.init_cache(2, 8)
        set_hints(ShardHints(mesh=None, dp_axes=("data",)))
        try:
            assert why_eager(params, cache, torch.zeros((2, 1), dtype=torch.int32)) == "sharding hints are set"
        finally:
            set_hints(None)


def test_dtensors_keep_the_eager_step():
    import torch.distributed as dist
    from datetime import timedelta

    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_mesh

    model, params = smoke("llama3.2-3b")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        tok = DTensor.from_local(torch.zeros((2, 1), dtype=torch.int32), mesh, [Replicate(), Replicate()])
        with torch.no_grad():
            cache = model.init_cache(2, 8)
            assert why_eager(params, cache, tok) == "a DTensor in the cache or the token"
    finally:
        dist.destroy_process_group()


def test_off_the_card_the_step_is_the_eager_one():
    model, params = smoke("granite-moe-1b-a400m")
    step = make_serve_step(model)
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 2, 5, 12)
        twin = {**cache, "len": cache["len"].clone(),
                "layers": [{k: t.clone() for k, t in e.items()} for e in cache["layers"]]}
        kops.reset_launch_counts()
        a, ca = tok, cache
        for _ in range(4):
            a, ca = step(params, ca, a)
        counts = kops.launch_counts()
        kops.reset_launch_counts()
        b, cb = tok, twin
        for _ in range(4):
            b, cb = step._eager(params, cb, b)
        assert kops.launch_counts() == counts
    assert (step.captures, step.replays) == (0, 0)
    assert torch.equal(a, b) and int(ca["len"]) == int(cb["len"]) == 9


# -- the reader of graph_replay_share.decode (CPU) ---------------------------------------

ANCHOR = (100.0, 230 * 7_889_238 * 1_000_000_000 + 1_000_000_000)  # trace us 1e6 is monotonic 100 s


def row(name, thread, s, e):
    raw = lambda us: 100.0 + us * 1e-6  # noqa: E731 — offsets from trace us 1e6
    return ("span", str(thread), name, raw(s), raw(e), None, None, None, None)


def read_share(monkeypatch, rows):
    record = {  # one launch inside each step, on its thread
        "stretch": (1e6, 1e6 + 1000.0),
        "device": [("k0", 1e6 + 200, 100, 0), ("k1", 1e6 + 600, 100, 1)],
        "launches": {0: (7, 1e6 + 150), 1: (7, 1e6 + 550)},
    }
    monkeypatch.setattr(obs, "take", lambda: (ANCHOR, list(rows)))
    return core.load_reader("graph_replay_share.decode").read(record)


@pytest.mark.parametrize("replays, share", [
    ([("serve.decode.replay", 7, 110, 390), ("serve.decode.replay", 7, 510, 790)], 100.0),
    ([("serve.decode.replay", 7, 510, 790)], 50.0),
    ([("serve.decode.replay", 8, 110, 390)], 0.0),  # another thread's span
    ([("serve.decode.replay", 7, 350, 450)], 0.0),  # not inside a step
    ([], 0.0),  # the program before the graph: steps, no replay span
])
def test_the_reader_counts_the_steps_that_hold_a_replay(monkeypatch, replays, share):
    rows = [row("serve.decode", 7, 100, 400), row("serve.decode", 7, 500, 800)] + [row(*r) for r in replays]
    assert read_share(monkeypatch, rows) == pytest.approx(share)


def test_the_reader_reads_nothing_without_spans(monkeypatch):
    assert read_share(monkeypatch, []) is None


# -- on the card ------------------------------------------------------------------------

STEPS = 16
CUT = {"deepseek-moe-16b": 3, "granite-moe-1b-a400m": 4, "llama3.2-3b": 4, "gemma2-27b": 4}


def full_width(arch: str):
    """``arch`` at its published widths, depth cut to :data:`CUT`, on the card."""
    model = Model(dataclasses.replace(get_config(arch), n_layers=CUT[arch]), "cuda")
    return model, model.init(torch.Generator(device="cuda").manual_seed(0))


def twin_of(cache):
    return {**cache, "len": cache["len"].clone(),
            "layers": [{k: t.clone() for k, t in e.items()} for e in cache["layers"]]}


def run(fn, params, cache, tok, n: int):
    """``n`` steps of ``fn`` from ``tok``: every token, the last cache, the launch counts."""
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    toks = []
    for _ in range(n):
        tok, cache = fn(params, cache, tok)
        toks.append(tok)
    torch.cuda.synchronize()
    return toks, cache, kops.launch_counts()


@pytest.mark.card
@pytest.mark.parametrize("arch", list(CUT))
def test_replayed_steps_equal_eager_steps_bit_for_bit(card, arch):
    model, params = full_width(arch)
    step = ServeStep(model)
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 8, 40, 40 + STEPS + 2)
        twin = twin_of(cache)
        got, gcache, gcounts = run(step, params, cache, tok, STEPS)
        want, ecache, ecounts = run(step._eager, params, twin, tok, STEPS)
        assert (step.captures, step.replays) == (1, STEPS - 1)
        assert gcounts == ecounts and sum(ecounts.values()) > 0
        # Compared after the last step: no step's token was overwritten by a later one.
        assert all(torch.equal(a, b) for a, b in zip(got, want)), arch
        assert int(gcache["len"]) == int(ecache["len"]) == 40 + STEPS
        for a, b in zip(gcache["layers"], ecache["layers"]):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        la, _ = model.decode_step(params, got[-1], gcache)
        lb, _ = model.decode_step(params, want[-1], ecache)
        assert torch.equal(la, lb)


def device_ops(trace_path) -> tuple[int, int]:
    """(device ops, those launched by a ``cudaGraphLaunch``) in a Chrome trace."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"] if e.get("ph") == "X"]
    graph = {(e.get("args") or {}).get("correlation") for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "GraphLaunch" in e["name"]}
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return len(dev), sum((e.get("args") or {}).get("correlation") in graph for e in dev)


@pytest.mark.card
def test_a_profiled_replay_records_its_kernels(card, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    model, params = full_width("granite-moe-1b-a400m")
    step = ServeStep(model)
    counted = {}
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 8, 40, 40 + 10)
        tok, cache = step(params, cache, tok)  # eager on the side stream, then the capture
        tok, cache = step._eager(params, cache, tok)  # the eager path's own per-stream state, made here
        for name, fn in (("replay", step), ("eager", step._eager)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    tok, cache = fn(params, cache, tok)
                torch.cuda.synchronize()
            path = tmp_path / f"{name}.json"
            prof.export_chrome_trace(str(path))
            counted[name] = device_ops(path)
    (replay, in_graph), (eager, _) = counted["replay"], counted["eager"]
    # The eager step's operations, replayed, and one copy in and one out a step.
    assert in_graph == eager and replay == eager + 2 * 2, counted


@pytest.mark.card
def test_a_new_cache_or_new_params_bring_a_new_capture(card):
    model, params = full_width("granite-moe-1b-a400m")
    step = ServeStep(model)
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 8, 40, 48)
        run(step, params, cache, tok, 3)
        first = weakref.ref(step._graph)
        tok2, cache2 = prefilled(model, params, 8, 40, 48, seed=2)  # made while the first is alive: elsewhere
        dropped = weakref.ref(cache["layers"][0]["k"])
        del cache
        gc.collect()
        assert dropped() is None  # the graph reads the cache by address and does not hold it
        twin = twin_of(cache2)
        got, _, _ = run(step, params, cache2, tok2, 3)
        want, _, _ = run(step._eager, params, twin, tok2, 3)
        gc.collect()
        assert step.captures == 2 and first() is None
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        second = weakref.ref(step._graph)
        again = {**params}  # the same leaves in a new tree: keyed by the tree's identity
        twin = twin_of(cache2)
        more, _, _ = run(step, again, cache2, got[-1], 3)
        want, _, _ = run(step._eager, params, twin, got[-1], 3)
        gc.collect()
        assert step.captures == 3 and second() is None and step.replays == 2 + 2 + 2
        assert all(torch.equal(a, b) for a, b in zip(more, want))


@pytest.mark.card
def test_a_new_cache_where_the_last_one_lay_replays_the_graph(card):
    model, params = full_width("granite-moe-1b-a400m")
    step = ServeStep(model)
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 8, 40, 48)
        run(step, params, cache, tok, 3)
        # A new cache in the same memory, as the allocator hands a dropped cache's blocks back out.
        fresh = {"len": torch.zeros_like(cache["len"]),
                 "layers": [{k: t.zero_() for k, t in e.items()} for e in cache["layers"]]}
        prompts = torch.randint(0, model.cfg.vocab, (8, 40), dtype=torch.int32, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(2))
        tok2, cache2 = make_prefill_step(model)(params, {"tokens": prompts}, fresh)
        tok2 = tok2[:, None]
        twin = twin_of(cache2)
        got, _, _ = run(step, params, cache2, tok2, 4)
        want, _, _ = run(step._eager, params, twin, tok2, 4)
        assert (step.captures, step.replays) == (1, 2 + 4)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.card
def test_dropping_the_step_frees_its_graph_and_the_params(card):
    model, params = full_width("granite-moe-1b-a400m")
    step = ServeStep(model)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    with torch.inference_mode():
        tok, cache = prefilled(model, params, 8, 40, 48)
        run(step, params, cache, tok, 4)
    held = weakref.ref(tree_leaves(params)[0])
    del params
    gc.collect()
    torch.cuda.synchronize()
    assert held() is not None  # the graph reads the params
    before = torch.cuda.memory_allocated()
    del step
    gc.collect()
    torch.cuda.synchronize()
    assert held() is None
    assert before - torch.cuda.memory_allocated() >= param_bytes
