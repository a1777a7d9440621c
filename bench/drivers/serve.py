"""The ``serve`` driver: static batches of greedy requests through the port's
prefill and decode steps, back to back (a closed loop).

Each batch is what ``repro_torch.launch.serve.generate`` runs: a fresh
cache from ``Model.init_cache``, one ``make_prefill_step`` call over the
batch's prompts, then ``make_serve_step`` calls, each token copied to the
host as it is made.  The next batch is prefilled when the last one ends.
Prompts are drawn from the seed, batch by batch; lengths are fixed by the
cell.

The window starts at the first batch's prefill and ends at the first step
that ends past ``seconds``: ``serve_tok_s`` is every token made in it
(the prefill's first token of each request included) over its length;
``itl_p95_ms`` the 95th percentile of the gaps between consecutive tokens
of each request (a decode step and its copy to the host; prefill is not a
gap).  ``check`` takes one batch that finished in the window, drawn from
the seed, and holds every token it served against the fp32 reference.

Cell parameters (``workloads/<cell>.json``): ``batch``, ``prompt_len``,
``gen``, ``warmup_steps``, ``profile_after``, ``profile_steps``, and
``limits`` (``gap_max``, ``gap_mean``).
"""

from __future__ import annotations

import gc
import random
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench.counts import flops
from bench.harness import core, port, weights
from bench.harness.profile import profiled


@dataclass
class State:
    ctx: object
    model: object
    params: dict | None
    prefill: object
    step: object
    batches: list = field(default_factory=list)  # (batch index, served tokens [B, n])


def prompts(ctx, index: int) -> torch.Tensor:
    """Batch ``index``'s prompts, int32 ``[batch, prompt_len]``, drawn from the seed."""
    wl, m = ctx.cell.workload, ctx.cell.model
    gen = torch.Generator(device=ctx.device).manual_seed(weights.mix(ctx.seed, 1_000_000 + index))
    return torch.randint(0, m["vocab"], (wl["batch"], wl["prompt_len"]), generator=gen,
                         device=ctx.device, dtype=torch.int32)


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def setup(ctx, plant=None) -> State:
    """Weights, model, steps and a warm-up batch.  ``plant(state)``, when
    given, breaks the timed path first (the checks' own tests)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    model = port.model(ctx.cell.config, ctx.device)
    params = weights.make_params(ctx.cell.model, ctx.seed, ctx.device)
    port.build_kernels(ctx.device)
    st = State(ctx, model, params, make_prefill_step(model), make_serve_step(model))
    if plant is not None:
        plant(st)
    # Warm up the cell's two shapes: its prefill and its decode step.
    for _ in _batch(st, prompts(ctx, -1), ctx.cell.workload["warmup_steps"]):
        pass
    _sync(ctx.device)
    return st


def _batch(st: State, batch_prompts: torch.Tensor, steps: int):
    """Prefill then ``steps`` decode steps; yields each step's tokens on the host."""
    wl = st.ctx.cell.workload
    cache = st.model.init_cache(wl["batch"], wl["prompt_len"] + wl["gen"])
    with torch.inference_mode():
        tok, cache = st.prefill(st.params, {"tokens": batch_prompts}, cache)
        yield tok.cpu()
        tok = tok[:, None]
        for _ in range(steps):
            tok, cache = st.step(st.params, cache, tok)
            yield tok[:, 0].cpu()


def measure(st: State) -> dict:
    ctx = st.ctx
    wl, m = ctx.cell.workload, ctx.cell.model
    b, l0, g = wl["batch"], wl["prompt_len"], wl["gen"]
    t0 = time.monotonic()
    deadline = t0 + ctx.seconds
    gaps, n_tokens, work, index, t_last = [], 0, 0, 0, t0
    while t_last < deadline:
        served = []
        for j, tok in enumerate(_batch(st, prompts(ctx, index), g - 1)):
            t = time.monotonic()
            served.append(tok.numpy())
            n_tokens += b
            if j == 0:
                work += flops.prefill(m, b, l0)
            else:
                gaps.append(t - t_last)
                work += flops.decode_step(m, b, l0 + j)
            t_last = t
            if t >= deadline:
                break
        st.batches.append((index, np.stack(served, axis=1)))
        index += 1
    seconds = t_last - t0
    steps_ms = np.asarray(gaps) * 1e3
    print(f"window: {seconds:.3f} s, {index} batches, {len(gaps)} decode steps; step ms median "
          f"{np.median(steps_ms):.3f}, min {steps_ms.min():.3f}, max {steps_ms.max():.3f}", file=sys.stderr)
    return {
        "metrics": {
            "serve_tok_s": n_tokens / seconds,
            "itl_p95_ms": float(np.percentile(np.repeat(np.asarray(gaps), b), 95)) * 1e3,
        },
        "attempted": b * index,
        "record": {"window": {"seconds": seconds, "flops": work}},
    }


def profile(st: State) -> dict:
    """``profile_steps`` decode steps of a fresh batch, after ``profile_after``."""
    ctx = st.ctx
    wl = ctx.cell.workload
    steps = _batch(st, prompts(ctx, 10_000_000), wl["profile_after"] + wl["profile_steps"])
    for _ in range(1 + wl["profile_after"]):
        next(steps)

    def stretch():
        for _ in range(wl["profile_steps"]):
            next(steps)

    record = profiled(stretch, ctx.trace_path)
    steps.close()
    first = wl["prompt_len"] + wl["profile_after"] + 1  # keys the first profiled step sees
    record.update(
        cell=wl, model=ctx.cell.model, steps=wl["profile_steps"],
        kv_lens=[first + i for i in range(wl["profile_steps"])],
    )
    return record


def release(st: State) -> None:
    """Drop the program's weights and model; the reference runs after."""
    st.params = st.model = st.prefill = st.step = None
    gc.collect()
    if str(st.ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()


def reference_logits(ctx, index: int, served: torch.Tensor, mms=None):
    """The logits of batch ``index``'s served tokens by the configuration's
    reference (its file's ``reference`` key), by each product in ``mms``
    (its ``fp32_mm`` alone by default)."""
    m, ref = ctx.cell.model, core.load_reference(ctx.cell.config, ctx.root)
    return ref.serve_logits(m, lambda grp: weights.make_group(m, grp, ctx.seed, ctx.device),
                            prompts(ctx, index), served, mms or (ref.fp32_mm,))


def numbers(gap: torch.Tensor) -> dict:
    """What a batch's gaps [B, G] read: the widest gap, the mean gap, and
    the worst request's mean gap."""
    return {"gap_max": float(gap.max()), "gap_mean": float(gap.mean()),
            "gap_request_max": float(gap.mean(dim=1).max())}


def check(st: State) -> dict:
    """Every token of one finished batch, drawn from the seed, against the
    reference; the numbers that the cell's ``limits`` name are compared."""
    ctx = st.ctx
    wl = ctx.cell.workload
    lim = wl["limits"]
    finished = [(i, s) for i, s in st.batches if s.shape[1] == wl["gen"]]
    release(st)
    if not finished:
        return {"checks": [("unfinished_batches", 1, 0)], "failed": 0, "readings": {}}
    index, served = random.Random(weights.mix(ctx.seed, 3)).choice(finished)
    served = torch.from_numpy(served).to(ctx.device)
    ref = core.load_reference(ctx.cell.config, ctx.root)
    gap = ref.gaps(reference_logits(ctx, index, served)[0], served)
    got = numbers(gap)
    per_request = lim.get("gap_request_max", lim.get("gap_mean"))
    return {
        "checks": [(k, got[k], lim[k]) for k in lim],
        "failed": int((gap.mean(dim=1) > per_request).sum()),
        "readings": {k: v for k, v in got.items() if k not in lim},
    }
