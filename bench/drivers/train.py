"""The ``train`` driver: the port's SWIRL-planned ``Trainer``, iterations back
to back.

Set-up builds one ``repro_torch.launch.train.Trainer`` as the cell states it
(pods, int8 error-feedback gradient sync, batch, sequence length, the LR
schedule's length, no checkpoint step), gives it the benchmark's weights,
fresh AdamW state and the benchmark's rows, and drives it through its first
three iterations, which the reference follows (and which warm up every
shape).  From them it keeps the readings ``check`` compares: each
iteration's reported loss (the last pod's, as the trainer reports it), each
leaf's norm of the first gradient as AdamW got it (its first moment after
one step over ``1 - b1``) and of the params' change over the three.  The
window then runs the same object's ``iteration`` from iteration 3 until
``seconds`` have passed: ``train_tok_s`` is the tokens of the iterations it
completed over the time from the first one's start to the last one's end.

Cell parameters: ``pods``, ``global_batch``, ``seq_len``, ``lr_steps``,
``optimizer`` (AdamW's settings, held against the trainer's own), and
``limits`` (``loss_gap``, ``grad_norm_gap``, ``update_norm_gap``).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from bench.counts import flops
from bench.harness import core, port, weights
from bench.harness.profile import profiled
from bench.harness.rows import Rows
from bench.reference import train_step

FOLLOWED = 3  # iterations the reference follows


@dataclass
class State:
    ctx: object
    trainer: object
    next_it: int = 0
    losses: list = field(default_factory=list)
    grad_norms: torch.Tensor | None = None
    first_grad: list | None = None  # host copies of each leaf, before the int8 sync
    update_norms: torch.Tensor | None = None


def rows(ctx) -> Rows:
    wl, m = ctx.cell.workload, ctx.cell.model
    return Rows(m["vocab"], wl["seq_len"], wl["global_batch"], weights.mix(ctx.seed, 2_000_000))


def norms(tree) -> torch.Tensor:
    return train_step.leaf_norms([t for _, t in weights.flatten(tree)])


def setup(ctx, plant=None) -> State:
    """The trainer, driven through its first ``FOLLOWED`` iterations.
    ``plant(trainer)``, when given, breaks its path first (the checks' own
    tests)."""
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import adamw

    wl = ctx.cell.workload
    tr = Trainer(port.config(ctx.cell.config), steps=wl["lr_steps"], n_pods=wl["pods"],
                 global_batch=wl["global_batch"], seq_len=wl["seq_len"], ckpt_dir=None,
                 compress_grads=True, device=ctx.device)
    opt = tr.update_fn.args[0]
    if dataclasses.asdict(opt) != wl["optimizer"]:
        raise ValueError(f"the trainer's AdamW settings {dataclasses.asdict(opt)} are not the cell's")
    start = weights.make_params(ctx.cell.model, ctx.seed, ctx.device)
    tr.params, tr.opt_state, tr.dataset = start, adamw.init(start), rows(ctx)
    if plant is not None:
        plant(tr)
    st = State(ctx, tr)
    for it in range(FOLLOWED):
        met = tr.iteration(it)
        st.losses.append(float(met["loss"]))
        if it == 0:
            st.grad_norms, st.first_grad = first_gradient(tr, opt, met["grad_norm"])
    st.update_norms = train_step.leaf_norms(
        [(a.float() - b.float()) for (_, a), (_, b) in zip(weights.flatten(tr.params), weights.flatten(start))])
    del start
    st.next_it = FOLLOWED
    _sync(ctx.device)
    return st


def first_gradient(tr, opt, grad_norm: float) -> tuple[torch.Tensor, list]:
    """From the trainer's state after its first step: each leaf's norm of the
    gradient as AdamW got it (its first moment over ``1 - b1``), and host
    copies of the pods' mean gradient before the int8 sync (AdamW's mean
    gradient, unclipped by the reported global norm, plus the mean of the
    pods' error-feedback residuals, which hold what the quantiser dropped)."""
    got = [t / (1 - opt.b1) for _, t in weights.flatten(tr.opt_state.m)]
    unclip = 1.0 / min(1.0, opt.clip_norm / max(grad_norm, 1e-12))
    errs = [[t for _, t in weights.flatten(tr.err[i])] for i in range(tr.n_pods)]
    pre = [(g * unclip + sum(e[k] for e in errs) / tr.n_pods).cpu() for k, g in enumerate(got)]
    return train_step.leaf_norms(got), pre


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def measure(st: State) -> dict:
    ctx = st.ctx
    wl = ctx.cell.workload
    t0 = time.monotonic()
    ends = [t0]
    while ends[-1] - t0 < ctx.seconds:
        st.trainer.iteration(st.next_it)
        st.next_it += 1
        ends.append(time.monotonic())
    _sync(ctx.device)
    seconds = time.monotonic() - t0
    n = len(ends) - 1
    its = sorted(b - a for a, b in zip(ends, ends[1:]))
    print(f"window: {seconds:.3f} s, {n} iterations; ms an iteration median {1e3 * its[n // 2]:.2f}, "
          f"min {1e3 * its[0]:.2f}, max {1e3 * its[-1]:.2f}", file=sys.stderr)
    tokens = n * wl["global_batch"] * wl["seq_len"]
    return {
        "metrics": {"train_tok_s": tokens / seconds},
        "attempted": n,
        "record": {"window": {"seconds": seconds,
                              "flops": n * flops.train_iteration(ctx.cell.model, wl["global_batch"], wl["seq_len"])}},
    }


def profile(st: State) -> dict:
    """One iteration, with the trainer's ``update_fn`` inside a
    ``bench.update_fn`` range (its results untouched)."""
    from torch.profiler import record_function

    tr = st.trainer
    update = tr.update_fn

    def spanned(*args, **kw):
        with record_function("bench.update_fn"):
            return update(*args, **kw)

    tr.update_fn = spanned
    try:
        record = profiled(lambda: tr.iteration(st.next_it), st.ctx.trace_path)
    finally:
        tr.update_fn = update
    st.next_it += 1
    record.update(cell=st.ctx.cell.workload, model=st.ctx.cell.model, steps=1)
    return record


def readings(st: State) -> dict:
    """The program's readings of its first ``FOLLOWED`` iterations."""
    return {"loss": torch.tensor(st.losses), "grad": st.grad_norms, "grad_leaves": st.first_grad,
            "update": st.update_norms}


def gaps(got: dict, want: dict) -> dict:
    """What a run reads against the reference: the widest relative gap of an
    iteration's loss; the worst leaf's gap of the first gradient's norm and
    of the params' change (leaves that the reference's gradient leaves still
    left out of the latter); and the median and the worst leaf of the pods'
    mean gradient before the int8 sync, each leaf's ``|g - g_ref|`` against
    the larger of its own and the median leaf's reference norm."""
    dev = want["grad"].device
    loss, ref_loss = got["loss"].to(dev), want["loss"].to(dev)
    ref_norms = train_step.leaf_norms(want["grad_leaves"])
    floor = torch.clamp_min(ref_norms, torch.median(ref_norms)).clamp_min(1e-30)
    diff = train_step.leaf_norms([a.to(dev) - b for a, b in zip(got["grad_leaves"], want["grad_leaves"])]) / floor
    return {
        "loss_gap": float(((loss - ref_loss).abs() / ref_loss.abs()).max()),
        "grad_norm_gap": train_step.worst_leaf_gap(got["grad"].to(dev), want["grad"]),
        "update_norm_gap": train_step.worst_leaf_gap(got["update"].to(dev), want["update"], want["moved"]),
        "grad_diff_median": float(torch.median(diff)),
        "grad_diff_worst": float(diff.max()),
    }


def release(st: State) -> None:
    st.trainer = None
    gc.collect()
    if str(st.ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()


def check(st: State) -> dict:
    lim = st.ctx.cell.workload["limits"]
    got = readings(st)
    release(st)
    values = gaps(got, reference(st.ctx))
    checks = [(k, values[k], lim[k]) for k in lim]
    return {"checks": checks, "failed": int(any(v > l for _, v, l in checks)),
            "readings": {k: v for k, v in values.items() if k not in lim}}


def reference(ctx, mm=None) -> dict:
    """The reference's readings of the first ``FOLLOWED`` iterations, from
    the seed alone: the last pod's loss at each, each leaf's norm of the
    first gradient as AdamW gets it and of the params' change, and which
    leaves move: those whose unclipped gradient's norm is at least a
    thousandth of the median leaf's.  The forward is the configuration's
    reference (its file's ``reference`` key); ``mm`` its ``fp32_mm`` by
    default."""
    wl, m = ctx.cell.workload, ctx.cell.model
    ref = core.load_reference(ctx.cell.config, ctx.root)
    named = weights.flatten(weights.make_params(m, ctx.seed, ctx.device))
    paths = [p for p, _ in named]
    start = [t.float() for _, t in named]
    stored = [t.dtype for _, t in named]
    del named
    data = rows(ctx)
    batches = [
        [tuple(torch.from_numpy(b[k]).to(ctx.device) for k in ("tokens", "labels"))
         for b in (data.batch(it, shard=i, n_shards=wl["pods"]) for i in range(wl["pods"]))]
        for it in range(FOLLOWED)
    ]

    def forward(leaves, tokens, labels, mm_):
        return ref.forward_loss(m, weights.unflatten(paths, leaves), tokens, labels, mm_)

    out = train_step.run(m, wl["optimizer"], start, stored, batches, forward, mm or ref.fp32_mm)
    raw = out["grad_raw"]
    return {
        "loss": torch.tensor([pods[-1] for pods in out["loss"]]),
        "grad": out["grad"],
        "grad_leaves": out["grad_pre"],
        "update": train_step.leaf_norms([a - b for a, b in zip(out["params"], start)]),
        "moved": raw >= 1e-3 * torch.median(raw),
    }
