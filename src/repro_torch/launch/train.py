"""SWIRL-planned multi-pod training driver.

The port of ``repro.launch.train``.  Each training iteration is a
distributed workflow instance (per-pod ``shard_i`` → ``fwdbwd_i`` →
synchronised ``gradsync`` → per-pod ``update_i`` → ``ckpt``), translated by
the paper's encoding into per-pod SWIRL traces
(``TrainPipelineTranslator``), optimised with ``("R1R2", "R3")`` and run,
as the reference runs it, by the ``inprocess`` backend with
``RetryPolicy(max_retries=2)``: its thread pool fires the pods' ready steps
at once.  That backend places nothing: every step keeps its tensors on the
model's device, and the param and optimizer trees reach the steps as the
very objects given, so no iteration copies them.

Cross-pod gradients go through int8 error-feedback compression
(:mod:`repro_torch.optim.compress`) unless ``compress_grads=False``.  On
``cuda`` (the default) each ``fwdbwd`` runs the rmsnorm and flash-attention
kernels in its forward and in its remat recompute, with the plain versions'
VJPs behind them (:class:`repro_torch.kernels.ops.KernelWithPlainGrad`);
``device="cpu"`` runs the plain path.  Checkpoints are written in the
reference's layout and leaf names (``params_to_jax``), so either package
resumes from the other's.

While a profiler records, an iteration is the span ``train.iteration``, the
plan's compile inside it ``plan.compile`` (:func:`repro_torch.obs.step_span`),
and its run records an ``exec`` span a step into the process recorder.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 2 --pods 2
"""

from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Any

import torch

from repro_torch import swirl
from repro_torch._bridge import resolve_device, to_torch, tree_leaves, tree_map
from repro_torch.ckpt import async_save, latest_step, load_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.translate import TrainPipelineTranslator
from repro_torch.data import SyntheticLM
from repro_torch.models import Model, ModelConfig, params_from_jax, params_to_jax
from repro_torch.obs.events import step_span
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.compress import allreduce_mean, compress, decompress
from repro_torch.workflow.fault import RetryPolicy

from .steps import make_grad_step

PyTree = Any


def checkpoint_tree(cfg: ModelConfig, params: PyTree, opt: adamw_mod.AdamWState) -> dict:
    """``{"params", "opt": {"step", "m", "v"}}`` in the reference's layout, on the host."""
    host = tree_map(lambda t: t.detach().cpu(), {"params": params, "m": opt.m, "v": opt.v})
    return {
        "params": params_to_jax(host["params"], cfg),
        "opt": {
            "step": opt.step.detach().cpu(),
            "m": params_to_jax(host["m"], cfg),
            "v": params_to_jax(host["v"], cfg),
        },
    }


def build_step_fns(
    grad_fn,
    update_fn,
    dataset: SyntheticLM,
    n_pods: int,
    *,
    compress_grads: bool = True,
    error_feedback: dict[int, PyTree] | None = None,
    ckpt_dir: str | None = None,
    cfg: ModelConfig | None = None,
):
    """Step-name → fn registry for one training iteration (``cfg`` names the
    checkpoint's layout and is needed with ``ckpt_dir``)."""
    if ckpt_dir and cfg is None:
        raise ValueError("build_step_fns needs cfg to write checkpoints")
    err = error_feedback if error_feedback is not None else {}

    fns: dict[str, Any] = {}
    for i in range(n_pods):

        def shard(inputs, i=i):
            step = int(inputs[f"iter_{i}"])
            b = dataset.batch(step, shard=i, n_shards=n_pods)
            return {f"batch_{i}": b}

        def fwdbwd(inputs, i=i):
            params = inputs[f"params_{i}"]
            dev = tree_leaves(params)[0].device
            batch = {k: to_torch(v, dev) for k, v in inputs[f"batch_{i}"].items()}
            grads, metrics = grad_fn(params, batch)
            if compress_grads:
                c, err[i] = compress(grads, err.get(i))
                payload = ("int8", c)
            else:
                payload = ("raw", grads)
            return {f"grad_{i}": (payload, metrics)}

        def update(inputs, i=i):
            params = inputs[f"params_{i}"]
            opt_state = inputs[f"opt_{i}"]
            mean_grads, metrics = inputs["grad_sync"]
            new_params, new_opt, om = update_fn(mean_grads, opt_state, params)
            return {
                f"state_{i}": {
                    "params": new_params,
                    "opt": new_opt,
                    "metrics": {**metrics, **{k: float(v) for k, v in om.items()}},
                }
            }

        fns[f"shard_{i}"] = shard
        fns[f"fwdbwd_{i}"] = fwdbwd
        fns[f"update_{i}"] = update

    def gradsync(inputs):
        parts = []
        metrics = {}
        for i in range(n_pods):
            (kind, payload), metrics = inputs[f"grad_{i}"]
            parts.append(decompress(payload) if kind == "int8" else payload)
        mean = allreduce_mean(parts)
        return {"grad_sync": (mean, {k: float(v) for k, v in metrics.items()})}

    def ckpt(inputs):
        state = inputs["state_0"]
        if ckpt_dir:
            opt = state["opt"]
            saver = async_save(ckpt_dir, int(opt.step), checkpoint_tree(cfg, state["params"], opt))
            saver.wait()
        return {}

    fns["gradsync"] = gradsync
    fns["ckpt"] = ckpt
    return fns, err


class Trainer:
    """One training job: the model, its data, the lowered SWIRL plan of an
    iteration and the replica state.  :func:`train` runs :meth:`iteration`
    ``steps`` times; ``chip_smoke.py`` drives the same object at a cut depth.

    Params start from ``seed`` (the reference's from ``jax.random.key(0)``;
    the two generators differ) unless ``ckpt_dir`` holds a checkpoint, from
    which params, moments and step resume.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        steps: int,
        n_pods: int,
        global_batch: int,
        seq_len: int,
        ckpt_dir: str | None,
        compress_grads: bool = True,
        device="cuda",
        seed: int = 0,
    ):
        dev = resolve_device(device)
        self.cfg, self.n_pods, self.ckpt_dir = cfg, n_pods, ckpt_dir
        self.compress_grads = compress_grads
        self.model = Model(cfg, dev)
        self.dataset = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch)
        opt_cfg = AdamWConfig(warmup_steps=max(2, steps // 10), total_steps=steps)

        # The SWIRL plan for one iteration (encode ∘ optimise).
        translator = TrainPipelineTranslator(n_pods=n_pods, with_checkpoint=ckpt_dir is not None)
        plan = swirl.trace(translator).optimize(rules=("R1R2", "R3"))
        opt_stats, r3_stats = (r.stats for r in plan.rewrites)
        print(
            f"[swirl] plan: {plan.system.total_actions()} actions, "
            f"{plan.system.comm_count()} comms (Def.15 removed "
            f"{opt_stats.removed}, R3 removed {r3_stats.removed})"
        )
        self.lowered = plan.lower("inprocess", retry=RetryPolicy(max_retries=2))

        # Resume or init per-pod replicas (identical params across pods).
        self.params = self.model.init(torch.Generator(device=dev).manual_seed(seed))
        self.opt_state = adamw_mod.init(self.params)
        self.start = 0
        if ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
            like = checkpoint_tree(cfg, self.params, self.opt_state)
            restored = load_checkpoint(ckpt_dir, last, like)
            opt = restored["opt"]
            self.params = params_from_jax(restored["params"], cfg, dev)
            self.opt_state = adamw_mod.AdamWState(
                step=to_torch(opt["step"], dev),
                m=params_from_jax(opt["m"], cfg, dev),
                v=params_from_jax(opt["v"], cfg, dev),
            )
            self.start = int(opt["step"])
            print(f"[ckpt] resumed from step {self.start}")

        self.err: dict[int, PyTree] = {}
        self.grad_fn = make_grad_step(self.model)
        self.update_fn = partial(adamw_mod.update, opt_cfg)

    def step_fns(self) -> dict[str, Any]:
        fns, self.err = build_step_fns(
            self.grad_fn, self.update_fn, self.dataset, self.n_pods,
            compress_grads=self.compress_grads, error_feedback=self.err,
            ckpt_dir=self.ckpt_dir, cfg=self.cfg,
        )
        return fns

    def iteration(self, it: int) -> dict:
        """Run iteration ``it`` of the plan; returns pod 0's metrics."""
        payloads = {}
        for i in range(self.n_pods):
            payloads[(f"pod{i}", f"iter_{i}")] = it
            payloads[(f"pod{i}", f"params_{i}")] = self.params
            payloads[(f"pod{i}", f"opt_{i}")] = self.opt_state
        # ``shard_i``/``fwdbwd_i`` read iter/params from the pod's local data
        # scope: declare them as part of each pod's initial D set.
        with step_span("train.iteration"):
            with step_span("plan.compile"):
                exe = self.lowered.compile(self.step_fns())
            result = exe.run(initial_payloads=payloads)
            state = result.payload("pod0", "state_0")
            self.params, self.opt_state = state["params"], state["opt"]
        return state["metrics"]


def train(
    arch: str,
    *,
    smoke: bool,
    steps: int,
    n_pods: int,
    global_batch: int,
    seq_len: int,
    ckpt_dir: str | None,
    compress_grads: bool = True,
    log_every: int = 5,
    device="cuda",
) -> dict:
    trainer = Trainer(
        get_config(arch, smoke=smoke), steps=steps, n_pods=n_pods,
        global_batch=global_batch, seq_len=seq_len, ckpt_dir=ckpt_dir,
        compress_grads=compress_grads, device=device,
    )
    history = []
    start = trainer.start
    t0 = time.monotonic()
    for it in range(start, start + steps):
        m = trainer.iteration(it)
        history.append(m)
        if (it - start) % log_every == 0:
            print(
                f"step {it:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"gnorm={m.get('grad_norm', 0):.3f}"
            )
    wall = time.monotonic() - t0
    print(f"[done] {steps} steps in {wall:.1f}s ({wall / steps:.2f}s/step)")
    return {"history": history, "params": trainer.params, "opt": trainer.opt_state}


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Train with the PyTorch/CUDA port: one SWIRL plan an iteration."
    )
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-compress", dest="compress", action="store_false")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    train(
        args.arch,
        smoke=args.smoke,
        steps=args.steps,
        n_pods=args.pods,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir,
        compress_grads=args.compress,
        device=args.device,
    )


if __name__ == "__main__":
    main()
