"""Plain fp32 reference of the SWIRL training iteration: pods, int8 gradient
sync with error feedback, and AdamW with a warmup-cosine schedule.

Each iteration, as the training workflow states it: every pod takes its
rows ``i::n_pods`` of the global batch and computes its loss and gradient
(the ``forward_loss`` of the configuration's reference); each pod's gradient plus its carried
error is quantised to int8 with one fp32 scale a row of the last axis
(``scale = max(absmax / 127, 1e-12)``, ``q = clip(round(g / scale), +-127)``,
rounding half to even) and the residual carried to its next iteration; the
dequantised gradients are summed in pod order and divided by their number;
AdamW clips that mean to a global norm of ``clip_norm`` and steps every
leaf.  The params are stored in the dtype the configuration states for
each leaf (bf16 but the fp32 router), so each new param is rounded to it;
the moments stay fp32.  Every product is fp32 with TF32 off unless ``mm``
says otherwise (the fp8 control).
"""

from __future__ import annotations

import math

import torch

from .moe_decoder import exact_fp32, fp32_mm


def lr_at(opt: dict, step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(1.0, opt["warmup_steps"])
    t = min(max((step - opt["warmup_steps"]) / max(1.0, opt["total_steps"] - opt["warmup_steps"]), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def quantise(g: torch.Tensor) -> torch.Tensor:
    """int8 round trip with one scale a row of the last axis."""
    scale = torch.clamp_min(g.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(g / scale), -127, 127) * scale


def run(m: dict, opt: dict, params: list[torch.Tensor], stored: list[torch.dtype], batches, forward, mm=fp32_mm):
    """Train ``params`` (fp32 leaves, in a fixed order) for ``len(batches)``
    iterations; ``batches[s]`` is the list of each pod's ``(tokens, labels)``
    and ``forward(leaves, tokens, labels, mm)`` gives a pod's
    ``(loss, ce, aux)``.

    Returns the readings the benchmark compares: each pod's loss at each
    iteration; of the first iteration, each leaf's norm of the clipped mean
    gradient as the optimizer gets it and of the unclipped one, and the
    pods' mean gradient before the int8 sync; and the params after the last
    iteration.
    """
    n_pods = len(batches[0])
    err = [None] * n_pods
    mom = [torch.zeros_like(p) for p in params]
    var = [torch.zeros_like(p) for p in params]
    out = {"loss": []}
    with exact_fp32():
        for s, pods in enumerate(batches):
            total, pre, losses = None, None, []
            for i, (tokens, labels) in enumerate(pods):
                leaves = [p.detach().requires_grad_() for p in params]
                loss, _, _ = forward(leaves, tokens, labels, mm)
                grads = torch.autograd.grad(loss, leaves)
                losses.append(float(loss.detach()))
                corrected = [g + (0.0 if e is None else e) for g, e in zip(grads, err[i] or [None] * len(grads))]
                deq = [quantise(c) for c in corrected]
                err[i] = [c - q for c, q in zip(corrected, deq)]
                total = deq if total is None else [a + b for a, b in zip(total, deq)]
                if s == 0:
                    pre = list(grads) if pre is None else [a + b for a, b in zip(pre, grads)]
                del leaves, grads, corrected
            mean = [t / float(n_pods) for t in total]
            out["loss"].append(losses)
            step = s + 1
            gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in mean))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
            lr = lr_at(opt, step)
            b1c, b2c = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step
            new = []
            for k, (p, g) in enumerate(zip(params, mean)):
                g = g * scale
                mom[k] = opt["b1"] * mom[k] + (1 - opt["b1"]) * g
                var[k] = opt["b2"] * var[k] + (1 - opt["b2"]) * g * g
                delta = (mom[k] / b1c) / (torch.sqrt(var[k] / b2c) + opt["eps"])
                delta = lr * (delta + opt["weight_decay"] * p)
                new.append((p - delta).to(stored[k]).float())
            if s == 0:
                out["grad"] = leaf_norms([g * scale for g in mean])
                out["grad_raw"] = leaf_norms(mean)
                out["grad_pre"] = [g / float(n_pods) for g in pre]
            del total, pre, mean
            params = new
    out["params"] = params
    return out


def leaf_norms(ts) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in ts])


def worst_leaf_gap(got: torch.Tensor, want: torch.Tensor, include: torch.Tensor | None = None) -> float:
    """The widest gap between two per-leaf norms, each measured against the
    larger of the reference's norm of that leaf and of its median leaf."""
    gap = (got - want).abs() / torch.clamp_min(want, torch.median(want)).clamp_min(1e-30)
    return float((gap if include is None else gap[include]).max())
