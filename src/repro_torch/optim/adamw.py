"""AdamW with warmup-cosine schedule and global-norm clipping.

The port of ``repro.optim.adamw``: ``init`` builds fp32 moments whatever the
param dtype (bf16 params, fp32 state); ``update`` returns new params cast
back to the param dtype.  The schedule and the bias corrections
``b1**step``, ``b2**step`` are fp32 tensors, as the reference computes them
(Python floats would round otherwise).

``update`` is functional: it returns new trees and leaves its arguments as
they were, so a step that a fault policy retries after a partial failure is
applied once.  Each leaf is computed once (the reference maps its update
three times and leaves the duplicate arithmetic to XLA's CSE), and its
intermediates are made in place in the update's own tensors, so that eager
PyTorch holds few of them at once where XLA fuses them away.

On DTensors (params placed by ``launch.sharding.param_specs``, moments by
``optim.zero.zero1_specs``) the same arithmetic runs sharded, and each new
param is placed as its param was.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch._bridge import tree_leaves, tree_map, tree_unflatten

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: PyTree
    v: PyTree


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio × lr``."""
    step = step.to(torch.float32)
    dev = step.device
    warm = step / _f32(max(1.0, cfg.warmup_steps), dev)
    t = (step - cfg.warmup_steps) / _f32(max(1.0, cfg.total_steps - cfg.warmup_steps), dev)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: PyTree) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def update(
    cfg: AdamWConfig,
    grads: PyTree,
    state: AdamWState,
    params: PyTree,
) -> tuple[PyTree, AdamWState, dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - _f32(cfg.b1, dev) ** step.to(torch.float32)
    b2c = 1.0 - _f32(cfg.b2, dev) ** step.to(torch.float32)

    def upd(p, g, m, v):
        # The reference's arithmetic, op for op, with each intermediate made
        # in place in a tensor that this function allocated (never in an
        # argument: ``float()`` of an fp32 leaf is the leaf itself), so that
        # a leaf holds at most five fp32 temporaries of its size at once
        # (gemma2's 1.18 B-row embedding: 4.7 GB each).
        g = g.float() * scale
        m = torch.mul(m, cfg.b1).add_(torch.mul(g, 1 - cfg.b1))
        v = torch.mul(v, cfg.b2).add_(torch.mul(g, 1 - cfg.b2).mul_(g))
        del g
        den = torch.div(v, b2c).sqrt_().add_(cfg.eps)
        delta = torch.div(m, b1c).div_(den)
        del den
        delta.add_(torch.mul(p.float(), cfg.weight_decay)).mul_(lr)
        new_p = torch.sub(p.float(), delta).to(p.dtype)
        if isinstance(p, DTensor):  # ZeRO-1: moments sharded over data, the update gathered
            new_p = new_p.redistribute(p.device_mesh, p.placements)
        return new_p, m, v

    new = [
        upd(p, g, m, v)
        for p, g, m, v in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v)
        )
    ]
    return (
        tree_unflatten(params, [n[0] for n in new]),
        AdamWState(
            step=step,
            m=tree_unflatten(state.m, [n[1] for n in new]),
            v=tree_unflatten(state.v, [n[2] for n in new]),
        ),
        {"grad_norm": gnorm, "lr": lr},
    )
