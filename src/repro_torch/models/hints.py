"""Distribution hints — the beyond-paper collective optimisations.

The port of ``repro.models.hints``.  Without hints the model leaves every
intermediate's placement to DTensor's sharding propagation, the counterpart
of the reference's GSPMD baseline.  With hints installed (``set_hints``),
the model constrains its activations explicitly and runs attention and the
MoE FFN on local shards:

* H1: attention head-parallel (``Hkv`` divides the TP degree) or with
  sequence-sharded queries and replicated K/V (``layers.attention_block``);
* H2: expert-local MoE dispatch with one TP sum (``moe.apply_moe_sharded``);
* H4: a sequence-sharded residual stream between blocks
  (``model._apply_stack``).

Hints are process-global (like the attention-impl switch), so the same model
code serves the baseline and the hinted plan.  Under hints the model's
tensors are DTensors on ``hints.mesh``: place the params first
(``launch.sharding.distribute_params``); :func:`constrain` raises on a plain
tensor and converts nothing silently.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Placement
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.mesh import axis_size


@dataclass(frozen=True)
class ShardHints:
    mesh: Any  # a DeviceMesh
    dp_axes: tuple[str, ...]  # batch axes, e.g. ("data",) or ("pod", "data")
    tp_axis: str = "model"
    seq_shard_attention: bool = True  # H1 (GQA with Hkv ∤ tp)
    head_shard_attention: bool = True  # H1b (MHA/GQA with Hkv | tp)
    local_moe_dispatch: bool = True  # H2
    seq_parallel_residual: bool = True  # H4 (Megatron-SP residual stream)

    @property
    def tp_size(self) -> int:
        return axis_size(self.mesh, self.tp_axis)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= axis_size(self.mesh, a)
        return n

    def dp_spec(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]


_HINTS: ShardHints | None = None


def set_hints(hints: ShardHints | None) -> None:
    global _HINTS
    _HINTS = hints


def get_hints() -> ShardHints | None:
    return _HINTS


def placements(*spec, mesh=None) -> tuple:
    """The DTensor placements of ``P(*spec)`` on ``mesh`` (the installed
    hints' mesh by default)."""
    from repro_torch.launch.sharding import NamedSharding, PartitionSpec

    return NamedSharding(_HINTS.mesh if mesh is None else mesh, PartitionSpec(*spec)).placements


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` redistributed to ``P(*spec)`` under the installed hints (no-op
    without); ``x`` must be a DTensor on the hints' mesh."""
    h = _HINTS
    if h is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            "hints are installed but got a plain tensor: place the params on the hints' mesh first "
            "(launch.sharding.distribute_params)"
        )
    return x.redistribute(h.mesh, placements(*spec))


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor
    (``t`` holds the same values on every rank); else ``t``.  The model makes
    its RoPE tables, masks and constants as plain tensors; this places them
    where they meet a DTensor (kept for the backward too, which
    ``implicit_replication`` would not cover)."""
    if not isinstance(x, DTensor):
        return t
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def unshard(x: torch.Tensor, dims=None) -> torch.Tensor:
    """A DTensor ``x`` gathered along ``dims`` (every dim by default) where
    it is sharded, its other placements kept; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import Replicate

    dims = range(x.ndim) if dims is None else [d % x.ndim for d in dims]
    pl = [Replicate() if any(p.is_shard(d) for d in dims) else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  On DTensors, ``x`` is first gathered along the dims between
    its first and last (a sequence-sharded residual before a column-parallel
    matmul: Megatron-SP's all-gather), and the product is :func:`pin`-ned:
    a matmul flattens those dims, forward and backward, which some versions
    of DTensor cannot do for a sharded one."""
    if not isinstance(x, DTensor):
        return x @ w
    return pin(unshard(x, range(1, x.ndim - 1)) @ w)


def pin(t: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` as it is, with a backward that brings its gradient to
    ``t``'s placements; a plain tensor as it is.  After a reshape that
    merges dims, this keeps the reshape's backward (a split) off a gradient
    sharded in a way that the split cannot carry."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over each group."""

    @staticmethod
    def forward(ctx, groups, x):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return None, grad


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``s``."""

    @staticmethod
    def forward(ctx, s, x):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, grad * ctx.s


def shard_map(body: Callable, mesh, in_placements, out_placements) -> Callable:
    """``body`` on each rank's local shards, as ``jax.shard_map`` with
    ``check_vma=False`` runs it, on DTensor's ``local_map``.

    ``in_placements`` gives each argument's placements (``None`` for an
    argument that is not a tensor); ``out_placements`` is the output's
    placements, or a tuple of them when ``body`` returns a tuple.  The
    arguments are redistributed to their placements first; a plain tensor
    where placements are given raises.  Gradients follow JAX's transpose of
    ``shard_map``: an output's cotangent is divided by the number of ranks
    that hold it replicated, and an input's gradient is summed over the mesh
    dims that it is replicated on.  So a replicated input (a weight, or
    activations replicated over TP) gets the whole gradient, and a sum over
    ranks inside ``body`` (an autograd ``all_reduce``, whose backward sums
    too) is neither dropped nor counted twice.
    """

    def replicated(pl) -> list[int]:
        return [k for k, p in enumerate(pl) if p.is_replicate() and mesh.size(k) > 1]

    in_groups = [() if pl is None else tuple(mesh.get_group(k) for k in replicated(pl)) for pl in in_placements]
    single = isinstance(out_placements[0], Placement)  # one output's placements, not one per output
    outs_pl = (out_placements,) if single else out_placements
    out_scale = [1.0 / math.prod(mesh.size(k) for k in replicated(pl)) for pl in outs_pl]

    def local(*args):
        args = [_SumGrad.apply(g, a) if g else a for a, g in zip(args, in_groups)]
        outs = body(*args)
        outs = (outs,) if single else outs
        outs = tuple(_ScaleGrad.apply(s, o) if s != 1.0 else o for o, s in zip(outs, out_scale))
        return outs[0] if single else outs

    # local_map reads a tuple as one placements per output, a list as one output's
    mapped = local_map(local, out_placements=list(outs_pl[0]) if single else tuple(map(list, outs_pl)),
                       in_placements=tuple(None if pl is None else list(pl) for pl in in_placements),
                       device_mesh=mesh, redistribute_inputs=True)

    def call(*args):
        for a, pl in zip(args, in_placements, strict=True):
            if pl is not None and not isinstance(a, DTensor):
                raise TypeError(
                    "shard_map got a plain tensor for a placed argument: place the params on the mesh first "
                    "(launch.sharding.distribute_params)"
                )
        return mapped(*args)

    return call
