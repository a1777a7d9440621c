"""Int8 gradient compression with error feedback (cross-pod sync).

The port of ``repro.optim.compress``.  The SWIRL ``gradsync`` step exchanges
each pod's gradient as int8 with one fp32 scale a row (the last axis):
``scale = max(absmax / 127, 1e-12)``, ``q = clip(round(g / scale), ±127)``
with ``torch.round`` rounding half to even, as ``jnp.round`` does.  The
quantisation residual is kept and added to the next step's gradient (error
feedback), so the compression bias telescopes.

Each leaf is quantised once; the reference maps its quantiser twice and
leaves the duplicate to XLA's CSE.  The arithmetic is the reference's, so
the results are equal bit for bit on the same inputs.  While a profiler
records, the three functions are the spans ``optim.compress``,
``optim.decompress`` and ``optim.allreduce_mean``
(:func:`repro_torch.obs.span`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._bridge import tree_leaves, tree_map, tree_unflatten
from repro_torch.obs.events import span

PyTree = Any


class Compressed(NamedTuple):
    q: PyTree  # int8 leaves
    scale: PyTree  # fp32 per-row scales


def _quant_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    absmax = torch.amax(torch.abs(g32), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress(grads: PyTree, error: PyTree | None = None) -> tuple[Compressed, PyTree]:
    """Quantise ``grads + error``; returns (compressed, new error feedback)."""
    with span("optim.compress"):
        gs = tree_leaves(grads)
        es = [None] * len(gs) if error is None else tree_leaves(error)
        qs, ss, errs = [], [], []
        for g, e in zip(gs, es):
            corrected = g.float() + (0.0 if e is None else e)  # + 0.0 as the reference: -0 → +0
            q, s = _quant_leaf(corrected)
            qs.append(q)
            ss.append(s)
            errs.append(corrected - _dequant_leaf(q, s))
        return (
            Compressed(q=tree_unflatten(grads, qs), scale=tree_unflatten(grads, ss)),
            tree_unflatten(grads, errs),
        )


def decompress(c: Compressed) -> PyTree:
    with span("optim.decompress"):
        return tree_unflatten(c.q, [_dequant_leaf(q, s) for q, s in zip(tree_leaves(c.q), tree_leaves(c.scale))])


def allreduce_mean(parts: list[PyTree]) -> PyTree:
    """Host-side mean of decompressed pod gradients (gradsync step body):
    summed in part order, then divided by the number of parts."""
    with span("optim.allreduce_mean"):
        n = float(len(parts))
        out = parts[0]
        for p in parts[1:]:
            out = tree_unflatten(out, [a + b for a, b in zip(tree_leaves(out), tree_leaves(p))])
        return tree_map(lambda a: a / n, out)


def compressed_bytes(c: Compressed) -> int:
    qb = sum(l.numel() for l in tree_leaves(c.q))
    sb = sum(l.numel() * 4 for l in tree_leaves(c.scale))
    return qb + sb
