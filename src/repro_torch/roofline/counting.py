"""What a step costs, counted as it runs on meta tensors: the port's
counterpart of XLA's ``cost_analysis()``.

:func:`count_step` stacks two ``TorchDispatchMode``s over a step:

* the **local** count sees what one rank runs (rank 0 of a ``"fake"``
  process group): every op on plain tensors, which are the local ops that
  DTensor turns each op on DTensors into, the ops of a
  ``hints.shard_map`` body, and their backward.  It gives
  :attr:`StepCost.flops` (per device, replicated work included),
  :attr:`StepCost.bytes_accessed` (each op's operand and result bytes on
  local shards; no fusion, views and ``empty`` excluded) and the collectives
  (:class:`repro_torch.roofline.collectives.CollectiveCounter`, which it
  extends).
* the **global** count sees each op on DTensors once, at its global shapes,
  and not the local ops that DTensor runs for it; an op on plain tensors
  inside a ``shard_map`` body counts its local FLOPs times the number of
  different shards the body runs on (the mesh's ranks over those that hold
  the same inputs).  Its sum, :attr:`StepCost.flops_global`, counts each
  op of the step once over the whole mesh, whatever ranks repeat.

FLOPs are those of ``torch.utils.flop_counter`` (matmuls, convolutions,
attention): elementwise work counts none, as in ``FlopCounterMode``.  A
``shard_map`` body's backward runs outside the body's Python frame, so the
body marks the autograd nodes it made (their ``metadata``) with its
repeat count, and the global count reads the node that is running.
On one rank the two counts are equal.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import hints

from .collectives import CollectiveCounter, CollectiveStats, _nbytes, _tensors

_REPEATS = "repro_torch.roofline.repeats"  # autograd node metadata key


@dataclass
class StepCost:
    flops: float = 0.0  # per device, as rank 0 runs them
    flops_global: float = 0.0  # each op once over the mesh
    bytes_accessed: float = 0.0  # per device, unfused
    ops: int = 0  # local ops counted
    collectives: CollectiveStats = field(default_factory=CollectiveStats)


def _flops(func, args, kwargs, out) -> float:
    return float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))


_NO_BYTES = None


def _no_bytes() -> set:
    a = torch.ops.aten
    return {a.empty, a.empty_strided, a.empty_like, a.new_empty, a.new_empty_strided,
            torch.ops._c10d_functional.wait_tensor, torch.ops._c10d_functional._wrap_tensor_autograd}


class _Local(CollectiveCounter):
    def __init__(self, cost: StepCost, *, gpus_per_node: int):
        super().__init__(gpus_per_node=gpus_per_node)
        global _NO_BYTES
        if _NO_BYTES is None:
            _NO_BYTES = _no_bytes()
        self.cost = cost
        self.stats = cost.collectives

    def local_op(self, func, types, args, kwargs, out) -> None:
        super().local_op(func, types, args, kwargs, out)
        pk = func._overloadpacket
        if pk in flop_registry:
            self.cost.flops += _flops(func, args, kwargs, out)
        if not func.is_view and pk not in _NO_BYTES:
            self.cost.bytes_accessed += _nbytes(_tensors(list(args) + list(kwargs.values()))) + _nbytes(_tensors(out))
            self.cost.ops += 1


class _Global(TorchDispatchMode):
    def __init__(self, cost: StepCost, chips: int):
        super().__init__()
        self.cost = cost
        self.chips = chips
        self._bodies: list[int] = []  # repeat counts of the shard_map bodies running

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) and func._overloadpacket in flop_registry:
            f = _flops(func, args, kwargs, out)
            if not any(issubclass(t, DTensor) for t in types):
                f *= self.chips / self._repeats()
            self.cost.flops_global += f
        return out

    def _repeats(self) -> int:
        """How many ranks run this plain op on the same data: a body's repeat
        count, else every rank (a table or mask made the same everywhere)."""
        if self._bodies:
            return self._bodies[-1]
        node = torch._C._current_autograd_node()
        if node is not None and _REPEATS in node.metadata:
            return node.metadata[_REPEATS]
        return self.chips

    def run_body(self, body, mesh, in_placements, args):
        """``body(*args)`` for ``hints.shard_map``, its ops counted ×
        ``chips / repeats`` where ``repeats`` is the product of the mesh dims
        on which every input is replicated; the autograd nodes it made carry
        ``repeats`` for the backward."""
        placed = [pl for pl in in_placements if pl is not None]
        repeats = math.prod(mesh.size(k) for k in range(mesh.ndim) if all(pl[k].is_replicate() for pl in placed))
        grad = torch.is_grad_enabled()
        if grad:  # nodes made from here on have larger sequence numbers
            probe = torch.empty((), device="meta", requires_grad=True)
            floor = probe.view_as(probe).grad_fn._sequence_nr()
        self._bodies.append(repeats)
        try:
            outs = body(*args)
        finally:
            self._bodies.pop()
        if grad:
            todo = [t.grad_fn for t in _tensors(outs) if t.grad_fn is not None]
            seen = set()
            while todo:
                node = todo.pop()
                if node is None or node in seen or node._sequence_nr() <= floor:
                    continue  # made before the body
                seen.add(node)
                if type(node).__name__ == "AccumulateGrad":
                    continue  # a leaf (its sequence number is the largest there is)
                node.metadata[_REPEATS] = repeats
                todo.extend(f for f, _ in node.next_functions)
        return outs


@contextmanager
def count_step(*, chips: int = 1, gpus_per_node: int = 8):
    """Count the ops run inside the block into the :class:`StepCost` it
    yields; ``chips`` is the mesh's rank count (1 off a mesh)."""
    cost = StepCost()
    glob = _Global(cost, chips)
    with _Local(cost, gpus_per_node=gpus_per_node), glob, hints.body_runner(glob.run_body):
        yield cost
