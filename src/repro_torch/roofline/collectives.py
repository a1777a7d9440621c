"""Collective traffic of a step, counted as it runs: the counterpart of
``repro.roofline.hlo``.

The reference parses the collectives out of XLA's partitioned HLO text.
Torch emits no HLO; its collectives are ops that pass through the dispatcher,
so :class:`CollectiveCounter`, a ``TorchDispatchMode``, records each one as
it runs: the functional collectives that DTensor issues
(``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single`` and their coalesced forms,
``_dtensor.shard_dim_alltoall``) and the in-place ``c10d`` ops of
``torch.distributed`` (the model's autograd all-reduces).  Shapes are
per-device, as in an SPMD module, and per-chip link traffic follows the
reference's ring-algorithm terms:

    all-gather          out_bytes · (n−1)/n
    reduce-scatter      out_bytes · (n−1)
    all-reduce          2 · bytes · (n−1)/n
    all-to-all          bytes · (n−1)/n
    collective-permute  bytes

A broadcast (none of the model's) counts its bytes once, as a permute.

The counter returns ``NotImplemented`` for an op on DTensors, as
``CommDebugMode`` does, so that DTensor first turns it into the collectives
and local ops of each rank, which then reach the counter; its counts equal
``CommDebugMode().get_comm_counts()``.  It counts every collective that runs
(a loop runs its body's collectives each time), so the reference's
``body_scale`` has no counterpart.  ``top`` names each collective by the
DTensor op that issued it (or ``redistribute``), the autograd node when it
ran in the backward, and the innermost frame of the port that called it.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass
class CollectiveStats:
    # per-op: count, per-device result bytes, per-device link traffic
    count: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    result_bytes: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    link_bytes: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # the part of link_bytes whose group spans more than one node
    network_bytes: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # attribution: (link_bytes, op, group_size, scale, op_name) heaviest first
    top: list[tuple[float, str, int, int, str]] = field(default_factory=list)

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())

    @property
    def total_network_bytes(self) -> float:
        return sum(self.network_bytes.values())

    def as_dict(self, *, top_n: int = 12) -> dict:
        return {
            "count": dict(self.count),
            "result_bytes": dict(self.result_bytes),
            "link_bytes": {k: float(v) for k, v in self.link_bytes.items()},
            "total_link_bytes": float(self.total_link_bytes),
            "network_bytes": {k: float(v) for k, v in self.network_bytes.items()},
            "total_network_bytes": float(self.total_network_bytes),
            "top": [
                {
                    "link_bytes": b,
                    "op": o,
                    "group": g,
                    "scale": s,
                    "op_name": n,
                }
                for b, o, g, s, n in sorted(self.top, reverse=True)[:top_n]
            ],
        }


def _ring_traffic(op: str, nbytes: int, n: int) -> float:
    if op == "collective-permute":
        # point-to-point: each device ships its buffer once
        return float(nbytes)
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return nbytes * (n - 1)
    if op == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if op == "all-to-all":
        return nbytes * (n - 1) / n
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(op)


def _op_table() -> dict:
    """Torch op packet → the reference's op name, for every collective that
    ``CommDebugMode`` counts (built on first use: ``torch.ops`` resolves
    lazily)."""
    f, fa, c = torch.ops._c10d_functional, torch.ops._c10d_functional_autograd, torch.ops.c10d
    legacy = torch.ops.c10d_functional
    table = {
        f.all_gather_into_tensor: "all-gather", f.all_gather_into_tensor_coalesced: "all-gather",
        f.reduce_scatter_tensor: "reduce-scatter", f.reduce_scatter_tensor_coalesced: "reduce-scatter",
        f.all_reduce: "all-reduce", f.all_reduce_coalesced: "all-reduce",
        f.all_to_all_single: "all-to-all", fa.all_to_all_single: "all-to-all",
        f.broadcast: "broadcast",
        legacy.all_gather_into_tensor: "all-gather", legacy.all_gather_into_tensor_coalesced: "all-gather",
        legacy.reduce_scatter_tensor: "reduce-scatter", legacy.reduce_scatter_tensor_coalesced: "reduce-scatter",
        legacy.all_reduce: "all-reduce", legacy.all_reduce_coalesced: "all-reduce",
        legacy.all_to_all_single: "all-to-all", legacy.broadcast: "broadcast",
        torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
        c._allgather_base_: "all-gather", c.allgather_: "all-gather", c.allgather_coalesced_: "all-gather",
        c.allgather_into_tensor_coalesced_: "all-gather",
        c._reduce_scatter_base_: "reduce-scatter", c.reduce_scatter_: "reduce-scatter",
        c.reduce_scatter_tensor_coalesced_: "reduce-scatter",
        c.allreduce_: "all-reduce", c.allreduce_coalesced_: "all-reduce",
        c.alltoall_: "all-to-all", c.alltoall_base_: "all-to-all",
        c.broadcast_: "broadcast", c.gather_: "broadcast", c.scatter_: "broadcast", c.reduce_: "broadcast",
    }
    return table


_OPS: dict | None = None


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group(args) -> dist.ProcessGroup:
    """The process group of a collective's arguments: a ``group_name`` string
    (functional ops) or a boxed ``ProcessGroup`` (``c10d`` ops)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a)
    return _resolve_process_group(next(a for a in reversed(args) if isinstance(a, str)))


def _caller() -> tuple[bool, str]:
    """Whether the collective runs inside DTensor's dispatch of an op (not
    an explicit ``redistribute``), and ``file:line function`` of the
    innermost frame of the port outside this package (or ``""``)."""
    in_dispatch = False
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith("_dispatch.py") and "distributed" in name:
            in_dispatch = True
        if "repro_torch" in name and "roofline" not in name:
            where = name[name.rindex("repro_torch") + len("repro_torch/"):]
            return in_dispatch, f"{where}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return in_dispatch, ""


class CollectiveCounter(TorchDispatchMode):
    """Records every collective that runs while it is active into
    :attr:`stats`.  ``gpus_per_node`` places global ranks on nodes (rank //
    gpus_per_node): a collective whose group spans nodes adds its link bytes
    to ``network_bytes`` too."""

    def __init__(self, *, gpus_per_node: int = 8):
        super().__init__()
        global _OPS
        if _OPS is None:
            _OPS = _op_table()
        self.gpus_per_node = gpus_per_node
        self.stats = CollectiveStats()
        self._issuer = ""  # the last op on DTensors, which DTensor is desugaring
        self._spans: dict[str, bool] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator) or any(issubclass(t, FakeTensor) for t in types):
            # a higher-order op runs its body through here; fake tensors are
            # DTensor's shape propagation, which runs nothing
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            # Let DTensor desugar the op into collectives and local ops first.
            self._issuer = str(func)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = _OPS.get(func._overloadpacket)
        if op is not None:
            self._record(op, args, out)
        else:
            self.local_op(func, types, args, kwargs, out)
        return out

    def local_op(self, func, types, args, kwargs, out) -> None:
        """Called for every op that is not a collective; subclasses count."""

    def _record(self, op: str, args, out) -> None:
        pg = _group(args)
        n = pg.size()
        # result bytes per device: the op's output, or the tensors it wrote
        written = _tensors(out) or _tensors(args[0])
        nbytes = _nbytes(written)
        traffic = nbytes if op == "broadcast" else _ring_traffic(op, nbytes, n)
        key = "collective-permute" if op == "broadcast" else op
        st = self.stats
        st.count[key] += 1
        st.result_bytes[key] += nbytes
        st.link_bytes[key] += traffic
        if self._spans_nodes(pg):
            st.network_bytes[key] += traffic
        node = torch._C._current_autograd_node()
        in_dispatch, frame = _caller()
        where = " ".join(x for x in (
            self._issuer if in_dispatch else "redistribute",
            f"in {node.name()}" if node is not None else "",
            frame,
        ) if x)
        st.top.append((traffic, key, n, 1, where))

    def _spans_nodes(self, pg) -> bool:
        name = pg.group_name
        if name not in self._spans:
            ranks = dist.get_process_group_ranks(pg)
            self._spans[name] = len({r // self.gpus_per_node for r in ranks}) > 1
        return self._spans[name]
