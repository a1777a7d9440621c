"""MoE slot assignment — hand-written CUDA kernel (``csrc/moe_slots.cu``).

Replaces no TPU kernel: the JAX package leaves the MoE's slots to XLA (a
one-hot, a cumsum and a gather in ``repro/models/moe.py``).  On the card the
plain version's cumsum is ATen's scan along the ``T·k`` rows of a ``[T·k, E]``
one-hot, which walks the rows one at a time in one block: ~175 ns a choice
while the one-hot fits in L2, ~365 ns beyond (281 ms at a 32K-token prefill's
768,000; PERF.md).  The kernel ranks each choice among the earlier choices of
its expert with warp matches and a scan over the block's warps, and holds no
``[T·k, E]`` intermediate.

A call is one launch up to :data:`CHUNK` choices and two above (a count pass,
then the rank pass; :func:`plan`), from shapes alone: nothing is read back,
so a CUDA graph can hold it.  The count pass's scratch is allocated here.
The integers equal the plain version's.  A CPU tensor gets the plain version
of ``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

CHUNK = 4096  # choices a block takes (csrc kChunk): 256 threads of 16
MAX_EXPERTS = 256  # csrc kMaxExperts: one scanning thread an expert
MAX_CHOICES = 1 << 30  # csrc kMaxChoices: the kernel counts in int32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# experts, row stride, k, n, E, C, slot, keep, counts, stream; a call is one or two launches (plan), counted once
LAUNCH = _build.Entry("moe_slots", [_P, _LL, _I, _I, _I, _LL, _P, _P, _P, _P])


def plan(n: int) -> tuple[int, int]:
    """``(chunks, launches)`` for ``n`` choices: the rank pass's blocks, and 1
    launch where one block covers the choices, else 2 (the count pass's
    ``chunks - 1`` blocks first)."""
    chunks = -(-n // CHUNK)
    return chunks, 1 if chunks <= 1 else 2


def moe_slots(experts: torch.Tensor, n_experts: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``experts`` [T, k] int64 → ``(slot [T·k] int64, keep [T·k] bool)``:
    choice ``t·k + j`` takes the next free slot of its expert, and is kept
    below ``capacity``."""
    if experts.device.type != "cuda":
        return _build.stand_in("moe_slots", experts, ref.moe_slots_ref, experts, n_experts, capacity)
    if experts.dtype != torch.int64 or experts.dim() != 2:
        raise TypeError(f"moe_slots takes [T, k] int64 expert ids, got {experts.dtype} {tuple(experts.shape)}")
    if not 0 < n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_slots takes 1 to {MAX_EXPERTS} experts, got {n_experts}")
    t, k = experts.shape
    n = t * k
    if n > MAX_CHOICES:
        raise ValueError(f"moe_slots takes at most {MAX_CHOICES} choices, got {n}")
    dev = experts.device
    slot = torch.empty(n, dtype=torch.int64, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return slot, keep
    if experts.stride(1) != 1:
        experts = experts.contiguous()
    chunks, _ = plan(n)
    counts = torch.empty((chunks - 1) * n_experts, dtype=torch.int32, device=dev) if chunks > 1 else None
    LAUNCH(
        dev, experts.data_ptr(), experts.stride(0), k, n, n_experts, capacity, slot.data_ptr(), keep.data_ptr(),
        None if counts is None else counts.data_ptr(), _build.stream_of(experts),
    )
    return slot, keep
