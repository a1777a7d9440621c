"""Decode attention — hand-written CUDA kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py`` (Pallas, TPU): one query row
per sequence against an over-allocated cache of which the first ``kv_len``
rows are valid.  ``kv_len`` may be a device int32 scalar, read by the kernel
itself (as Pallas scalar-prefetches it), so a decode step never waits on the
device.  The kernel reads nothing at or past ``kv_len`` and takes the cache
through its strides, so the model's ``[B, M, Hkv, d]`` cache is passed as a
transposed view and never copied; it copies cache rows in 16-byte pieces, so
the cache must be 16-byte aligned (any cache from ``torch.empty`` is).  The
kernel splits the cache over blocks (:func:`split_chunk`), each writing an
fp32 partial to a scratch tensor allocated here; the last block of each
(sequence, KV head) merges them, so a call is still one launch.  The merge
counts finished blocks in a set of counters that the kernel leaves at zero;
each stream gets its own set, so calls on different streams may run at once.
A CPU tensor gets the plain version of ``ref.py``; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

HEAD_DIMS = (64, 128, 192)
MAX_GROUP = 8  # query heads per KV head (csrc kMaxG)

TILE = 64  # keys a tile of the kernel (csrc kTileK); a split is a multiple of it

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)

_fn = None
# The merge's counters, zero between calls: one set per (device, stream).
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}
_sms: dict[torch.device, int] = {}


def split_chunk(lk: int, b: int, hkv: int, sms: int = 132) -> int:
    """Keys each block of the kernel takes, from the cache's capacity ``lk``.

    ``kv_len`` lives on the device and is never read back, so the split is
    chosen from the capacity: the multiple of :data:`TILE` that gives about
    two blocks for each of the card's ``sms`` SMs (the kernel's shared
    memory fits two a SM), so one wave of blocks covers the cache.  Returns
    at least one tile, and one split when a single block covers the cache.
    """
    per_block = -(-lk * b * hkv // (2 * sms))
    return min(max(TILE, -(-per_block // TILE) * TILE), -(-lk // TILE) * TILE)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [P, P, P, P, P, I]  # q, k, v, o, kv_len ptr/val
            + [I] * 5  # B, Hq, Hkv, Lk, d
            + [LL] * 10  # q (b, h), k (b, h, l), v (b, h, l), o (b, h)
            + [I, P, P]  # chunk, partials, counters
            + [I, P]  # dtype, stream
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention(
    q: torch.Tensor,  # [B, Hq, d] — one new token per sequence
    k: torch.Tensor,  # [B, Hkv, Lk, d] — cache, possibly over-allocated
    v: torch.Tensor,  # [B, Hkv, Lk, d]
    kv_len,  # valid rows: int or device int32 scalar
) -> torch.Tensor:
    """Returns ``[B, Hq, d]`` laid out like ``q`` (``empty_like``)."""
    global launches
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, got {q.device}")
    b, hq, d = q.shape
    _, hkv, lk, _ = k.shape
    if q.dtype not in _build.DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS} or group {hq // hkv} > {MAX_GROUP}")
    if any(t.stride(-1) != 1 for t in (q, k, v)) or not (k.device == v.device == q.device):
        raise ValueError("q, k, v must lie on one device with unit stride along head_dim")
    esize = k.element_size()
    if any(t.data_ptr() % 16 or any(s * esize % 16 for s in t.stride()[:3]) for t in (k, v)):
        raise ValueError("the cache (k, v) must be 16-byte aligned, base and rows")
    kv_ptr, kv_val = _build.scalar_arg(kv_len, q.device, "kv_len")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    dev = q.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = split_chunk(lk, b, hkv, _sms[dev])
    splits = -(-lk // chunk)
    stream = _build.stream_of(q)
    part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=dev)
    counters = _counters.get((dev, stream))
    if counters is None or counters.numel() < b * hkv:
        counters = _counters[dev, stream] = torch.zeros(b * hkv, dtype=torch.int32, device=dev)
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), kv_ptr, kv_val,
            b, hq, hkv, lk, d,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1),
            chunk, part.data_ptr(), counters.data_ptr(),
            _build.DTYPE_CODE[q.dtype], stream,
        )
    _build.check("decode_attention", rc)
    launches += 1
    return o
