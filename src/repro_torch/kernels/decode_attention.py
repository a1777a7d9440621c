"""Decode attention — hand-written CUDA kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py`` (Pallas, TPU): one query row
per sequence against an over-allocated cache of which the first ``kv_len``
rows are valid.  ``kv_len`` may be a device int32 scalar, read by the kernel
itself (as Pallas scalar-prefetches it), so a decode step never waits on the
device.  The kernel reads nothing at or past ``kv_len`` and takes the cache
through its strides, so the model's ``[B, M, Hkv, d]`` cache is passed as a
transposed view and never copied; it copies cache rows in 16-byte pieces, so
the cache must be 16-byte aligned (any cache from ``torch.empty`` is).  A CPU tensor gets the plain version of
``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

HEAD_DIMS = (64, 128, 192)
MAX_GROUP = 8  # query heads per KV head (csrc kMaxG)

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [P, P, P, P, P, I]  # q, k, v, o, kv_len ptr/val
            + [I] * 5  # B, Hq, Hkv, Lk, d
            + [LL] * 10  # q (b, h), k (b, h, l), v (b, h, l), o (b, h)
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
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), kv_ptr, kv_val,
            b, hq, hkv, lk, d,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1),
            _build.DTYPE_CODE[q.dtype], _build.stream_of(q),
        )
    _build.check("decode_attention", rc)
    launches += 1
    return o
