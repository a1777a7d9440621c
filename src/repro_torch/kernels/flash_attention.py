"""Flash attention (prefill) — hand-written CUDA kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py`` (Pallas, TPU) and extends it by
``q_offset``, the absolute position of query row 0, so that a prefill over a
cache that already holds ``q_offset`` rows reaches it.  Unlike the TPU kernel
it takes any ``Lq`` and ``Lk`` (the ragged edge is masked, nothing is
padded) and tensors of any strides with a unit stride along ``d``: the model
passes transposed views of its ``[B, L, H, d]`` tensors and the cache is
never copied.  ``kv_len`` and ``q_offset`` may be device int32 scalars, which
the kernel reads itself.  Probabilities are not rounded to bf16 alone for
``P·V``: bf16 splits them into two bf16 halves on the tensor cores, fp32 keeps
them fp32 on the CUDA cores.  bf16 inputs are read by TMA, so their bases and
strides must be multiples of 16 bytes.  A CPU tensor gets the plain version of
``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

HEAD_DIMS = (64, 128, 192)

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [P, P, P, P, P, I, P, I]  # q, k, v, o, q_offset ptr/val, kv_len ptr/val
            + [I] * 6  # B, Hq, Hkv, Lq, Lk, d
            + [LL] * 12  # (b, h, l) strides of q, k, v, o
            + [I, I, ctypes.c_float, I, P]  # causal, window, softcap, dtype, stream
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bhl(t: torch.Tensor) -> list[int]:
    return [t.stride(0), t.stride(1), t.stride(2)]


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Lq, d]
    k: torch.Tensor,  # [B, Hkv, Lk, d]
    v: torch.Tensor,  # [B, Hkv, Lk, d]
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_len=None,  # valid KV rows (≤ Lk): int, device int32 scalar, or None = Lk
    q_offset=0,  # absolute position of query row 0: int or device int32 scalar
) -> torch.Tensor:
    """Returns ``[B, Hq, Lq, d]`` laid out like ``q`` (``empty_like``)."""
    global launches
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            kv_len=kv_len, q_offset=q_offset,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if q.dtype not in _build.DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)) or not (k.device == v.device == q.device):
        raise ValueError("q, k, v must lie on one device with unit stride along head_dim")
    if q.dtype == torch.bfloat16 and any(
        t.data_ptr() % 16 or any(s * 2 % 16 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
        for t in (q, k, v)
    ):
        raise ValueError("bf16 q, k, v must be 16-byte aligned, base and (b, h, l) strides")
    kv_ptr, kv_val = _build.scalar_arg(lk if kv_len is None else kv_len, q.device, "kv_len")
    off_ptr, off_val = _build.scalar_arg(q_offset, q.device, "q_offset")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            off_ptr, off_val, kv_ptr, kv_val,
            b, hq, hkv, lq, lk, d,
            *_bhl(q), *_bhl(k), *_bhl(v), *_bhl(o),
            int(causal), int(window), float(softcap),
            _build.DTYPE_CODE[q.dtype], _build.stream_of(q),
        )
    _build.check("flash_attention", rc)
    launches += 1
    return o
