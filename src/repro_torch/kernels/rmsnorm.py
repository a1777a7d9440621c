"""Fused RMSNorm — hand-written CUDA kernel (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm.py`` (Pallas, TPU).  The kernel gives each
row its own block, so it needs none of the TPU wrapper's row padding.  On a
CPU tensor the wrapper returns the plain version of ``ref.py``; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_launch
        P, LL = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [P, P, P, LL, ctypes.c_int, LL, LL, ctypes.c_float, ctypes.c_int, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x [..., d]``, ``w [d]`` → ``x·rsqrt(mean(x²)+eps)·(1+w)`` in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda tensors, got {x.device}")
    d = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes fp32 or bf16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"w must be [{d}] on {x.device}, got {tuple(w.shape)} on {w.device}")
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    with torch.cuda.device(x.device):
        rc = _kernel()(
            x2.data_ptr(), w.contiguous().data_ptr(), y.data_ptr(), x2.shape[0], d,
            x2.stride(0), y.stride(0), eps, _build.DTYPE_CODE[x.dtype], _build.stream_of(x),
        )
    _build.check("rmsnorm", rc)
    launches += 1
    return y.reshape(x.shape)
