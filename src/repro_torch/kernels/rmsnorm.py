"""Fused RMSNorm — hand-written CUDA kernel (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm.py`` (Pallas, TPU).  The kernel holds each
row in registers and reads it once; :func:`plan` maps rows to threads by
width, so the grid covers the rows exactly and nothing is padded.  On a CPU
tensor the wrapper returns the plain version of ``ref.py``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, ref

VALUES = 32  # most values of a row one thread holds (csrc kMaxValues)
MAX_THREADS = 256  # threads of a block (csrc kMaxThreads)
MAX_D = VALUES * MAX_THREADS

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)

_fns: dict = {}


class Plan(NamedTuple):
    vec: int  # elements a load: 16 bytes' worth, or 1 (the scalar path)
    n: int  # loads of x a thread
    warps: int  # warps a row
    rows: int  # rows a block


@functools.lru_cache(maxsize=None)
def _plan(d: int, esize: int, aligned: bool) -> Plan:
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm takes 0 < d <= {MAX_D}, got d = {d}")
    vec = 16 // esize
    if not aligned or d % vec:
        vec = 1
    pieces, most = d // vec, VALUES // vec
    if pieces <= 32 * most:  # d <= 1024: a warp a row, four rows a block
        return Plan(vec, -(-pieces // 32), 1, 4)
    # A group of warps a row: the fewest idle lanes, then the fewest threads.
    choices = []
    for warps in range(2, MAX_THREADS // 32 + 1):
        n = -(-pieces // (32 * warps))
        if n <= most:
            choices.append((32 * warps * n - pieces, warps, n))
    _, warps, n = min(choices)
    return Plan(vec, n, warps, max(1, 4 // warps))


def plan(d: int, dtype: torch.dtype, addr_bits: int = 0) -> Plan:
    """How the kernel maps rows of width ``d`` to threads.

    ``addr_bits`` is the bitwise or of the byte addresses of x, w and y and
    of their byte row strides.  Unless it is a multiple of 16 and a row is a
    whole number of 16-byte pieces, the kernel takes the scalar path
    (``vec`` 1).  A thread holds ``vec * n`` <= 32 values; d <= 1024 gets a
    warp a row and four rows a block, a wider row a group of warps.
    """
    return _plan(d, dtype.itemsize, addr_bits & 15 == 0)


def _kernel(name: str = "rmsnorm_launch"):
    """The library's launcher, or ``rmsnorm_empty_launch``: the same
    arguments and checks, launching an empty kernel on the same grid."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("rmsnorm"), name)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, LL, I, LL, LL, ctypes.c_float, I, I, I, I, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def launch_args(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, out=None):
    """``(y, args)``: the output and the launcher's arguments for a CUDA
    ``x``, with ``args`` None when x has no rows.  Raises as :func:`rmsnorm`."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda tensors, got {x.device}")
    dev, shape = x.device, x.shape
    d = shape[-1]
    if x.dtype not in _build.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes fp32 or bf16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if w.shape != (d,) or w.device != dev or w.stride(0) != 1:
        raise ValueError(
            f"w must be a contiguous [{d}] on {dev}, got {tuple(w.shape)} with "
            f"strides {w.stride()} on {w.device}"
        )
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm takes 0 < d <= {MAX_D}, got d = {d}")
    if x.is_contiguous():
        rows, xs = x.numel() // d, d
    else:
        x = x.reshape(-1, d)
        if x.stride(1) != 1:
            x = x.contiguous()
        rows, xs = x.shape[0], x.stride(0)
    if out is None:
        y, ys = torch.empty(shape, dtype=x.dtype, device=dev), d
    else:
        if out.shape != shape or out.dtype != x.dtype or out.device != dev:
            raise ValueError(
                f"out must be {x.dtype} {tuple(shape)} on {dev}, got "
                f"{out.dtype} {tuple(out.shape)} on {out.device}"
            )
        y2 = out if out.dim() == 2 else out.view(-1, d)
        if y2.stride(1) != 1:
            raise ValueError(f"out must have unit stride along d, got strides {out.stride()}")
        y, ys = out, y2.stride(0)
    if rows == 0:
        return y, None
    es = x.element_size()
    px, pw, py = x.data_ptr(), w.data_ptr(), y.data_ptr()
    p = _plan(d, es, (px | pw | py | xs * es | ys * es) & 15 == 0)
    return y, (
        px, pw, py, rows, d, xs, ys, eps, _build.DTYPE_CODE[x.dtype], p.vec, p.n, p.warps, p.rows,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, out=None) -> torch.Tensor:
    """``x [..., d]``, ``w [d]`` → ``x·rsqrt(mean(x²)+eps)·(1+w)`` in x's dtype.

    ``out``, if given, is written and returned: x's shape and dtype, unit
    stride along d, any row stride, not overlapping x.
    """
    global launches
    if x.device.type == "cpu":
        y = ref.rmsnorm_ref(x, w, eps=eps)
        return y if out is None else out.copy_(y)
    y, args = launch_args(x, w, eps, out)
    if args is None:
        return y
    index = x.device.index
    if index == torch.cuda.current_device():
        rc = _kernel()(*args)
    else:
        with torch.cuda.device(index):
            rc = _kernel()(*args)
    _build.check("rmsnorm", rc)
    launches += 1
    return y
