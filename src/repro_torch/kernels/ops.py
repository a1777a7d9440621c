"""Model-layout wrappers around the three kernels, and their launch counts.

The model keeps activations as ``[B, L, H, d]`` and its cache as
``[B, M, Hkv, d]``.  Where ``repro.kernels.ops`` transposes q/k/v (and the
whole cache, every decode step) into the kernels' ``[B, H, L, d]``, these
wrappers pass transposed *views*: the kernels take strides, so nothing is
copied.  Each kernel module counts its own launches in a plain integer;
:func:`launch_counts` reads the three and :func:`reset_launch_counts` zeroes
them.
"""

from __future__ import annotations

import torch

from . import _build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import rmsnorm as _rmsnorm

_MODULES = {"rmsnorm": _rmsnorm, "flash_attention": _flash, "decode_attention": _decode}


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0, kv_len=None):
    """q: [B, Lq, Hq, d]; k/v: [B, Lk, Hkv, d] (model layout) → [B, Lq, Hq, d]."""
    out = _flash.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, kv_len=kv_len, q_offset=q_offset,
    )
    return out.transpose(1, 2)


def decode_attention(q, k, v, kv_len):
    """q: [B, 1, Hq, d]; k/v cache: [B, M, Hkv, d] → [B, 1, Hq, d]."""
    out = _decode.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), kv_len)
    return out[:, None]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    return _rmsnorm.rmsnorm(x, w, eps=eps)


def build() -> dict[str, float]:
    """Build every kernel now (in parallel); returns seconds per kernel."""
    return _build.build()


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
