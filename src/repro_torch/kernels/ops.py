"""Model-layout wrappers around the three kernels, and their launch counts.

The model keeps activations as ``[B, L, H, d]`` and its cache as
``[B, M, Hkv, d]``.  Where ``repro.kernels.ops`` transposes q/k/v (and the
whole cache, every decode step) into the kernels' ``[B, H, L, d]``, these
wrappers pass transposed *views*: the kernels take strides, so nothing is
copied.  Each kernel module counts its own launches in an integer that
it adds to under a lock, as the ``inprocess`` backend fires the trainer's
pods on threads that launch at once; :func:`launch_counts` reads the three,
:func:`reset_launch_counts` zeroes them, and :func:`add_launch_counts` adds
to them for launches that no wrapper call made (a CUDA graph's replay).

Gradients.  No kernel has a backward kernel, as none of the TPU kernels has
one (the reference defines no ``custom_vjp``).  When grad mode is on and an
input requires grad, :func:`rmsnorm` and :func:`flash_attention` launch
their kernel under :class:`KernelWithPlainGrad`, whose backward recomputes
the plain version of ``ref.py`` on the saved inputs and differentiates it;
otherwise (serving runs under ``torch.inference_mode``) they call the kernel
directly.  Decode attention is for serving only and raises under grad.

The kernels take raw pointers, so a DTensor must never reach them: each
wrapper raises on one.  The model calls them on a DTensor's local shards
(``models.hints.shard_map``).
"""

from __future__ import annotations

import torch

from . import _build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import ref
from . import rmsnorm as _rmsnorm

_MODULES = {"rmsnorm": _rmsnorm, "flash_attention": _flash, "decode_attention": _decode}


class KernelWithPlainGrad(torch.autograd.Function):
    """``kernel(*inputs, **kw)`` forward; the VJP of ``plain(*inputs, **kw)`` backward.

    ``plain`` computes the kernel's function in plain PyTorch.  The backward
    recomputes it on the saved inputs under grad and returns
    ``torch.autograd.grad`` of it, so the gradient is exactly autograd's of
    the plain version at those inputs.
    """

    @staticmethod
    def forward(ctx, kernel, plain, kw, *inputs):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kw)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.kw)
        got = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
        return (None, None, None, *(next(got) if n else None for n in needs))


def _local_only(*ts) -> None:
    """Raise on a DTensor: its ``data_ptr`` is not its shard's."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("a DTensor reached a kernel; call it on the local shards (models.hints.shard_map)")


def _grad_needed(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_bl(q, k, v, **kw):
    """The flash kernel on the model's [B, L, H, d] q, k, v (transposed views)."""
    out = _flash.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


def _flash_ref_bl(q, k, v, **kw):
    """Its plain version on the same layout."""
    out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0, kv_len=None):
    """q: [B, Lq, Hq, d]; k/v: [B, Lk, Hkv, d] (model layout) → [B, Lq, Hq, d]."""
    _local_only(q, k, v, kv_len, q_offset)
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len, q_offset=q_offset)
    if _grad_needed(q, k, v):
        return KernelWithPlainGrad.apply(_flash_bl, _flash_ref_bl, kw, q, k, v)
    return _flash_bl(q, k, v, **kw)


def decode_attention(q, k, v, kv_len):
    """q: [B, 1, Hq, d]; k/v cache: [B, M, Hkv, d] → [B, 1, Hq, d]."""
    _local_only(q, k, v, kv_len)
    if _grad_needed(q, k, v):
        raise RuntimeError(
            "decode attention has no gradient: it serves one token against a KV cache, "
            "which training never builds; run decode under torch.inference_mode()"
        )
    out = _decode.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), kv_len)
    return out[:, None]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    _local_only(x, w)
    if _grad_needed(x, w):
        return KernelWithPlainGrad.apply(_rmsnorm.rmsnorm, ref.rmsnorm_ref, {"eps": eps}, x, w)
    return _rmsnorm.rmsnorm(x, w, eps=eps)


def build() -> dict[str, float]:
    """Build every kernel now (in parallel); returns seconds per kernel."""
    return _build.build()


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        with mod._launch_lock:
            mod.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (by kernel, negative allowed) to the launch counts: a
    CUDA graph's capture counts launches that run only at its replays."""
    for name, n in counts.items():
        mod = _MODULES[name]
        with mod._launch_lock:
            mod.launches += n
