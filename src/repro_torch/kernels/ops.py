"""The kernel-or-plain switch, model-layout wrappers around the five kernels,
and their launch counts.

The switch.  :func:`set_attn_impl` (the reference's ``set_attn_impl``, which
``models.layers`` re-exports) holds ``"kernel"``, ``"plain"`` or ``None``,
and :func:`use_kernel` answers for a tensor: ``None`` picks by device (CUDA
takes the kernels), ``"plain"`` never takes them, and ``"kernel"`` always,
raising on a CPU tensor.  The model asks it before each call of a wrapper
here; a test that rehearses the card's path on the CPU patches it alone.

The model keeps activations as ``[B, L, H, d]`` and its cache as
``[B, M, Hkv, d]``.  Where ``repro.kernels.ops`` transposes q/k/v (and the
whole cache, every decode step) into the kernels' ``[B, H, L, d]``, these
wrappers pass transposed *views*: the kernels take strides, so nothing is
copied.

Counts.  :func:`launch_counts` reads one count per kernel from
``_build.launches``: each call of a kernel's wrapper that launches on the
card (a call of ``mla_decode`` or ``moe_slots``, which launch one or two
kernels a call, counts once) and, on the CPU, each call whose plain
stand-in runs because the switch is forced to the kernel path; a call on
empty inputs, which launches nothing, is not counted.
:func:`reset_launch_counts` zeroes them, and :func:`add_launch_counts` adds
to them for launches that no wrapper call made (a CUDA graph's replay).

Gradients.  No kernel has a backward kernel, as none of the TPU kernels has
one (the reference defines no ``custom_vjp``).  When grad mode is on and an
input requires grad, :func:`rmsnorm` and :func:`flash_attention` launch
their kernel under :class:`KernelWithPlainGrad`, whose backward recomputes
the plain version of ``ref.py`` on the saved inputs and differentiates it;
otherwise (serving runs under ``torch.inference_mode``) they call the kernel
directly.  Decode attention and the absorbed MLA decode are for serving
only and raise under grad.  The MoE's slots are integers, which no gradient
reaches.

The kernels take raw pointers, so a DTensor must never reach them: each
wrapper raises on one.  The model calls them on a DTensor's local shards
(``models.hints.shard_map``).
"""

from __future__ import annotations

import torch

from . import _build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mla_decode as _mla
from . import moe_slots as _slots
from . import ref
from . import rmsnorm as _rmsnorm

_IMPLS = (None, "plain", "kernel")
_impl: str | None = None


def set_attn_impl(impl: str | None) -> None:
    """``"kernel"``, ``"plain"``, or ``None`` (by device: CUDA → kernel)."""
    global _impl
    if impl not in _IMPLS:
        raise ValueError(f"attention impl must be one of {_IMPLS}, got {impl!r}")
    _impl = impl


def get_attn_impl() -> str | None:
    return _impl


def use_kernel(x: torch.Tensor) -> bool:
    """Whether work on ``x`` goes to a kernel under the current switch."""
    if _impl == "plain":
        return False
    if _impl == "kernel":
        if not x.is_cuda:
            raise RuntimeError(f"attention impl 'kernel' needs CUDA tensors, got one on {x.device}")
        return True
    return x.is_cuda


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


def mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, scale: float):
    """q_lat: [B, H, 512], q_pe: [B, H, 64]; latent cache c_kv: [B, M, 512],
    k_pe: [B, M, 64] → o_lat [B, H, 512] (see :mod:`.mla_decode`)."""
    _local_only(q_lat, q_pe, c_kv, k_pe, kv_len)
    if _grad_needed(q_lat, q_pe, c_kv, k_pe):
        raise RuntimeError("the absorbed MLA decode has no gradient; run decode under torch.inference_mode()")
    return _mla.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, scale)


def moe_slots(experts: torch.Tensor, n_experts: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """experts: [T, k] int64 → (slot [T·k] int64, keep [T·k] bool) (see :mod:`.moe_slots`)."""
    _local_only(experts)
    return _slots.moe_slots(experts, n_experts, capacity)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    _local_only(x, w)
    if _grad_needed(x, w):
        return KernelWithPlainGrad.apply(_rmsnorm.rmsnorm, ref.rmsnorm_ref, {"eps": eps}, x, w)
    return _rmsnorm.rmsnorm(x, w, eps=eps)


def build() -> dict[str, float]:
    """Build every kernel now (in parallel); returns seconds per kernel."""
    return _build.build()


def launch_counts() -> dict[str, int]:
    """The counts since the last reset, of the kernels counted at all."""
    with _build.launch_lock:
        return {name: n for name, n in _build.launches.items() if n}


def reset_launch_counts() -> None:
    with _build.launch_lock:
        _build.launches.update(dict.fromkeys(_build.KERNELS, 0))


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (by kernel, negative allowed) to the launch counts: a
    CUDA graph's capture counts launches that run only at its replays."""
    for name, n in counts.items():
        _build.count(name, n)
