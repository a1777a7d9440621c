"""Absorbed MLA decode — hand-written CUDA kernel (``csrc/mla_decode.cu``).

The port's own kernel (the JAX package has no MLA): one decode row per
sequence and head against a latent cache of which the first ``kv_len`` rows
are valid, ``o_lat = softmax(scale · (q_lat · c_kv + q_pe · k_pe)) · c_kv``.
A key row is a cache row, ``[c_kv, k_pe]`` (512 + 64 wide), shared by the
16 query heads, and its first 512 are also the value; the heads are the M
of the tensor cores' ``mma.sync`` m16n8k16, so a block reads each cache row
once for all of them.  ``kv_len`` may be a device int32 scalar, read by the
kernel itself, so a replayed CUDA graph is right at every length.

A call is two launches: the split kernel, whose blocks each take a range of
the cache of one sequence (:func:`split_chunk`) and write an fp32 partial
``(m, l, acc)`` to a scratch tensor allocated here, and the merge kernel,
one block a (sequence, head), which combines the splits.  Nothing persists
between calls, so calls on different streams may run at once.  bf16 only
(the products are bf16 on the tensor cores, accumulated in fp32), at the
published widths (``c`` 512, ``r`` 64, up to 16 heads).  A CPU tensor gets
the plain version of ``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

LATENT, ROPE = 512, 64  # csrc kLat, kRope
MAX_HEADS = 16  # csrc kHeads: the M of one mma tile
TILE = 32  # keys a tile of the split kernel (csrc kTileK); a split is a multiple of it

_P, _I = ctypes.c_void_p, ctypes.c_int
LAUNCH = _build.Entry("mla_decode", (  # a call: a split and a merge launch, counted once
    [_P, _P, _P, _P, _P, _P, _I]  # q_lat, q_pe, c_kv, k_pe, o, kv_len ptr/val
    + [_I] * 3  # B, H, Lk
    + [ctypes.c_longlong] * 10  # q_lat (b, h), q_pe (b, h), c_kv (b, l), k_pe (b, l), o (b, h)
    + [ctypes.c_float, _I, _P, _P]  # scale, chunk, partials, stream
))


def split_chunk(lk: int, b: int, sms: int = 132) -> int:
    """Keys each block of the split kernel takes, from the cache's capacity
    ``lk`` (``kv_len`` lives on the device and is never read back): the
    multiple of :data:`TILE` that gives about two blocks for each of the
    card's ``sms`` SMs (two fit on an SM), so that one wave covers the
    cache; at least one tile, and one split where one block covers it."""
    per_block = -(-lk * b // (2 * sms))
    return min(max(TILE, -(-per_block // TILE) * TILE), -(-lk // TILE) * TILE)


def mla_decode(
    q_lat: torch.Tensor,  # [B, H, 512]
    q_pe: torch.Tensor,  # [B, H, 64]
    c_kv: torch.Tensor,  # [B, Lk, 512] — the latent cache, possibly over-allocated
    k_pe: torch.Tensor,  # [B, Lk, 64]
    kv_len,  # valid rows: int or device int32 scalar
    scale: float,
) -> torch.Tensor:
    """Returns ``[B, H, 512]`` in ``q_lat``'s dtype (contiguous)."""
    if q_lat.device.type != "cuda":
        return _build.stand_in("mla_decode", q_lat, ref.mla_decode_ref, q_lat, q_pe, c_kv, k_pe, kv_len, scale)
    b, h, c = q_lat.shape
    lk = c_kv.shape[1]
    ts = (q_lat, q_pe, c_kv, k_pe)
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"mla_decode takes bf16 tensors, got {[str(t.dtype) for t in ts]}")
    if (c, q_pe.shape, c_kv.shape, k_pe.shape) != (LATENT, (b, h, ROPE), (b, lk, LATENT), (b, lk, ROPE)):
        raise ValueError(f"bad shapes q_lat {tuple(q_lat.shape)}, q_pe {tuple(q_pe.shape)}, "
                         f"c_kv {tuple(c_kv.shape)}, k_pe {tuple(k_pe.shape)} (widths {LATENT} and {ROPE})")
    if not 0 < h <= MAX_HEADS or lk == 0:
        raise ValueError(f"mla_decode takes 1 to {MAX_HEADS} heads and a cache of rows, got {h} and {lk}")
    if any(t.stride(-1) != 1 or t.device != q_lat.device for t in ts):
        raise ValueError("q_lat, q_pe, c_kv, k_pe must lie on one device with unit stride along their width")
    if any(t.data_ptr() % 16 or any(s * 2 % 16 for s in t.stride()[:2]) for t in (c_kv, k_pe)):
        raise ValueError("the cache (c_kv, k_pe) must be 16-byte aligned, base and rows")
    # The query rows are copied by 16-byte pieces too: a misaligned one is made contiguous.
    q_lat, q_pe = (t if t.data_ptr() % 16 == 0 and all(s * 2 % 16 == 0 for s in t.stride()[:2]) else t.contiguous()
                   for t in (q_lat, q_pe))
    kv_ptr, kv_val = _build.scalar_arg(kv_len, q_lat.device, "kv_len")
    o = torch.empty((b, h, c), dtype=q_lat.dtype, device=q_lat.device)
    if b == 0:
        return o
    dev = q_lat.device
    chunk = split_chunk(lk, b, _build.sm_count(dev))
    splits = -(-lk // chunk)
    part = torch.empty(b * splits * h * (c + 2), dtype=torch.float32, device=dev)
    LAUNCH(
        dev, q_lat.data_ptr(), q_pe.data_ptr(), c_kv.data_ptr(), k_pe.data_ptr(), o.data_ptr(), kv_ptr, kv_val,
        b, h, lk,
        q_lat.stride(0), q_lat.stride(1), q_pe.stride(0), q_pe.stride(1),
        c_kv.stride(0), c_kv.stride(1), k_pe.stride(0), k_pe.stride(1), o.stride(0), o.stride(1),
        float(scale), chunk, part.data_ptr(), _build.stream_of(q_lat),
    )
    return o
