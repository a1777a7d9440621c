"""Plain PyTorch versions of the three kernels.

They mirror ``repro.kernels.ref`` (the ground truth of the Pallas kernels),
with one extension: ``flash_attention_ref`` takes ``q_offset``, the absolute
position of query row 0, so that a prefill over a cache of any length can be
held against it.  The CPU tests use them, each kernel wrapper takes them for a
tensor on the CPU, and ``chip_smoke.py`` holds the kernels against them on the
card.  ``kv_len`` and ``q_offset`` may be ints or device int32 scalars.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, Hq, Lq, d]
    k: torch.Tensor,  # [B, Hkv, Lk, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_len=None,
    q_offset=0,
) -> torch.Tensor:
    _, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    kq = k.repeat_interleave(g, dim=1)
    vq = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kq.float()) / math.sqrt(d)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    t_idx = (q_offset + torch.arange(lq, device=q.device))[:, None]
    s_idx = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= t_idx >= s_idx
    if window > 0:
        mask &= t_idx - s_idx < window
    if kv_len is not None:
        mask &= s_idx < kv_len
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vq.float()).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, d]
    k: torch.Tensor,  # [B, Hkv, Lk, d]
    v: torch.Tensor,
    kv_len,
) -> torch.Tensor:
    _, hq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    kq = k.repeat_interleave(g, dim=1)
    vq = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kq.float()) / math.sqrt(d)
    mask = torch.arange(lk, device=q.device)[None, None, :] < kv_len
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vq.float()).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
