"""Plain PyTorch versions of the three kernels.

They mirror ``repro.kernels.ref`` (the ground truth of the Pallas kernels),
with one extension: ``flash_attention_ref`` takes ``q_offset``, the absolute
position of query row 0, so that a prefill over a cache of any length can be
held against it.  The CPU tests use them, each kernel wrapper takes them for a
tensor on the CPU, and ``chip_smoke.py`` holds the kernels against them on the
card.  ``decode_attention_split_ref`` spells out the decode kernel's split
over the cache and its merge, for the tests.  ``kv_len`` and ``q_offset`` may
be ints or device int32 scalars.
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


def decode_attention_split_ref(
    q: torch.Tensor,  # [B, Hq, d]
    k: torch.Tensor,  # [B, Hkv, Lk, d]
    v: torch.Tensor,
    kv_len: int,
    chunk: int,
) -> torch.Tensor:
    """The decode kernel's split and merge, in plain PyTorch (for tests).

    Split ``s`` takes keys ``[s * chunk, (s + 1) * chunk)`` and gives the
    partial ``(m, l, acc)`` of its live keys: the max score, the sum of
    ``exp(score - m)`` and the ``exp``-weighted sum of V rows; a split with
    no live key is empty (``m = -1e30, l = 0``).  The merge skips empty
    splits and takes ``M = max m``, ``o = Σ acc e^(m - M) / max(Σ l e^(m - M),
    1e-30)``, so ``kv_len = 0`` gives 0 (as the kernels do; the plain
    softmax of :func:`decode_attention_ref` would average every row).
    """
    _, hq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kq) / math.sqrt(d)
    ms, ls, accs = [], [], []
    for c0 in range(0, lk, chunk):
        live = torch.arange(c0, min(c0 + chunk, lk), device=q.device) < kv_len
        sc = torch.where(live, s[..., c0 : c0 + chunk], NEG_INF)
        m = sc.amax(-1)
        p = torch.where(live, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhs,bhsd->bhd", p, vq[:, :, c0 : c0 + chunk]))
    m, l, acc = torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)
    full = l > 0
    mx = torch.where(full, m, NEG_INF).amax(-1, keepdim=True)
    w = torch.where(full, torch.exp(m - mx), 0.0)
    denom = (l * w).sum(-1).clamp_min(1e-30)
    return ((acc * w[..., None]).sum(-2) / denom[..., None]).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
