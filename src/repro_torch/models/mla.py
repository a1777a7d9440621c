"""Multi-head latent attention (MLA, DeepSeek-V2 [arXiv:2405.04434]).

The port's own mixer: the JAX package has none.  ``c`` is ``kv_lora_rank``,
``n`` ``qk_nope_head_dim``, ``r`` ``qk_rope_head_dim``, ``v`` ``v_head_dim``
and ``H`` ``n_heads``.  Weights (``[d_in, d_out]``, as every linear of the
port)::

    q        {"w": [d, H·(n + r)]}     each head's q_nope, then its q_pe (no q LoRA)
    kv_a     {"w": [d, c + r]}         the latent c_kv, then the RoPE key k_pe
    kv_norm  {"w": [c]}                RMSNorm of the latent (scales by 1 + w)
    kv_b     {"w": [c, H·(n + v)]}     each head's k_nope, then its v
    o        {"w": [H·v, d]}

A head's key is ``[k_nope, k_pe]``, with ``k_pe`` shared by every head, and
the softmax scale is ``(n + r)^-1/2 · m²`` with YaRN's ``m = 0.1 ·
mscale_all_dim · ln(factor) + 1``.  RoPE is YaRN's (:func:`yarn_inv_freq`),
in the port's split-half layout, on ``q_pe`` and ``k_pe``.

The cache entry is ``{"c_kv" [B, M, c], "k_pe" [B, M, r]}``: two views of
one ``[B, M, c + r]`` buffer, so a cache row is one key row of the absorbed
kernel, written in place (rows ``len .. len + L``) as attention's K/V are.
A call with ``L > 1`` (a prefill) or without a cache expands ``k_nope`` and
``v`` from the latent and runs :func:`layers.sdpa` (the flash kernel under
the kernel switch) at head dim ``n + r``, ``v`` zero-padded to it and the
output sliced back; q carries ``m²``, as the kernel scales by
``(n + r)^-1/2``.  A decode step (``L == 1`` with a cache) is absorbed: q's
``q_nope · W_UK[h]`` is a ``c``-wide latent query, the attention runs over
the latent cache alone (``kernels.ops.mla_decode`` on CUDA tensors under
the switch, which takes bf16 and raises on other dtypes; its plain version
otherwise), and ``o_lat · W_UV[h]``
gives each head's output before ``o``.

While a profiler records, the mixer is three spans (:func:`repro_torch.obs.span`):
``model.mla.kv`` (the projections of x, the latent's norm, RoPE and the
cache write), ``model.mla.attend`` (the expansion and flash attention, or
the absorb products and the decode kernel) and ``model.mla.out`` (``o``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.events import span

from .config import MLACfg, ModelConfig
from .layers import _cache_write, apply_rope, init_linear, linear, rms_norm, sdpa

Params = dict[str, Any]


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 · mscale · ln(factor) + 1`` (1 at factor ≤ 1)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5 * yarn_mscale(m.factor, m.mscale_all_dim) ** 2


def yarn_correction_range(m: MLACfg, theta: float) -> tuple[int, int]:
    """The frequency indices over which YaRN's ramp runs: below ``low`` a
    frequency is kept (extrapolated), above ``high`` divided by ``factor``."""
    dim = m.qk_rope_head_dim

    def at(rotations: float) -> float:
        return dim * math.log(m.original_max_position / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low, high = math.floor(at(m.beta_fast)), math.ceil(at(m.beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq_cpu(m: MLACfg, theta: float) -> torch.Tensor:
    """fp32 ``[r/2]`` inverse frequencies, as the published
    ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    dim = m.qk_rope_head_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (theta**exps)
    inter = 1.0 / (m.factor * theta**exps)
    low, high = yarn_correction_range(m, theta)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    keep = 1.0 - ramp  # 1 below the ramp: the frequency is kept
    return inter * (1 - keep) + extra * keep


_INV_FREQ: dict[tuple, torch.Tensor] = {}


def yarn_inv_freq(m: MLACfg, theta: float, device) -> torch.Tensor:
    """:func:`yarn_inv_freq_cpu` on ``device``, made once (outside any CUDA
    graph: a decode step's eager run comes before its capture) and kept, so
    that a step reads it and does not compute it."""
    key = (m, theta, torch.device(device))
    t = _INV_FREQ.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _INV_FREQ[key] = yarn_inv_freq_cpu(m, theta).to(device)
    return t


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    if m.q_lora_rank:
        raise ValueError(f"{cfg.name}: MLA with a q LoRA (q_lora_rank {m.q_lora_rank}) is not ported")
    return {
        "q": init_linear(gen, d, h * (m.qk_nope_head_dim + m.qk_rope_head_dim), dtype),
        "kv_a": init_linear(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        "kv_norm": {"w": torch.zeros((m.kv_lora_rank,), dtype=dtype, device=gen.device)},
        "kv_b": init_linear(gen, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "o": init_linear(gen, h * m.v_head_dim, d, dtype),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Params:
    c = cfg.mla.kv_lora_rank
    buf = torch.zeros((batch, max_len, c + cfg.mla.qk_rope_head_dim), dtype=dtype, device=device)
    return {"c_kv": buf[..., :c], "k_pe": buf[..., c:]}


def _expanded(cfg: ModelConfig, p: Params, q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
              q_offset, kv_valid) -> torch.Tensor:
    """Causal attention of ``q`` [B, L, H, n + r] over keys and values
    expanded from the latent ``c_kv`` [B, M, c] and ``k_pe`` [B, M, r]:
    ``[B, L, H, v]``."""
    m, h = cfg.mla, cfg.n_heads
    n, r, v = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    b, rows, _ = c_kv.shape
    kv = linear(p["kv_b"], c_kv).view(b, rows, h, n + v)
    k = torch.cat([kv[..., :n], k_pe[:, :, None, :].expand(b, rows, h, r)], dim=-1)
    vp = F.pad(kv[..., n:], (0, n + r - v))  # the flash kernel takes one head dim for q, K and V
    out = sdpa(q, k, vp, causal=True, q_offset=q_offset, kv_valid=kv_valid)
    return out[..., :v]


def _absorbed(cfg: ModelConfig, p: Params, q_nope: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
              k_pe: torch.Tensor, kv_len) -> torch.Tensor:
    """One decode row a sequence, ``q_nope`` [B, H, n] and ``q_pe`` [B, H, r],
    over the latent cache: ``[B, H, v]``."""
    m, h = cfg.mla, cfg.n_heads
    n, c = m.qk_nope_head_dim, m.kv_lora_rank
    w = p["kv_b"]["w"].view(c, h, n + m.v_head_dim)
    # q_lat[b, h] = q_nope[b, h] · W_UK[h]ᵀ, W_UK[h] = w[:, h, :n]: [H, B, n] @ [H, n, c]
    q_lat = torch.bmm(q_nope.transpose(0, 1), w[..., :n].permute(1, 2, 0)).transpose(0, 1)
    scale = softmax_scale(cfg)
    if kops.use_kernel(q_lat):  # bf16 only: other dtypes raise
        o_lat = kops.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, scale)
    else:
        o_lat = kref.mla_decode_ref(q_lat, q_pe, c_kv, k_pe, kv_len, scale)
    # o[b, h] = o_lat[b, h] · W_UV[h], W_UV[h] = w[:, h, n:]: [H, B, c] @ [H, c, v]
    return torch.bmm(o_lat.transpose(0, 1), w[..., n:].permute(1, 0, 2)).transpose(0, 1)


def mla_block(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, L, d]
    *,
    positions: torch.Tensor,  # [L] absolute positions
    cache: Params | None = None,  # {"c_kv", "k_pe", "len"}, written in place
) -> tuple[torch.Tensor, Params | None]:
    """The MLA mixer over ``x``: ``(out [B, L, d], {"c_kv", "k_pe", "len"}
    with ``len + L``, or None without a cache)``."""
    m, h = cfg.mla, cfg.n_heads
    n, r, c = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    b, l, _ = x.shape
    with span("model.mla.kv"):
        inv = yarn_inv_freq(m, cfg.rope_theta, x.device)
        rope_m = yarn_mscale(m.factor, m.mscale) / yarn_mscale(m.factor, m.mscale_all_dim)
        q = linear(p["q"], x).view(b, l, h, n + r)
        q_pe = apply_rope(q[..., n:], positions, cfg.rope_theta, inv)
        kv_a = linear(p["kv_a"], x)
        c_kv = rms_norm(kv_a[..., :c], p["kv_norm"]["w"])
        k_pe = apply_rope(kv_a[:, :, None, c:], positions, cfg.rope_theta, inv)[:, :, 0]
        if rope_m != 1.0:
            q_pe, k_pe = q_pe * rope_m, k_pe * rope_m
        new_cache = None
        if cache is not None:
            idx = cache["len"]
            rows = idx + torch.arange(l, device=x.device)
            c_all, pe_all = _cache_write(cache["c_kv"], rows, c_kv), _cache_write(cache["k_pe"], rows, k_pe)
            new_cache = {"c_kv": c_all, "k_pe": pe_all, "len": idx + l}
    with span("model.mla.attend"):
        if cache is not None and l == 1:
            out = _absorbed(cfg, p, q[:, 0, :, :n], q_pe[:, 0], c_all, pe_all, new_cache["len"])[:, None]
        else:
            qs = torch.cat([q[..., :n], q_pe], dim=-1) * yarn_mscale(m.factor, m.mscale_all_dim) ** 2
            if cache is None:
                out = _expanded(cfg, p, qs, c_kv, k_pe, 0, None)
            else:
                out = _expanded(cfg, p, qs, c_all, pe_all, idx, new_cache["len"])
    with span("model.mla.out"):
        out = linear(p["o"], out.reshape(b, l, h * m.v_head_dim))
    return out, new_cache
