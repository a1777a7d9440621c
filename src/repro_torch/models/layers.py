"""Shared neural layers: norms, RoPE, MLPs, and GQA attention.

The port of ``repro.models.layers``.  Two implementations sit behind one
switch, :func:`set_attn_impl` (the reference's ``set_attn_impl``, with the
values ``"plain"`` and ``"kernel"``):

* ``"kernel"``: ``rms_norm`` launches the rmsnorm kernel; attention without
  a cache, or with a cache and ``L > 1`` (prefill), launches the flash kernel
  (``q_offset = cache_len``, ``kv_len = cache_len + L``); attention with a
  cache and ``L == 1`` (decode) launches the decode kernel
  (``kv_len = cache_len + 1``), unless the layer has a sliding window or a
  logit softcap, which the decode kernel does not take (nor does the
  reference's): such a step is one flash launch at ``Lq = 1``.
  Cross-attention (``cross_kv``) is one non-causal flash launch at any L.
  A CPU tensor under ``"kernel"`` raises.
  With grad on, rmsnorm and flash run under
  :class:`repro_torch.kernels.ops.KernelWithPlainGrad` (kernel forward,
  the plain version's VJP backward); decode attention raises.
* ``"plain"``: the reference's arithmetic in PyTorch, including the chunked
  GQA ``sdpa``, which rounds the probabilities to ``v``'s dtype before
  ``P·V`` as the reference does.

The default, ``None``, picks by device: ``"kernel"`` for CUDA tensors,
``"plain"`` for CPU tensors.  Matrix products stay ``torch.matmul``, as the
reference left them to XLA.

DTensors (:mod:`repro_torch.models.hints`).  With params placed on a mesh,
the model's tensors are DTensors, and DTensor's sharding propagation
places what the reference leaves to GSPMD.  ``rms_norm`` on a DTensor runs
on its local rows (``hints.shard_map`` with x's own placements, its last
dim gathered), so the switch decides on the local tensor.  Attention
without a cache takes the reference's hint H1 under ``set_hints``: q, k and
v are constrained head-parallel (``Hkv`` divides TP) or to sequence-sharded
queries and replicated K/V, and :func:`sdpa_on_shards` runs ``sdpa`` on
each rank's shards, the sequence-sharded queries at ``q_offset = tp_rank ·
L/tp``.  Any other attention on DTensors runs ``sdpa`` on each rank's
batch rows.  Either way the kernels get local tensors, and the switch
decides on them.  The RoPE tables, made here as plain tensors, are placed
replicated where they meet a DTensor (``hints.replicated_like``); matmuls
on DTensors go through ``hints.matmul``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

from .config import ModelConfig
from .hints import DTensor, constrain, get_hints, matmul, pin, placements, replicated_like, shard_map, unshard

Params = dict[str, Any]

_IMPLS = (None, "plain", "kernel")
_ATTN_IMPL: Optional[str] = None


def set_attn_impl(impl: Optional[str]) -> None:
    """``"kernel"``, ``"plain"``, or ``None`` (by device: CUDA → kernel)."""
    global _ATTN_IMPL
    if impl not in _IMPLS:
        raise ValueError(f"attention impl must be one of {_IMPLS}, got {impl!r}")
    _ATTN_IMPL = impl


def get_attn_impl() -> Optional[str]:
    return _ATTN_IMPL


def _use_kernel(x: torch.Tensor) -> bool:
    """Whether work on ``x`` goes to a kernel under the current switch."""
    if _ATTN_IMPL == "plain":
        return False
    if _ATTN_IMPL == "kernel":
        if not x.is_cuda:
            raise RuntimeError(
                f"attention impl 'kernel' needs CUDA tensors, got one on {x.device}"
            )
        return True
    return x.is_cuda


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if isinstance(x, DTensor):
        return _rms_norm_on_shards(x, w, eps)
    if _use_kernel(x):
        return kops.rmsnorm(x, w, eps=eps)
    return kref.rmsnorm_ref(x, w, eps=eps)


def _rms_norm_on_shards(x: DTensor, w: DTensor, eps: float) -> DTensor:
    """``rms_norm`` on each rank's whole rows of ``x``; the weight is
    replicated.  A partial sum is reduced first, and a last dim that
    DTensor's propagation left sharded (a residual sum under H4 can be) is
    gathered first: the norm reads whole rows."""
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_partial() or p.is_shard(x.ndim - 1) else p for p in x.placements)
    rep = (Replicate(),) * len(pl)
    return shard_map(lambda a, b: rms_norm(a, b, eps), x.device_mesh, (pl, rep), pl)(x, w)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


def init_norm(cfg: ModelConfig, dtype, device) -> Params:
    z = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if cfg.norm == "rmsnorm":
        return {"w": z}
    return {"w": torch.ones_like(z), "b": z}


# ---------------------------------------------------------------------------
# Linear / init helpers ([d_in, d_out] weights, as the reference)
# ---------------------------------------------------------------------------


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype, *, bias: bool = False) -> Params:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    p: Params = {"w": (w * (1.0 / math.sqrt(d_in))).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RoPE (split-half form, in fp32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, L, H, D]; positions: [B, L] or [L]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, L, D/2]
    cos = replicated_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicated_like(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int, dtype) -> Params:
    if cfg.activation.endswith("_glu"):
        return {
            "gate": init_linear(gen, cfg.d_model, d_ff, dtype),
            "up": init_linear(gen, cfg.d_model, d_ff, dtype),
            "down": init_linear(gen, d_ff, cfg.d_model, dtype),
        }
    return {
        "up": init_linear(gen, cfg.d_model, d_ff, dtype),
        "down": init_linear(gen, d_ff, cfg.d_model, dtype),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu_glu":
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    elif cfg.activation == "gelu_glu":
        h = F.gelu(linear(p["gate"], x), approximate="tanh") * linear(p["up"], x)
    elif cfg.activation == "relu_sq":
        h = torch.square(F.relu(linear(p["up"], x)))
    elif cfg.activation == "gelu":
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return linear(p["down"], h)


# ---------------------------------------------------------------------------
# Attention (GQA; causal / bidirectional / sliding window / cross; softcap)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    return {
        "q": init_linear(gen, cfg.d_model, cfg.q_dim, dtype, bias=cfg.qkv_bias),
        "k": init_linear(gen, cfg.d_model, cfg.kv_dim, dtype, bias=cfg.qkv_bias),
        "v": init_linear(gen, cfg.d_model, cfg.kv_dim, dtype, bias=cfg.qkv_bias),
        "o": init_linear(gen, cfg.q_dim, cfg.d_model, dtype),
    }


def _sdpa_chunk(
    q: torch.Tensor,  # [B, c, Hkv, G, D] fp32-scaled queries
    k: torch.Tensor,  # [B, Lk, Hkv, D]
    v: torch.Tensor,  # [B, Lk, Hkv, D]
    q_pos: torch.Tensor,  # [c] (or [B, c]) absolute positions of the q rows
    k_pos: torch.Tensor,  # [Lk]
    kv_valid,  # [] or [B] — number of valid cache rows, or None
    *,
    causal: bool,
    window: int,
    softcap: float,
) -> torch.Tensor:
    scores = torch.einsum("bchgd,bkhd->bchgk", q, k.float())
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]  # [B?, c]
    kp = k_pos[None, None, :]  # [1, 1, Lk]
    mask = torch.ones((qp.shape[0], qp.shape[1], k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, :, None] >= kp
    if window > 0:
        mask &= qp[:, :, None] - kp < window
    if kv_valid is not None:
        kv = torch.as_tensor(kv_valid, device=q.device)
        kv = kv[:, None, None] if kv.ndim == 1 else kv.reshape(1, 1, 1)
        mask &= kp < kv
    scores = torch.where(mask[:, :, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    # The reference rounds the probabilities to v's dtype, then sums in fp32.
    out = torch.einsum("bchgk,bkhd->bchgd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def sdpa(
    q: torch.Tensor,  # [B, Lq, Hq, D]
    k: torch.Tensor,  # [B, Lk, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
    q_offset=0,
    kv_valid=None,
    q_chunk: int = 2048,
    stride_chunks: bool = False,
) -> torch.Tensor:
    """Chunked-query GQA attention; returns [B, Lq, Hq, D].

    Under the kernel switch this is one flash-kernel launch with
    ``q_offset`` and ``kv_len = kv_valid``.  The plain path chunks the query
    axis as the reference does; ``stride_chunks`` takes every n-th row per
    chunk instead of contiguous ranges (the reference uses it when Lq is
    sequence-sharded).
    """
    if isinstance(q, DTensor):
        return _sdpa_on_batch_shards(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                                     kv_valid=kv_valid, q_chunk=q_chunk, stride_chunks=stride_chunks)
    if _use_kernel(q):
        return kops.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, kv_len=kv_valid,
        )

    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qs = (q.float() / math.sqrt(d)).reshape(b, lq, hkv, g, d)
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    offs = torch.as_tensor(q_offset, dtype=torch.int32, device=q.device)

    def chunk_out(rows: torch.Tensor, q_pos: torch.Tensor, size: int) -> torch.Tensor:
        o = _sdpa_chunk(
            rows, k, v, q_pos, k_pos, kv_valid,
            causal=causal, window=window, softcap=softcap,
        )
        return o.reshape(b, size, hq, d)

    def positions(start: int, stop: int, step: int = 1) -> torch.Tensor:
        return offs + torch.arange(start, stop, step, dtype=torch.int32, device=q.device)

    if lq <= q_chunk:
        return chunk_out(qs, positions(0, lq), lq)
    if lq % q_chunk:
        raise ValueError(f"Lq={lq} is not a multiple of q_chunk={q_chunk}")
    n = lq // q_chunk
    if stride_chunks:
        outs = [chunk_out(qs[:, c::n], positions(c, lq, n), q_chunk) for c in range(n)]
        # row i·n + c of the output is row i of chunk c
        return torch.stack(outs, dim=2).reshape(b, lq, hq, d)
    outs = [
        chunk_out(qs[:, s : s + q_chunk], positions(s, s + q_chunk), q_chunk)
        for s in range(0, lq, q_chunk)
    ]
    return torch.cat(outs, dim=1)


def split_heads(t: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """``t`` [B, L, n·head_dim] as [B, L, n, head_dim].  A DTensor whose last
    dim is sharded over more ranks than ``n`` heads divide is gathered along
    it first: DTensor cannot split a shard across heads (the reference's
    GSPMD shards part of a head instead)."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.ndim - 1
        if n % math.prod(mesh.size(k) for k, p in enumerate(t.placements) if p.is_shard(last)):
            t = unshard(t, [last])
    return t.reshape(*t.shape[:-1], n, head_dim)


def _sdpa_on_batch_shards(q: DTensor, k: DTensor, v: DTensor, **kw) -> DTensor:
    """:func:`sdpa` on DTensors outside H1: each rank attends over its batch
    rows with every head and every position (q, k and v gathered along all
    other dims).  DTensor has rules for the plain path's ops, but not for
    its head splits in the backward when the heads are sharded unevenly
    over TP, so the whole call goes local, as for an op without a rule."""
    from torch.distributed.tensor import Replicate

    pl = tuple(p if p.is_shard(0) else Replicate() for p in q.placements)
    return shard_map(lambda a, b, c: sdpa(a, b, c, **kw), q.device_mesh, (pl, pl, pl), pl)(q, k, v)


def sdpa_on_shards(h, q_spec, kv_spec, q, k, v, **kw) -> DTensor:
    """H1's attention: :func:`sdpa` on each rank's shards of q (``q_spec``)
    and k, v (``kv_spec``), under the hints ``h``.  When q is sharded along
    the sequence over TP, a rank's queries start at row ``tp_rank · Lq/tp``,
    its ``q_offset``; the output is placed as q."""
    seq_sharded = q_spec[1] == h.tp_axis

    def local(ql, kl, vl):
        off = h.mesh.get_local_rank(h.tp_axis) * ql.shape[1] if seq_sharded else 0
        return sdpa(ql, kl, vl, q_offset=off, **kw)

    pq, pkv = placements(*q_spec), placements(*kv_spec)
    return shard_map(local, h.mesh, (pq, pkv, pkv), pq)(q, k, v)


def attention_block(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, L, d]
    *,
    positions: torch.Tensor,  # [L] absolute positions
    causal: bool,
    window: int = 0,
    cache: Optional[Params] = None,  # {"k", "v", "len"}: prefill/decode cache
    cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    use_rope: bool = True,
) -> tuple[torch.Tensor, Optional[Params]]:
    """Projections + RoPE + SDPA (+ cache update).

    The cache is written in place (the reference returns a fresh cache from
    ``dynamic_update_slice``): rows ``len .. len+L`` of ``cache["k"]`` and
    ``cache["v"]`` are overwritten, and the returned cache holds the same
    tensors with ``len + L``.  ``len`` stays on the device throughout.

    ``cross_kv = (k, v)``, each ``[B, S, Hkv, d]``: cross-attention over
    them, as the reference: RoPE on q only (when ``use_rope``), no mask
    (one flash launch under the kernel switch, at any L), the logit softcap,
    and ``cache`` returned untouched.
    """
    b, l, _ = x.shape
    q = split_heads(linear(p["q"], x), cfg.n_heads, cfg.head_dim)
    if cross_kv is not None:
        k, v = cross_kv
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        out = sdpa(q, k, v, causal=False, softcap=cfg.attn_logit_softcap)
        return linear(p["o"], pin(out.reshape(b, l, cfg.q_dim))), cache

    k = split_heads(linear(p["k"], x), cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(linear(p["v"], x), cfg.n_kv_heads, cfg.head_dim)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    softcap = cfg.attn_logit_softcap
    if cache is None:
        # H1 (hints): explicit attention sharding, as the reference.  Two regimes:
        #   · Hkv | tp  → head-parallel: everything local per KV head;
        #   · Hkv ∤ tp  → sequence-sharded queries + replicated K/V: one
        #     K/V all-gather per layer.
        h = get_hints()
        head_parallel = (
            h is not None
            and h.head_shard_attention
            and cfg.n_kv_heads % h.tp_size == 0
            and b % h.dp_size == 0
        )
        seq_parallel = (
            h is not None
            and not head_parallel
            and h.seq_shard_attention
            and l % h.tp_size == 0
            and b % h.dp_size == 0
        )
        if head_parallel:
            dp = h.dp_spec()
            q = constrain(q, dp, None, h.tp_axis, None)
            k = constrain(k, dp, None, h.tp_axis, None)
            v = constrain(v, dp, None, h.tp_axis, None)
            spec = (dp, None, h.tp_axis, None)
            out = sdpa_on_shards(h, spec, spec, q, k, v, causal=causal, window=window, softcap=softcap)
            out = constrain(out, dp, None, h.tp_axis, None)
        elif seq_parallel:
            dp = h.dp_spec()
            q = constrain(q, dp, h.tp_axis, None, None)
            k = constrain(k, dp, None, None, None)
            v = constrain(v, dp, None, None, None)
            # ≤4k: the TP split already bounds per-device score memory, so
            # no chunking, as the reference.
            out = sdpa_on_shards(
                h, (dp, h.tp_axis, None, None), (dp, None, None, None), q, k, v,
                causal=causal, window=window, softcap=softcap,
                q_chunk=l if l <= 4096 else 2048, stride_chunks=True,
            )
            out = constrain(out, dp, h.tp_axis, None, None)
        else:
            out = sdpa(q, k, v, causal=causal, window=window, softcap=softcap)
        new_cache = None
    else:
        idx = cache["len"]  # int32 scalar on the device
        rows = idx + torch.arange(l, device=x.device)
        cache["k"].index_copy_(1, rows, k)
        cache["v"].index_copy_(1, rows, v)
        valid = idx + l
        if l == 1 and window == 0 and softcap == 0.0 and _use_kernel(q):
            # One row at q_offset = len: causal-at-len and kv_valid = len + 1
            # are the same mask, s < len + 1.
            out = kops.decode_attention(q, cache["k"], cache["v"], valid)
        else:
            out = sdpa(
                q, cache["k"], cache["v"], causal=causal, window=window,
                softcap=softcap, q_offset=idx, kv_valid=valid,
            )
        new_cache = {"k": cache["k"], "v": cache["v"], "len": valid}
    return linear(p["o"], pin(out.reshape(b, l, cfg.q_dim))), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }
