"""Plain fp32 reference of DeepSeek-V2's decoder: multi-head latent attention
(MLA) beside DeepSeek-MoE's FFN (the ``deepseek-v2-lite`` configuration's
``reference`` key names this module).

It is written from the published model (arXiv:2405.04434 and its
``modeling_deepseek.py``), not from the port's code, imports nothing of the
program, and takes the dense MLP, the MoE FFN, the norms, the LM head and
the fp8 control from :mod:`bench.reference.moe_decoder`.  The attention is
MLA's published, non-absorbed form, so a program that absorbs the
up-projections into its queries is held to it:

* ``q = x W_q`` per head ``[q_nope (n), q_pe (r)]`` (no q LoRA);
  ``[c_kv (c), k_pe (r)] = x W_kv_a``, ``c_kv`` RMS-normed (scale ``1 + w``);
  ``[k_nope (n), v (v)] = c_kv W_kv_b`` per head; ``k_pe`` one RoPE key
  shared by the heads;
* YaRN RoPE on ``q_pe`` and ``k_pe``: the published inverse frequencies (a
  ramp between the correction dims of ``beta_fast`` and ``beta_slow``,
  extrapolated below it, divided by ``factor`` above it), cos and sin times
  ``mscale(mscale) / mscale(mscale_all_dim)``, in split-half layout (the
  configuration's ``assumed`` says why);
* scores ``(q_nope·k_nope + q_pe·k_pe) · (n + r)^-1/2 · mscale(mscale_all_dim)²``,
  causal, softmax in fp32, then ``o = P v`` and ``o W_o``.

Attention runs one sequence and ``q_block`` query rows at a time, each
block against the keys up to its last row, so that whole 32K-token
sequences fit.  Everything is fp32 with TF32 off; the weight products go
through ``mm`` (the control's fp8 rounding included), attention's own
products stay fp32.
"""

from __future__ import annotations

import math

import torch

from ..counts.flops import layer_seq
from .moe_decoder import (  # noqa: F401  (exact_fp32, fp32_mm, fp8_mm, gaps: what the drivers call)
    NEG_INF,
    exact_fp32,
    f32,
    fp8_mm,
    fp32_mm,
    gaps,
    logits,
    mlp,
    moe_ffn,
    rms,
    serve_groups,
)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(a: dict, theta: float, device) -> torch.Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies, [r/2]."""
    dim = a["qk_rope_head_dim"]

    def correction_dim(rotations: float) -> float:
        return dim * math.log(a["original_max_position"] / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(a["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(a["beta_slow"])), dim - 1)
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / theta**exps
    freq_inter = 1.0 / (a["factor"] * theta**exps)
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low if high > low else 0.001)
    extra = 1.0 - ramp.clamp(0, 1)
    return freq_inter * (1 - extra) + freq_extra * extra


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor, scale: float) -> torch.Tensor:
    """Split-half rotary embedding of ``x`` [S, H, r] at ``pos`` [S]."""
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = (torch.cos(ang) * scale)[:, None, :], (torch.sin(ang) * scale)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: dict, p: dict, x: torch.Tensor, mm, q_block: int = 1024) -> torch.Tensor:
    """Causal MLA over whole sequences ``x`` [B, S, d], one sequence and
    ``q_block`` query rows at a time."""
    b, s, _ = x.shape
    a, h = m["mla"], m["n_heads"]
    c, n, r, v = a["kv_lora_rank"], a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"]
    pos = torch.arange(s, device=x.device)
    inv = yarn_inv_freq(a, m["rope_theta"], x.device)
    rope_scale = yarn_mscale(a["factor"], a["mscale"]) / yarn_mscale(a["factor"], a["mscale_all_dim"])
    scale = (n + r) ** -0.5 * yarn_mscale(a["factor"], a["mscale_all_dim"]) ** 2
    outs = []
    for xb in x:
        q = mm(xb, p["q"]["w"]).view(s, h, n + r)
        q_nope = q[..., :n].transpose(0, 1)  # [H, S, n]
        q_pe = rope(q[..., n:], pos, inv, rope_scale).transpose(0, 1)  # [H, S, r]
        kv_a = mm(xb, p["kv_a"]["w"])
        c_kv = rms(m, kv_a[:, :c], p["kv_norm"]["w"])
        k_pe = rope(kv_a[:, None, c:], pos, inv, rope_scale)[:, 0]  # [S, r], every head's
        kv = mm(c_kv, p["kv_b"]["w"]).view(s, h, n + v)
        k_nope, val = kv[..., :n].transpose(0, 1), kv[..., n:].transpose(0, 1)  # [H, S, n], [H, S, v]
        o = torch.empty(h, s, v, device=x.device)
        for q0 in range(0, s, q_block):
            q1 = min(q0 + q_block, s)
            sc = q_nope[:, q0:q1] @ k_nope[:, :q1].transpose(1, 2) + q_pe[:, q0:q1] @ k_pe[:q1].T
            causal = torch.arange(q0, q1, device=x.device)[:, None] >= torch.arange(q1, device=x.device)[None, :]
            sc = (sc * scale).masked_fill_(~causal, NEG_INF)
            o[:, q0:q1] = torch.softmax(sc, dim=-1) @ val[:, :q1]
            del sc
        outs.append(o.transpose(0, 1).reshape(s, h * v))
    return mm(torch.stack(outs), p["o"]["w"])


def block(m: dict, kind, p: dict, x: torch.Tensor, groups: list[torch.Tensor], mm):
    """One layer over whole sequences ``x`` [B, S, d]; ``(x, aux or None)``.
    This reference computes an ``mla`` mixer and a ``dense0``, ``mlp`` or
    ``moe`` FFN, and refuses any other kind."""
    if kind[0] != "mla" or kind[1] not in ("mlp", "dense0", "moe"):
        raise ValueError(f"bench/reference/mla_decoder.py does not compute a {kind} layer")
    x = x + attention(m, p["mixer"], rms(m, x, p["norm1"]["w"]), mm)
    hid = rms(m, x, p["norm2"]["w"])
    if kind[1] == "moe":
        y, aux = moe_ffn(m, p["ffn"], hid.reshape(-1, hid.shape[-1]), groups, mm)
        return x + y.view_as(x), aux
    return x + mlp(p["ffn"], hid, mm), None


def serve_logits(m: dict, weights, prompts: torch.Tensor, served: torch.Tensor, mms=(fp32_mm,), rows: int = 8):
    """The logits from which each served token was chosen, by each product
    in ``mms``: as :func:`bench.reference.moe_decoder.serve_logits`, with
    MLA layers (``prompts`` [B, L0], ``served`` [B, G] → one ``[B, G, V]``
    fp32 tensor a product)."""
    b, l0 = prompts.shape
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    groups = serve_groups(b, tokens.shape[1], l0, tokens.device)
    with exact_fp32(), torch.no_grad():
        head = f32(weights(0))
        xs = [head["embed"][tokens] for _ in mms]
        for i, kind in enumerate(layer_seq(m)):
            p = f32(weights(1 + i))
            xs = [block(m, kind, p, x, groups, mm)[0] for x, mm in zip(xs, mms)]
            del p
        out = []
        for x, mm in zip(xs, mms):
            tail = x[:, l0 - 1 :]
            out.append(torch.cat([logits(m, head, tail[r : r + rows], mm) for r in range(0, b, rows)]))
    return out


def forward_loss(m: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor, mm):
    """``(loss, ce, aux)`` of one training call on ``tokens``/``labels`` [B, L]."""
    b, l = tokens.shape
    x = params["embed"][tokens.long()]
    groups = [torch.arange(b * l, device=tokens.device)]
    aux_total = torch.zeros((), device=tokens.device)
    for kind, p in zip(layer_seq(m), params["layers"]):
        x, aux = block(m, kind, p, x, groups, mm)
        if aux is not None:
            aux_total = aux_total + aux
    logp = torch.log_softmax(logits(m, params, x, mm), dim=-1)
    lab = labels.long()
    mask = (lab >= 0).float()
    ce = -(torch.gather(logp, -1, lab.clamp_min(0)[..., None])[..., 0] * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + m["moe"]["router_aux_weight"] * aux_total, ce, aux_total
