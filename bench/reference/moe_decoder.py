"""Plain fp32 reference of the attention and MoE decoder that both
configurations run (their files' ``reference`` key names this module).

It is written from the models' published description and the port's stated
semantics, not from the port's code, and imports nothing of the program:

* pre-norm blocks ``x + attn(rms(x))``, then ``x + ffn(rms(x))``; RMSNorm
  scales by ``1 + w`` (eps ``norm_eps``);
* attention with split-half RoPE on q and k (theta ``rope_theta``), MHA or
  GQA, causal, softmax in fp32;
* a dense SiLU-gated MLP (deepseek's layer 0), or a MoE FFN: an fp32 router,
  softmax, top-k by a stable descending sort (ties to the lower expert),
  the k weights renormalised, SiLU-gated experts, plus ``n_shared`` shared
  experts on every token.  Capacity is the port's token-choice rule: the
  tokens of one call are taken in order, a choice gets the next free slot of
  its expert, and a choice past ``C = max(4, round_up_4(ceil(T k / E cf)))``
  is dropped (its token keeps the residual).  A call is a *group*: a
  prefill's whole batch, one decode step's batch, one pod's training batch;
* a final RMSNorm and the LM head (the embedding, transposed, when tied),
  over the true vocabulary;
* a layer of another kind is refused (:func:`block`); a reference for it is
  a module of its own beside this one, which may import :func:`rms`,
  :func:`rope`, :func:`moe_ffn` and :func:`logits` from here;
* training (:mod:`bench.reference.train_step`): next-token cross-entropy plus
  ``router_aux_weight`` times the summed Switch loss
  ``E sum_e (density_e / k) mean_prob_e``.

Everything is computed in fp32 with TF32 off (:func:`exact_fp32`).  Each
matrix product goes through ``mm``: :func:`fp32_mm`, or :func:`fp8_mm`,
the control, which rounds both operands to float8 e4m3 (one scale a
tensor) first, and in its backward the incoming gradient to e5m2.  The
router and the attention's own products stay fp32 in both.

Weights come from a callable ``weights(g)`` that returns group ``g`` (0 the
head, ``1 + i`` layer ``i``) in the port's layout; they are upcast here.
:func:`serve_logits` walks the model one layer at a time over whole
sequences (prompt and fed-back tokens), which equals prefill followed by
decode through a cache when the routing groups are kept: the prompt
positions of all sequences form one group, and each decode position of
all sequences another.  So only one layer's weights are held at a time.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..counts.flops import layer_seq

NEG_INF = -1e30


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 format with one scale (its amax to the
    format's largest value)."""
    s = torch.finfo(dtype).max / x.abs().amax().clamp_min(1e-30)
    return (x * s).to(dtype).float() / s


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` from operands rounded to e4m3; the backward's two products
    from the same operands and the incoming gradient rounded to e5m2 (the
    usual fp8 training recipe: e4m3 forward, e5m2 gradients)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a.detach()), fp8_round(b.detach())
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g, torch.float8_e5m2)
        da = qg @ qb.T
        db = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return da, db


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8MatMul.apply(a, b)


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


def rms(m: dict, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + m["norm_eps"]) * (1.0 + w)


def rope(m: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Split-half rotary embedding of ``x`` [B, S, H, hd] at ``pos`` [S]."""
    hd = x.shape[-1]
    inv = m["rope_theta"] ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: dict, p: dict, x: torch.Tensor, mm, rows: int = 8) -> torch.Tensor:
    """Causal self-attention over whole sequences ``x`` [B, S, d], ``rows``
    sequences at a time."""
    b, s, d = x.shape
    h, hk, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(s, device=x.device)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    outs = []
    for b0 in range(0, b, rows):
        xb = x[b0 : b0 + rows]
        n = xb.shape[0]
        q = rope(m, mm(xb, p["q"]["w"]).view(n, s, h, hd), pos)
        k = rope(m, mm(xb, p["k"]["w"]).view(n, s, hk, hd), pos)
        v = mm(xb, p["v"]["w"]).view(n, s, hk, hd)
        k, v = k.repeat_interleave(h // hk, dim=2), v.repeat_interleave(h // hk, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [n, H, S, hd]
        sc = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        sc = torch.where(causal, sc, NEG_INF)
        o = torch.softmax(sc, dim=-1) @ v
        outs.append(o.transpose(1, 2).reshape(n, s, h * hd))
    return mm(torch.cat(outs, dim=0), p["o"]["w"])


def mlp(p: dict, x: torch.Tensor, mm) -> torch.Tensor:
    return mm(F.silu(mm(x, p["gate"]["w"])) * mm(x, p["up"]["w"]), p["down"]["w"])


def capacity(m: dict, n_tokens: int) -> int:
    moe = m["moe"]
    c = math.ceil(n_tokens * moe["top_k"] / moe["n_experts"] * moe["capacity_factor"])
    return max(4, -(-c // 4) * 4)


def route(m: dict, p: dict, x: torch.Tensor, groups: list[torch.Tensor]):
    """Router, top-k and capacity for tokens ``x`` [T, d], whose calls are
    ``groups`` (each the token indices of one call, in the call's order).
    Returns ``(probs [T, E], weights [T, k], experts [T, k], keep [T, k])``."""
    moe = m["moe"]
    e, k = moe["n_experts"], moe["top_k"]
    probs = torch.softmax(x @ p["router"]["w"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :k], idx[:, :k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    order = torch.cat(groups)
    sizes = torch.tensor([len(g) for g in groups], device=x.device)
    starts = torch.cumsum(sizes, 0) - sizes
    caps = torch.tensor([capacity(m, len(g)) for g in groups], device=x.device)
    gid = torch.repeat_interleave(torch.arange(len(groups), device=x.device), sizes)
    eo = experts.detach()[order]
    onehot = F.one_hot(eo, e).sum(dim=1)  # [T, E], each token's k experts differ
    before = torch.cumsum(onehot, dim=0) - onehot  # earlier tokens' choices, all groups
    before = before - before[starts][gid]  # ... of the token's own group
    slot = torch.gather(before, 1, eo)
    keep = torch.empty_like(slot, dtype=torch.bool)
    keep[order] = slot < caps[gid][:, None]
    return probs, weights, experts, keep


def moe_ffn(m: dict, p: dict, x: torch.Tensor, groups: list[torch.Tensor], mm):
    """``(y [T, d], aux)`` of the MoE FFN over tokens ``x`` [T, d]."""
    moe = m["moe"]
    probs, weights, experts, keep = route(m, p, x, groups)
    y = torch.zeros_like(x)
    for ex in range(moe["n_experts"]):
        tok, j = torch.nonzero((experts == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, p["gate"][ex])) * mm(xe, p["up"][ex])
        y = y.index_add(0, tok, mm(h, p["down"][ex]) * weights[tok, j, None])
    if "shared" in p:
        y = y + mlp(p["shared"], x, mm)
    density = F.one_hot(experts, moe["n_experts"]).sum(dim=1).float().mean(dim=0)
    aux = moe["n_experts"] * torch.sum(density / moe["top_k"] * probs.mean(dim=0))
    return y, aux


def block(m: dict, kind, p: dict, x: torch.Tensor, groups: list[torch.Tensor], mm):
    """One layer over whole sequences ``x`` [B, S, d]; ``(x, aux or None)``.
    ``kind`` is the layer's ``(mixer, ffn)``; this reference computes an
    ``attn`` mixer and an ``mlp``, ``dense0`` or ``moe`` FFN, and refuses
    any other kind rather than compute it as one of these."""
    if kind[0] != "attn" or kind[1] not in ("mlp", "dense0", "moe"):
        raise ValueError(f"bench/reference/moe_decoder.py does not compute a {kind} layer")
    x = x + attention(m, p["mixer"], rms(m, x, p["norm1"]["w"]), mm)
    h = rms(m, x, p["norm2"]["w"])
    if kind[1] == "moe":
        y, aux = moe_ffn(m, p["ffn"], h.reshape(-1, h.shape[-1]), groups, mm)
        return x + y.view_as(x), aux
    return x + mlp(p["ffn"], h, mm), None


def logits(m: dict, head: dict, x: torch.Tensor, mm) -> torch.Tensor:
    """fp32 logits over the true vocabulary."""
    w = head["embed"].T if m.get("tied_embeddings", False) else head["lm_head"]["w"]
    return mm(rms(m, x, head["final_norm"]["w"]), w)[..., : m["vocab"]]


def serve_groups(b: int, s: int, prompt_len: int, device) -> list[torch.Tensor]:
    """The routing calls of a prefill of ``b`` prompts of ``prompt_len``
    tokens and its decode steps, as token indices into ``[B, S]`` flattened:
    the prompt positions batch-major, then each later position's batch."""
    rows = torch.arange(b, device=device)[:, None] * s
    groups = [(rows + torch.arange(prompt_len, device=device)).reshape(-1)]
    groups += [rows[:, 0] + t for t in range(prompt_len, s)]
    return groups


def serve_logits(m: dict, weights, prompts: torch.Tensor, served: torch.Tensor, mms=(fp32_mm,), rows: int = 8):
    """The logits from which each served token was chosen, by each product in ``mms``.

    ``prompts`` [B, L0] and ``served`` [B, G] (the first from the prefill,
    each later one from a decode step fed the one before).  Returns one
    ``[B, G, V]`` fp32 tensor a product: position ``L0 - 1 + j`` of each
    sequence, the logits of served token ``j``.
    """
    b, l0 = prompts.shape
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    s = tokens.shape[1]
    groups = serve_groups(b, s, l0, tokens.device)
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


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each chosen token's lies:
    ``ref`` [..., V], ``chosen`` [...] → [...]."""
    return ref.amax(dim=-1) - torch.gather(ref, -1, chosen.long()[..., None])[..., 0]


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
