"""Mixture-of-Experts FFN: token-choice top-k routing with capacity.

The port of ``repro.models.moe`` (``init_moe``, ``moe_capacity``,
``apply_moe``), step for step:

1. fp32 router logits → softmax → top-k (expert, weight) choices per token,
   the weights renormalised over the k;
2. each choice gets a *slot* inside its expert's capacity buffer from a
   running count (cumsum) over the choice-major flattened ``[T·k]`` list
   (token t owns rows ``t·k … t·k+k-1``); choices beyond capacity
   ``C = max(4, round_up_4(ceil(T·k/E · capacity_factor)))`` are dropped,
   so their token falls through the residual (Switch behaviour);
3. ``x`` rows are scattered into an ``[E, C, d]`` buffer, the experts run as
   one batched gated MLP (SiLU) over the expert axis, and the results are
   gathered back and combined with the routing weights in ``x``'s dtype;
   the shared experts (``n_shared > 0``) are added on top.

The Switch load-balance loss ``E · Σ_e (density_e / k) · mean_prob_e`` is
returned beside the output so that ``Model.loss`` can add
``router_aux_weight ×`` it.

Shapes stay static and nothing waits on the device: no ``.item()``, no
``nonzero``, no boolean-mask indexing.  Top-k is a stable descending sort,
so tied probabilities go to the lower expert index first, as
``jax.lax.top_k`` breaks them.  The scatter is an ``index_add_``: a dropped
choice adds a zero row to slot ``C - 1`` of its expert, as the reference's
``.at[].add(mode="drop")`` does, and never overwrites the token kept there.
The three expert products are ``torch.bmm`` calls, as the reference leaves
its ``einsum``s to XLA.

The reference's expert-parallel variant under ``shard_map``
(``apply_moe_sharded``) belongs with distribution (ROADMAP queue A, A7).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import init_linear, linear

Params = dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    """The reference's tree: an fp32 router ``{"w": [d, E]}`` whatever the
    model's dtype, ``gate``/``up`` ``[E, d, d_e]``, ``down`` ``[E, d_e, d]``,
    and ``shared.{gate,up,down}`` of width ``n_shared · d_e``."""
    m = cfg.moe
    d = cfg.d_model
    dev = gen.device

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.randn((m.n_experts, d_in, d_out), generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    p: Params = {
        "router": init_linear(gen, d, m.n_experts, torch.float32),
        "gate": experts(d, m.d_expert),
        "up": experts(d, m.d_expert),
        "down": experts(m.d_expert, d),
    }
    if m.n_shared:
        d_sh = m.n_shared * m.d_expert
        p["shared"] = {
            "gate": init_linear(gen, d, d_sh, dtype),
            "up": init_linear(gen, d, d_sh, dtype),
            "down": init_linear(gen, d_sh, d, dtype),
        }
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


class Routing(NamedTuple):
    """One MoE call's routing, each choice-major over ``[T, k]``."""

    probs: torch.Tensor  # [T, E] fp32 router softmax
    weights: torch.Tensor  # [T, k] fp32, renormalised over the k
    experts: torch.Tensor  # [T, k] int64, descending probability
    slot: torch.Tensor  # [T·k] int64, the choice's place in its expert's buffer
    keep: torch.Tensor  # [T·k] bool, slot < capacity


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor) -> Routing:
    """Router, top-k and slots for tokens ``xf`` [T, d]."""
    m = cfg.moe
    logits = linear(p["router"], xf.float())  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, experts = top_k(probs, m.top_k)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return Routing(probs, weights, experts, *slots(cfg, experts))


def slots(cfg: ModelConfig, experts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Choice (t, j) takes the next free slot of its expert: ``(slot, keep)``,
    each ``[T·k]``, from the choices ``experts`` [T, k]."""
    flat_e = experts.reshape(-1)  # [T·k], choice-major
    onehot = F.one_hot(flat_e, cfg.moe.n_experts).to(torch.int32)  # [T·k, E]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # prior same-expert choices
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0].long()
    return slot, slot < moe_capacity(cfg, experts.shape[0])


def aux_loss(cfg: ModelConfig, r: Routing) -> torch.Tensor:
    """Switch load-balance loss, fp32 scalar: ``E · Σ_e (density_e / k) · mean_prob_e``."""
    m = cfg.moe
    # fraction of tokens whose choice set includes e (×k)
    density = torch.mean(F.one_hot(r.experts, m.n_experts).sum(dim=1).float(), dim=0)
    mean_prob = torch.mean(r.probs, dim=0)
    return m.n_experts * torch.sum(density / m.top_k * mean_prob)


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d] → (y [B, L, d], aux fp32 scalar)."""
    m = cfg.moe
    b, l, d = x.shape
    t, k = b * l, m.top_k
    xf = x.reshape(t, d)
    r = route(cfg, p, xf)
    aux = aux_loss(cfg, r)

    cap = moe_capacity(cfg, t)
    flat_e = r.experts.reshape(t * k)
    rows = flat_e * cap + torch.where(r.keep, r.slot, cap - 1)  # rows of [E·C, d]

    # Scatter tokens into [E, C, d]; dropped choices add zero rows.
    xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)  # choice-major: row t·k + j is token t
    contrib = torch.where(r.keep[:, None], xk, 0.0)
    buf = torch.zeros((m.n_experts * cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add_(0, rows, contrib).view(m.n_experts, cap, d)

    # Batched expert gated MLP over the expert axis.
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out_buf = torch.bmm(h, p["down"]).view(m.n_experts * cap, d)  # [E·C, d]

    # Gather back and combine.
    fetched = out_buf.index_select(0, rows)  # [T·k, d]
    fetched = torch.where(r.keep[:, None], fetched, 0.0)
    yk = fetched.view(t, k, d) * r.weights[..., None].to(x.dtype)
    y = torch.sum(yk, dim=1)

    if "shared" in p:
        sh = p["shared"]
        y = y + linear(sh["down"], F.silu(linear(sh["gate"], xf)) * linear(sh["up"], xf))
    return y.reshape(b, l, d), aux
