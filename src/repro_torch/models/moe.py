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
its ``einsum``s to XLA.  While a profiler records, the stages are the spans
``model.moe.route`` (router, softmax, top-k, slots and the aux loss),
``.dispatch`` (the scatter), ``.experts`` (the three ``bmm``), ``.combine``
(the gather and the weighted sum) and ``.shared``
(:func:`repro_torch.obs.span`).

H2 (hints): :func:`apply_moe_sharded` is the reference's expert-local
dispatch, which the model takes under ``set_hints``.  Each (dp, tp) rank
routes its *local* tokens, keeps only the choices owned by its local
experts (slots over the local tokens, capacity ``moe_capacity(cfg,
t_local)``), runs a local scatter, expert MLP and gather, and the partial
outputs meet in one sum over TP: an ``all_reduce``, or a ``reduce_scatter``
over the sequence when the residual stream is sequence-sharded (H4).  The
router statistics of the aux loss are averaged over the data ranks.  The
body, :func:`_local_moe_body`, is the reference's line for line (no router
bias, as there), on ``hints.shard_map`` with the reference's in- and
out-specs.  It is not :func:`apply_moe`: its slots and drops are local.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.obs.events import span

from .config import ModelConfig
from .hints import DTensor, pin, replicated_like, shard_map, unshard
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
    """``jax.lax.top_k`` over the last axis: descending, ties to the lower
    index.  On DTensors, on each rank's rows (every other dim gathered): the
    backward of ``sort`` scatters into a plain tensor, which DTensor refuses
    on torch 2.11."""
    if isinstance(probs, DTensor):
        from torch.distributed.tensor import Replicate

        pl = tuple(p if p.is_shard(0) else Replicate() for p in probs.placements)
        return shard_map(lambda p: top_k(p, k), probs.device_mesh, (pl,), (pl, pl))(probs)
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


def _on_replicas(fn, *ts: torch.Tensor) -> torch.Tensor:
    """``fn(*ts)``; on DTensors, on every rank's whole copy of each (gathered
    first), the result replicated.  The dispatch's scatter and gather go
    there: DTensor has no rule for ``index_add_`` on torch 2.11, and on 2.13
    its rule re-places a replicated buffer without moving its data when the
    rows are sharded."""
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    from torch.distributed.tensor import Replicate

    rep = (Replicate(),) * ts[0].device_mesh.ndim
    return shard_map(fn, ts[0].device_mesh, (rep,) * len(ts), rep)(*ts)


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d] → (y [B, L, d], aux fp32 scalar)."""
    m = cfg.moe
    b, l, d = x.shape
    t, k = b * l, m.top_k
    xf = pin(unshard(x, [1]).reshape(t, d))  # flattening a sharded L: see hints.matmul
    with span("model.moe.route"):
        r = route(cfg, p, xf)
        aux = aux_loss(cfg, r)

    cap = moe_capacity(cfg, t)
    with span("model.moe.dispatch"):
        flat_e = r.experts.reshape(t * k)
        rows = flat_e * cap + torch.where(r.keep, r.slot, cap - 1)  # rows of [E·C, d]

        # Scatter tokens into [E, C, d]; dropped choices add zero rows.
        xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)  # choice-major: row t·k + j is token t
        contrib = torch.where(r.keep[:, None], xk, 0.0)
        buf = replicated_like(torch.zeros((m.n_experts * cap, d), dtype=x.dtype, device=x.device), x)
        buf = _on_replicas(lambda b, i, c: b.index_add(0, i, c), buf, rows, contrib).view(m.n_experts, cap, d)

    # Batched expert gated MLP over the expert axis.
    with span("model.moe.experts"):
        h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
        out_buf = torch.bmm(h, p["down"]).view(m.n_experts * cap, d)  # [E·C, d]

    # Gather back and combine.
    with span("model.moe.combine"):
        fetched = _on_replicas(lambda o, i: o.index_select(0, i), out_buf, rows)  # [T·k, d]
        fetched = torch.where(r.keep[:, None], fetched, 0.0)
        yk = fetched.view(t, k, d) * r.weights[..., None].to(x.dtype)
        y = torch.sum(yk, dim=1)

    if "shared" in p:
        sh = p["shared"]
        with span("model.moe.shared"):
            y = y + linear(sh["down"], F.silu(linear(sh["gate"], xf)) * linear(sh["up"], xf))
    return y.reshape(b, l, d), aux


# ---------------------------------------------------------------------------
# H2 (hints): expert-local dispatch under shard_map
# ---------------------------------------------------------------------------


def _local_moe_body(cfg: ModelConfig, mesh, tp_axis: str, tp_size: int, dp_axes, *, scatter_out: bool):
    import torch.distributed.nn.functional as dnn

    m = cfg.moe
    e_local = m.n_experts // tp_size
    dp_groups = [mesh.get_group(a) for a in ((dp_axes,) if isinstance(dp_axes, str) else dp_axes)]
    tp_group = mesh.get_group(tp_axis)

    def collective(fn, *args, **kw):
        # torch marks these deprecated for the functional collectives, which
        # have no autograd for an all-reduce.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            return fn(*args, **kw)

    def pmean(v: torch.Tensor) -> torch.Tensor:
        n = 1
        for g in dp_groups:
            v = collective(dnn.all_reduce, v, group=g)
            n *= torch.distributed.get_world_size(g)
        return v / n

    def body(x_l, router, gate, up, down, sh_gate, sh_up, sh_down):
        # x_l: [B_loc, L, d] (replicated over tp); gate/up/down: local experts
        b, l, d = x_l.shape
        t = b * l
        k = m.top_k
        xf = x_l.reshape(t, d)

        logits = xf.float() @ router  # router replicated [d, E]
        probs = torch.softmax(logits, dim=-1)
        weights, experts = top_k(probs, k)
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

        # aux loss from globally-reduced router statistics
        density_l = torch.mean(F.one_hot(experts, m.n_experts).sum(dim=1).float(), dim=0)
        mean_prob_l = torch.mean(probs, dim=0)
        # tokens are sharded over dp only; tp shards see identical stats.
        density = pmean(density_l)
        mean_prob = pmean(mean_prob_l)
        aux = m.n_experts * torch.sum(density / k * mean_prob)

        # my expert range on this tp shard
        tp_idx = mesh.get_local_rank(tp_axis)
        e_start = tp_idx * e_local

        cap = moe_capacity(cfg, t)
        flat_e = experts.reshape(t * k)
        local_e = flat_e - e_start  # [T·k] in [0, e_local) if mine
        mine = (local_e >= 0) & (local_e < e_local)
        local_e_c = torch.where(mine, local_e, 0)

        onehot = F.one_hot(local_e_c, e_local).to(torch.int32)
        onehot = onehot * mine[:, None].to(torch.int32)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        slot = torch.sum(pos * onehot, dim=-1)
        keep = mine & (slot < cap)
        slot_c = torch.where(keep, slot, cap - 1).long()
        rows = local_e_c * cap + slot_c  # rows of [e_local·C, d]

        xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
        contrib = torch.where(keep[:, None], xk, 0.0).to(x_l.dtype)
        buf = torch.zeros((e_local * cap, d), dtype=x_l.dtype, device=x_l.device)
        buf = buf.index_add_(0, rows, contrib).view(e_local, cap, d)

        h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
        out_buf = torch.bmm(h, down).view(e_local * cap, d)

        fetched = out_buf.index_select(0, rows)
        fetched = torch.where(keep[:, None], fetched, 0.0)
        yk = fetched.view(t, k, d) * weights[..., None].to(x_l.dtype)
        y = torch.sum(yk, dim=1)

        if sh_gate is not None:
            # shared experts: column-parallel gate/up, row-parallel down —
            # their partial sum rides the same sum over TP as the routed experts.
            hs = F.silu(xf @ sh_gate) * (xf @ sh_up)
            y = y + hs @ sh_down

        # One collective over TP for the whole MoE layer; with an SP
        # residual stream a reduce-scatter over the token axis.
        if scatter_out:
            chunks = [c.contiguous() for c in y.reshape(b, l, d).chunk(tp_size, dim=1)]
            return collective(dnn.reduce_scatter, torch.empty_like(chunks[0]), chunks, group=tp_group), aux
        y = collective(dnn.all_reduce, y, group=tp_group)
        return y.reshape(b, l, d), aux

    return body


def apply_moe_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-local MoE dispatch (requires installed ShardHints; x and the
    params are DTensors on the hints' mesh)."""
    from .hints import get_hints, placements

    h = get_hints()
    if h is None:
        raise RuntimeError("apply_moe_sharded needs ShardHints (set_hints)")
    mesh = h.mesh
    tp, dp = h.tp_axis, h.dp_spec()

    def pl(*spec):
        return placements(*spec, mesh=mesh)

    none2 = pl(None, None)
    shared = (None, None, None)
    shared_pl = (None, None, None)
    if "shared" in p:
        shared = (p["shared"]["gate"]["w"], p["shared"]["up"]["w"], p["shared"]["down"]["w"])
        shared_pl = (pl(None, tp), pl(None, tp), pl(tp, None))

    dp_axes = h.dp_axes if len(h.dp_axes) > 1 else h.dp_axes[0]
    scatter_out = h.seq_parallel_residual and x.shape[1] % (h.tp_size * h.tp_size) == 0
    body = _local_moe_body(cfg, mesh, tp, h.tp_size, dp_axes, scatter_out=scatter_out)
    fn = shard_map(
        body,
        mesh,
        (
            pl(dp, None, None),  # x
            none2,  # router (replicated)
            pl(tp, None, None),  # gate [E, d, de] expert-sharded
            pl(tp, None, None),  # up
            pl(tp, None, None),  # down
            *shared_pl,  # shared expert weights (column/row parallel)
        ),
        (pl(dp, tp if scatter_out else None, None), pl()),
    )
    return fn(x, p["router"]["w"], p["gate"], p["up"], p["down"], *shared)
