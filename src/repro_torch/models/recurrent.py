"""Recurrent mixers: Mamba selective scan, xLSTM mLSTM/sLSTM.

The port of ``repro.models.recurrent``, line for line, in plain functions on
tensors; init draws from an explicit ``torch.Generator``.  Every sequence
recurrence is *chunked*: within a chunk it is evaluated in a parallel form,
and chunks are chained through a small carried state, the same state that
decoding carries from step to step.  sLSTM is the one strictly sequential
cell (scalar memory with recurrent weights): the reference's ``lax.scan``
becomes a loop over time.

Where the two frameworks differ:

* ``jax.lax.associative_scan`` (Mamba's chunk scan) has no torch
  counterpart.  :func:`_ssm_chunk_scan` is a log-depth Hillis–Steele scan
  over the chunk axis with the reference's combine
  ``(al + ar, exp(ar)·bl + br)``: ⌈log₂ c⌉ rounds of elementwise ops, no
  ``exp(−A)`` that could overflow.  The two scans associate the same terms
  in different trees, so they agree to fp32 rounding, not bit for bit.
* ``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns ``x``
  above its threshold, so the port takes ``torch.logaddexp`` as well.
* ``jax.lax.cummax`` is ``torch.cummax(...).values``.

Carried state keeps the reference's dtypes: the Mamba SSM state leaves each
call rounded to the model's dtype, its conv carry holds the pre-conv inputs
in their own dtype, and the mLSTM and sLSTM states stay fp32 with ``m``
starting at ``-1e30``.  Nothing here reads a value back to the host: shapes
are static and no op waits on the device.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import init_linear, linear

Params = dict[str, Any]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact at every ``x``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba (selective state-space) block
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, d_inner] — trailing inputs
    ssm: torch.Tensor  # [B, d_inner, d_state]


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    di, ds, dtr = d_inner(cfg), cfg.ssm.d_state, dt_rank(cfg)
    dev = gen.device
    f32 = torch.float32
    # S4D-real initialisation for A; dt bias init for softplus ≈ [1e-3, 1e-1]
    a = torch.arange(1, ds + 1, dtype=f32, device=dev)[None, :].repeat(di, 1)
    in_proj = init_linear(gen, cfg.d_model, 2 * di, dtype)
    conv_w = torch.randn((cfg.ssm.d_conv, di), generator=gen, device=dev, dtype=f32) * 0.1
    x_proj = init_linear(gen, di, dtr + 2 * ds, dtype)
    dt_w = torch.randn((dtr, di), generator=gen, device=dev, dtype=f32) / math.sqrt(dtr)
    dt_u = torch.rand((di,), generator=gen, device=dev, dtype=f32)
    dt_b = torch.log(
        torch.exp(torch.exp(dt_u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))) - 1.0
    )
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_proj": {"w": dt_w.to(dtype), "b": dt_b},
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": init_linear(gen, di, cfg.d_model, dtype),
    }


def _ssm_chunk_scan(
    abar_log: torch.Tensor,  # [B, c, di, ds] — log of decay exp(dt·A) (≤ 0)
    bu: torch.Tensor,  # [B, c, di, ds] — dt·B_t·u_t
    h0: torch.Tensor,  # [B, di, ds]
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(abar_log_t)·h_{t-1} + bu_t within one chunk.

    Inclusive scan of (decay, value) pairs, Hillis–Steele: in the round of
    offset s, step t ≥ s combines the prefix ending at t − s (left) with its
    own (right).  Returns (h per step [B, c, di, ds], final h).
    """
    a_acc, b_acc = abar_log, bu
    c = a_acc.shape[1]
    s = 1
    while s < c:
        al, bl = a_acc[:, :-s], b_acc[:, :-s]
        ar, br = a_acc[:, s:], b_acc[:, s:]
        a_acc = torch.cat([a_acc[:, :s], al + ar], dim=1)
        b_acc = torch.cat([b_acc[:, :s], torch.exp(ar) * bl + br], dim=1)
        s *= 2
    h = torch.exp(a_acc) * h0[:, None] + b_acc
    return h, h[:, -1]


def mamba_mix(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, L, d]
    state: MambaState | None = None,
) -> tuple[torch.Tensor, MambaState]:
    """Apply the Mamba mixer; returns (y [B, L, d], new state)."""
    b, l, _ = x.shape
    di, ds, dtr = d_inner(cfg), cfg.ssm.d_state, dt_rank(cfg)
    dc = cfg.ssm.d_conv
    f32 = torch.float32

    xz = linear(p["in_proj"], x)  # [B, L, 2·di]
    u, z = torch.chunk(xz, 2, dim=-1)

    # Depthwise causal conv over time (kernel dc), carrying dc-1 inputs.
    if state is None:
        conv_carry = torch.zeros((b, dc - 1, di), dtype=u.dtype, device=u.device)
    else:
        conv_carry = state.conv
    u_ext = torch.cat([conv_carry, u], dim=1)  # [B, L+dc-1, di]
    conv = sum(u_ext[:, i : i + l] * p["conv_w"][i][None, None, :] for i in range(dc))
    u = F.silu(conv + p["conv_b"])
    new_conv_carry = u_ext[:, -(dc - 1) :] if dc > 1 else conv_carry

    # Input-dependent SSM parameters.
    xp = linear(p["x_proj"], u)  # [B, L, dtr+2·ds]
    dt_in, bmat, cmat = torch.split(xp, [dtr, ds, ds], dim=-1)
    dt = _softplus(
        dt_in.to(f32) @ p["dt_proj"]["w"].to(f32) + p["dt_proj"]["b"]
    )  # [B, L, di]
    a = -torch.exp(p["A_log"])  # [di, ds]

    abar_log = dt[..., None] * a[None, None]  # [B, L, di, ds]  (≤ 0)
    bu = (dt * u.to(f32))[..., None] * bmat.to(f32)[:, :, None, :]  # [B, L, di, ds]

    h0 = torch.zeros((b, di, ds), dtype=f32, device=x.device) if state is None else state.ssm.to(f32)
    chunk = min(cfg.ssm.chunk, l)
    ys = []
    for s in range(0, l, chunk):
        e = min(s + chunk, l)
        h, h0 = _ssm_chunk_scan(abar_log[:, s:e], bu[:, s:e], h0)
        ys.append(torch.einsum("bcds,bcs->bcd", h, cmat[:, s:e].to(f32)))
    y = torch.cat(ys, dim=1) + p["D"] * u.to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = linear(p["out_proj"], y)
    return out, MambaState(conv=new_conv_carry, ssm=h0.to(x.dtype))


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner(cfg)), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_inner(cfg), cfg.ssm.d_state), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# xLSTM — mLSTM (matrix memory, parallel/chunked) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dk, dv] matrix memory
    n: torch.Tensor  # [B, H, dk] normalizer
    m: torch.Tensor  # [B, H] log-space stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, d]
    n: torch.Tensor  # [B, d]
    h: torch.Tensor  # [B, d]
    m: torch.Tensor  # [B, d]


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, qd = cfg.d_model, cfg.q_dim
    return {
        "q": init_linear(gen, d, qd, dtype),
        "k": init_linear(gen, d, qd, dtype),
        "v": init_linear(gen, d, qd, dtype),
        "i_gate": init_linear(gen, d, cfg.n_heads, torch.float32),
        "f_gate": init_linear(gen, d, cfg.n_heads, torch.float32),
        "o": init_linear(gen, qd, d, dtype),
    }


def _mlstm_chunk(
    q, k, v,  # [B, c, H, dh] (q pre-scaled by 1/sqrt(dh))
    li, lf,  # [B, c, H] log input gate preact / log-sigmoid forget
    state: MLSTMState,
) -> tuple[torch.Tensor, MLSTMState]:
    """Stabilised chunk-parallel mLSTM (xLSTM eqs. 19-27, chunked).

    For target t and source s ≤ t the contribution weight is
    ``exp(Σ_{r=s+1..t} lf_r + li_s − m_t)``; the carry from earlier chunks
    enters with weight ``exp(Σ_{r≤t} lf_r + m_prev − m_t)``.  ``m_t`` is the
    running log-max that keeps every exponent ≤ 0.
    """
    b, c, h, dh = q.shape
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)

    cum = torch.cumsum(lf, dim=1)  # [B, c, H] — Σ_{r≤t} lf_r
    g = li - cum  # per-source log weight −cum_s + li_s
    m_intra = torch.cummax(g, dim=1).values + cum  # max_{s≤t}(g_s) + cum_t
    m_inter = cum + state.m[:, None]
    m = torch.maximum(m_intra, m_inter)  # [B, c, H]

    # Intra-chunk pairwise term.
    logits = torch.einsum("bthd,bshd->bhts", q, k)  # [B, H, t, s]
    cum_t = cum.permute(0, 2, 1)  # [B, H, c]
    g_s = g.permute(0, 2, 1)
    m_t = m.permute(0, 2, 1)
    w_log = cum_t[:, :, :, None] + g_s[:, :, None, :] - m_t[:, :, :, None]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    # Masked before the exp, not after it as the reference does: the same
    # forward values, but above the diagonal w_log grows with the distance
    # (cum falls by ~0.7 a token), exp overflows to inf past ~130 tokens, and
    # the backward's 0 · inf made every grad below this layer NaN.
    w = torch.exp(torch.where(causal[None, None], w_log, -math.inf))
    scores = logits * w  # [B, H, t, s]

    num_intra = torch.einsum("bhts,bshd->bthd", scores, v)  # [B, c, H, dh]
    den_intra = torch.sum(scores, dim=-1).permute(0, 2, 1)  # [B, c, H]

    # Inter-chunk (carry) term.
    w_inter = torch.exp(torch.clamp_max(cum + state.m[:, None] - m, 0.0))  # [B, c, H]
    num_inter = torch.einsum("bthd,bhde->bthe", q, state.c) * w_inter[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", q, state.n) * w_inter

    num = num_intra + num_inter
    den = den_intra + den_inter
    y = num / torch.maximum(torch.abs(den), torch.exp(-m))[..., None]

    # Carry for the next chunk, stabilised at m_carry = m at the last step.
    m_carry = m[:, -1]  # [B, H]
    last_cum = cum[:, -1]
    w_old = torch.exp(torch.clamp_max(state.m + last_cum - m_carry, 0.0))
    w_src = torch.exp(torch.clamp_max(last_cum[:, None] + g - m_carry[:, None], 0.0))
    c_new = state.c * w_old[..., None, None] + torch.einsum("bshd,bshe,bsh->bhde", k, v, w_src)
    n_new = state.n * w_old[..., None] + torch.einsum("bshd,bsh->bhd", k, w_src)
    return y, MLSTMState(c=c_new, n=n_new, m=m_carry)


def mlstm_mix(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    state: MLSTMState | None = None,
) -> tuple[torch.Tensor, MLSTMState]:
    b, l, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    q = linear(p["q"], x).reshape(b, l, h, dh) / math.sqrt(dh)
    k = linear(p["k"], x).reshape(b, l, h, dh)
    v = linear(p["v"], x).reshape(b, l, h, dh)
    li = linear(p["i_gate"], x.to(f32))  # [B, L, H] log-space
    lf = F.logsigmoid(linear(p["f_gate"], x.to(f32)))

    if state is None:
        state = init_mlstm_state(cfg, b, x.device)
    chunk = min(cfg.ssm.chunk, l)
    ys = []
    for s in range(0, l, chunk):
        e = min(s + chunk, l)
        y, state = _mlstm_chunk(q[:, s:e], k[:, s:e], v[:, s:e], li[:, s:e], lf[:, s:e], state)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype).reshape(b, l, h * dh)
    return linear(p["o"], y), state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    h, dh = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        n=torch.zeros((batch, h, dh), dtype=f32, device=device),
        m=torch.full((batch, h), -1e30, dtype=f32, device=device),
    )


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d = cfg.d_model
    gates = {}
    # keys g_i/g_f/g_z/g_o: unambiguous vs. attention's o-projection in the
    # path-based sharding rules.
    for g in ("g_i", "g_f", "g_z", "g_o"):
        gates[g] = {
            "w": init_linear(gen, d, d, dtype)["w"],
            "r": init_linear(gen, d, d, dtype)["w"],
            "b": torch.zeros((d,), dtype=torch.float32, device=gen.device),
        }
    return gates


def slstm_mix(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    state: SLSTMState | None = None,
) -> tuple[torch.Tensor, SLSTMState]:
    """Sequential sLSTM cell with exponential gating (a loop over time)."""
    b, l, d = x.shape
    f32 = torch.float32
    if state is None:
        state = init_slstm_state(cfg, b, x.device)

    # Precompute input contributions for all gates: [B, L, d] each.
    gate_names = ("g_i", "g_f", "g_z", "g_o")
    pre = {g: (x @ p[g]["w"]).to(f32) + p[g]["b"] for g in gate_names}
    rw = {g: p[g]["r"].to(f32) for g in gate_names}

    c, n, h, m = state
    hs = []
    for t in range(l):
        it = pre["g_i"][:, t] + h @ rw["g_i"]
        ft = pre["g_f"][:, t] + h @ rw["g_f"]
        zt = torch.tanh(pre["g_z"][:, t] + h @ rw["g_z"])
        ot = torch.sigmoid(pre["g_o"][:, t] + h @ rw["g_o"])
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp_min(torch.abs(n), 1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)  # [B, L, d]
    return y, SLSTMState(c, n, h, m)


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=torch.full((batch, d), -1e30, dtype=torch.float32, device=device))
