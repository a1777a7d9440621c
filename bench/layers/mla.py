"""Multi-head latent attention (DeepSeek-V2) mixer: ``q`` (no q LoRA),
``kv_a`` (the ``kv_lora_rank``-wide latent and the shared RoPE key), the
latent's RMSNorm ``kv_norm``, ``kv_b`` (each head's ``k_nope`` and ``v``
from the latent) and ``o``; widths from the configuration's ``mla`` section."""

from __future__ import annotations

import math

from ..harness.weights import NORM_STD


def _widths(m: dict) -> tuple[int, int, int, int, int, int]:
    a = m["mla"]
    return (m["d_model"], m["n_heads"], a["kv_lora_rank"], a["qk_nope_head_dim"], a["qk_rope_head_dim"],
            a["v_head_dim"])


def leaves(m: dict) -> list[tuple[tuple, tuple, float, bool]]:
    d, h, c, n, r, v = _widths(m)
    return [
        (("q", "w"), (d, h * (n + r)), 1 / math.sqrt(d), False),
        (("kv_a", "w"), (d, c + r), 1 / math.sqrt(d), False),
        (("kv_norm", "w"), (c,), NORM_STD, False),
        (("kv_b", "w"), (c, h * (n + v)), 1 / math.sqrt(c), False),
        (("o", "w"), (h * v, d), 1 / math.sqrt(h * v), False),
    ]


def macs(m: dict) -> int:
    d, h, c, n, r, v = _widths(m)
    return d * h * (n + r) + d * (c + r) + c * h * (n + v) + h * v * d


def key_flops(m: dict) -> int:
    """The model's own attention, not the absorbed kernel's: a query scores
    a key over ``n + r`` dims and sums its ``v``-wide value, in every head."""
    _, h, _, n, r, v = _widths(m)
    return 2 * h * (n + r) + 2 * h * v
