"""Attention mixer: ``q``, ``k``, ``v`` and ``o`` projections (MHA or GQA),
causal, RoPE on q and k."""

from __future__ import annotations

import math


def leaves(m: dict) -> list[tuple[tuple, tuple, float, bool]]:
    d, hd = m["d_model"], m["head_dim"]
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return [
        (("q", "w"), (d, qd), 1 / math.sqrt(d), False),
        (("k", "w"), (d, kvd), 1 / math.sqrt(d), False),
        (("v", "w"), (d, kvd), 1 / math.sqrt(d), False),
        (("o", "w"), (qd, d), 1 / math.sqrt(qd), False),
    ]


def macs(m: dict) -> int:
    d, hd = m["d_model"], m["head_dim"]
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return d * qd + 2 * d * kvd + qd * d


def key_flops(m: dict) -> int:
    """A query scores a key and sums its value in every head: ``4 H hd``."""
    return 4 * m["n_heads"] * m["head_dim"]
