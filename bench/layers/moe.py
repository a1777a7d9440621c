"""MoE FFN: an fp32 router over ``n_experts``, SiLU-gated experts of width
``d_expert`` (``gate``/``up [E, d, d_e]``, ``down [E, d_e, d]``), and
``n_shared`` shared experts as one dense MLP of ``n_shared * d_expert``."""

from __future__ import annotations

import math


def leaves(m: dict) -> list[tuple[tuple, tuple, float, bool]]:
    d, moe = m["d_model"], m["moe"]
    e, de = moe["n_experts"], moe["d_expert"]
    out = [
        (("router", "w"), (d, e), 1 / math.sqrt(d), True),
        (("gate",), (e, d, de), 1 / math.sqrt(d), False),
        (("up",), (e, d, de), 1 / math.sqrt(d), False),
        (("down",), (e, de, d), 1 / math.sqrt(de), False),
    ]
    if moe.get("n_shared", 0):
        ds = moe["n_shared"] * de
        out += [
            (("shared", "gate", "w"), (d, ds), 1 / math.sqrt(d), False),
            (("shared", "up", "w"), (d, ds), 1 / math.sqrt(d), False),
            (("shared", "down", "w"), (ds, d), 1 / math.sqrt(ds), False),
        ]
    return out


def macs(m: dict) -> int:
    """The router, the ``top_k`` routed experts and the shared ones, whether
    or not capacity drops a choice."""
    d, moe = m["d_model"], m["moe"]
    return d * moe["n_experts"] + (moe["top_k"] + moe.get("n_shared", 0)) * 3 * d * moe["d_expert"]
