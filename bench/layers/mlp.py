"""Dense SiLU-gated MLP: ``gate`` and ``up`` of width ``d_ff``, then ``down``."""

from __future__ import annotations

import math


def leaves(m: dict) -> list[tuple[tuple, tuple, float, bool]]:
    d, f = m["d_model"], m["d_ff"]
    return [
        (("gate", "w"), (d, f), 1 / math.sqrt(d), False),
        (("up", "w"), (d, f), 1 / math.sqrt(d), False),
        (("down", "w"), (f, d), 1 / math.sqrt(f), False),
    ]


def macs(m: dict) -> int:
    return 3 * m["d_model"] * m["d_ff"]
