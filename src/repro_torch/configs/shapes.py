"""A copy of ``repro/configs/shapes.py``.

Assigned input shapes and the (arch × shape) cell enumeration.

Shape semantics (per the assignment):

* ``train_4k``    — ``train_step``: seq 4 096 × global batch 256;
* ``prefill_32k`` — ``prefill_step``: seq 32 768 × global batch 32;
* ``decode_32k``  — ``serve_step``: ONE new token against a 32 768-row KV
  cache, global batch 128;
* ``long_500k``   — ``serve_step``: one token against 524 288 context,
  batch 1 — run only for sub-quadratic archs (SSM/hybrid); pure
  full-attention archs skip it (see DESIGN.md §Shape policy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Literal

Kind = Literal["train", "prefill", "decode"]


@dataclass(frozen=True)
class Shape:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# Sub-quadratic decode state ⇒ long_500k is runnable.
SUBQUADRATIC = {"xlstm-125m", "jamba-v0.1-52b"}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full-attention arch: 500k decode is quadratic-cost (assignment: skip)"
    return True, ""


def cells(arch_names: list[str]) -> Iterator[tuple[str, Shape]]:
    """All applicable (arch, shape) cells."""
    for a in arch_names:
        for s in SHAPES.values():
            ok, _ = shape_applicable(a, s.name)
            if ok:
                yield a, s
