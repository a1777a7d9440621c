"""Layer kinds by name: ``bench/layers/<kind>.py``, one module a mixer kind
(the ``attn`` of a configuration's ``pattern``) and one an FFN kind
(``mlp``, ``moe``), as the port's ``ModelConfig`` names them.

A kind's module gives, from a configuration's ``model`` section ``m``:

* ``leaves(m)``: ``(path, shape, std, fp32)`` of each weight below the
  layer's ``mixer`` or ``ffn``, in the order the weights are drawn
  (:mod:`bench.harness.weights`);
* ``macs(m)``: a token's multiply-adds in the kind's weight products
  (:mod:`bench.counts.flops`);
* a mixer's ``key_flops(m)``: FLOPs a query spends on each key it sees
  (0 for a kind without keys).

Like :mod:`bench.reference` and :mod:`bench.counts`, nothing here imports
the program.
"""

from __future__ import annotations

import functools
import importlib
from pathlib import Path

from ..harness.core import Refused

HERE = Path(__file__).resolve().parent


@functools.cache
def load(kind: str):
    """The module of layer kind ``kind``; refused where there is none."""
    if not kind.isidentifier() or not (HERE / f"{kind}.py").is_file():
        raise Refused(f"no layer kind {kind!r}: missing bench/layers/{kind}.py")
    return importlib.import_module(f"{__name__}.{kind}")
