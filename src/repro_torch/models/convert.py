"""Carry the JAX package's parameters across into the port's layout.

``params_from_jax`` takes the reference's parameter tree with every leaf
already on the host as numpy (bf16 leaves as ``uint16`` views of their bits,
see :mod:`repro_torch._bridge`), so this module needs neither ``jax`` nor
``ml_dtypes``.  The reference keeps the layers of each pattern position
stacked along a leading ``repeats`` axis (``decoder.body[j]``); the port keeps
one dict per layer in ``cfg.layer_seq()`` order, so the stacks are unstacked.
Weights keep the reference's ``[d_in, d_out]`` layout (``linear`` computes
``x @ w``): nothing is transposed.  A bf16 leaf becomes ``torch.bfloat16``
bit for bit, with no detour through fp32.
"""

from __future__ import annotations

from typing import Any

from repro_torch._bridge import resolve_device, to_torch, tree_map

from .config import ModelConfig
from .model import _check_dense

Params = dict[str, Any]


def params_from_jax(np_tree: Params, cfg: ModelConfig, device) -> Params:
    _check_dense(cfg)
    dev = resolve_device(device)

    def put(tree, r=None):
        return tree_map(lambda a: to_torch(a if r is None else a[r], dev), tree)

    dec = np_tree["decoder"]
    layers = [put(blk) for blk in dec["prefix"]]
    for r in range(cfg.repeats):
        for j in range(len(cfg.pattern)):
            layers.append(put(dec["body"][j], r))
    params: Params = {
        "embed": put(np_tree["embed"]),
        "final_norm": put(np_tree["final_norm"]),
        "layers": layers,
    }
    if "lm_head" in np_tree:
        params["lm_head"] = put(np_tree["lm_head"])
    return params
