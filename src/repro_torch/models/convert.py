"""Carry parameters between the JAX package's layout and the port's.

``params_from_jax`` takes the reference's parameter tree with every leaf
already on the host as numpy (bf16 leaves as ``uint16`` views of their bits,
see :mod:`repro_torch._bridge`), so this module needs neither ``jax`` nor
``ml_dtypes``.  The reference keeps the layers of each pattern position
stacked along a leading ``repeats`` axis (``decoder.body[j]``); the port keeps
one dict per layer in ``cfg.layer_seq()`` order, so the stacks are unstacked.
Weights keep the reference's ``[d_in, d_out]`` layout (``linear`` computes
``x @ w``): nothing is transposed.  A bf16 leaf becomes ``torch.bfloat16``
bit for bit, with no detour through fp32.  ``params_from_jax`` also takes
tensors as leaves.

:func:`params_to_jax` is its inverse: it stacks the port's layers back into
``decoder.prefix`` / ``decoder.body[j]``, so that a tree the port saves (the
params, or AdamW's moments, which share their structure) carries the
reference's leaf names (``decoder/body/0/mixer/q/w``), and
``params_from_jax(params_to_jax(p, cfg), cfg, dev)`` equals ``p`` bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._bridge import resolve_device, to_torch, tree_map

from .config import ModelConfig
from .model import check_ported

Params = dict[str, Any]


def params_from_jax(np_tree: Params, cfg: ModelConfig, device) -> Params:
    check_ported(cfg)
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


def params_to_jax(params: Params, cfg: ModelConfig) -> Params:
    """The port's tree in the reference's layout, as tensors on their own
    device: layers ``len(prefix_pattern) + r * len(pattern) + j`` stack into
    ``decoder.body[j]`` along a leading ``repeats`` axis."""
    check_ported(cfg)
    layers = params["layers"]
    n_pre, n_pat = len(cfg.prefix_pattern), len(cfg.pattern)
    if len(layers) != n_pre + cfg.repeats * n_pat:
        raise ValueError(f"{len(layers)} layers do not fit {cfg.name}'s pattern")
    body = [_stack_trees(layers[n_pre + j :: n_pat]) for j in range(n_pat)]
    out: Params = {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "decoder": {"prefix": list(layers[:n_pre]), "body": body},
    }
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def _stack_trees(trees: list) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
