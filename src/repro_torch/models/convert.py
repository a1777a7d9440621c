"""Carry parameters between the JAX package's layout and the port's.

``params_from_jax`` takes the reference's parameter tree with every leaf
already on the host as numpy (bf16 leaves as ``uint16`` views of their bits,
see :mod:`repro_torch._bridge`), so this module needs neither ``jax`` nor
``ml_dtypes``.  The reference keeps the layers of each pattern position
stacked along a leading ``repeats`` axis (``decoder.body[j]``); the port keeps
one dict per layer in ``cfg.layer_seq()`` order, so the stacks are unstacked:
``decoder`` into ``layers``, and an encoder-decoder model's ``encoder`` (one
pattern position, ``n_enc_layers`` repeats) into ``enc_layers``.  The other
leaves (``enc_norm``, ``vision_proj``, and each block's ``post_norm{1,2}``,
``norm_cross`` and ``cross``) keep their names.
Weights keep the reference's ``[d_in, d_out]`` layout (``linear`` computes
``x @ w``): nothing is transposed.  A bf16 leaf becomes ``torch.bfloat16``
bit for bit, with no detour through fp32.  ``params_from_jax`` also takes
tensors as leaves.

:func:`params_to_jax` is its inverse: it stacks the port's layers back into
``decoder.prefix`` / ``decoder.body[j]`` (and ``encoder.body[0]``), so that a tree the port saves (the
params, or AdamW's moments, which share their structure) carries the
reference's leaf names (``decoder/body/0/mixer/q/w``), and
``params_from_jax(params_to_jax(p, cfg), cfg, dev)`` equals ``p`` bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._bridge import resolve_device, to_torch, tree_map

from .config import ModelConfig
from .model import check_ported, encoder_config

Params = dict[str, Any]


def params_from_jax(np_tree: Params, cfg: ModelConfig, device) -> Params:
    check_ported(cfg)
    dev = resolve_device(device)

    def put(tree, r=None):
        return tree_map(lambda a: to_torch(a if r is None else a[r], dev), tree)

    def unstack(stack, c: ModelConfig) -> list:
        layers = [put(blk) for blk in stack["prefix"]]
        for r in range(c.repeats):
            for j in range(len(c.pattern)):
                layers.append(put(stack["body"][j], r))
        return layers

    params: Params = {
        "embed": put(np_tree["embed"]),
        "final_norm": put(np_tree["final_norm"]),
        "layers": unstack(np_tree["decoder"], cfg),
    }
    for name in ("lm_head", "enc_norm", "vision_proj"):
        if name in np_tree:
            params[name] = put(np_tree[name])
    if "encoder" in np_tree:
        params["enc_layers"] = unstack(np_tree["encoder"], encoder_config(cfg))
    return params


def params_to_jax(params: Params, cfg: ModelConfig) -> Params:
    """The port's tree in the reference's layout, as tensors on their own
    device: layers ``len(prefix_pattern) + r * len(pattern) + j`` stack into
    ``decoder.body[j]`` along a leading ``repeats`` axis, and the encoder's
    into ``encoder.body[0]``."""
    check_ported(cfg)
    out: Params = {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "decoder": _stack(params["layers"], cfg),
    }
    for name in ("lm_head", "enc_norm", "vision_proj"):
        if name in params:
            out[name] = params[name]
    if "enc_layers" in params:
        out["encoder"] = _stack(params["enc_layers"], encoder_config(cfg))
    return out


def _stack(layers: list, cfg: ModelConfig) -> Params:
    n_pre, n_pat = len(cfg.prefix_pattern), len(cfg.pattern)
    if len(layers) != n_pre + cfg.repeats * n_pat:
        raise ValueError(f"{len(layers)} layers do not fit {cfg.name}'s pattern")
    body = [_stack_trees(layers[n_pre + j :: n_pat]) for j in range(n_pat)]
    return {"prefix": list(layers[:n_pre]), "body": body}


def _stack_trees(trees: list) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
