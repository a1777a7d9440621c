"""Step functions (train and grad by autograd, prefill, serve) and dry-run
input specs.

The port of ``repro.launch.steps``.  ``jax.value_and_grad(model.loss, has_aux=True)`` becomes autograd
over fresh leaves that require grad: the gradient tree has the params'
structure and each leaf its param's dtype (bf16 for bf16 params), and a
param that the loss does not reach gets zeros, as in JAX.  On DTensors
the greedy steps gather the logits' vocab dim before ``argmax``: DTensor's
``argmax`` over a sharded dim failed on the ``(2, 16, 16)`` mesh at one
sequence a rank.

The dry-run's stand-ins for ``jax.ShapeDtypeStruct`` trees are tensors on
the ``meta`` device: shapes and dtypes, no storage.  :func:`abstract_params`
runs the model's own ``init`` with every factory sent to ``meta`` (a meta
tensor has no generator to draw from), so the tree, shapes and dtypes are
``init``'s exactly and nothing is allocated (qwen1.5-110b alone is 222 GB).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._bridge import tree_leaves, tree_unflatten
from repro_torch.configs.shapes import Shape
from repro_torch.models import Model, ModelConfig
from repro_torch.models.hints import unshard
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.optim import adamw

Params = dict[str, Any]


def value_and_grad(model: Model, params: Params, batch: Params):
    """``((loss, metrics), grads)`` of ``model.loss`` at ``params``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    def train_step(params: Params, opt_state: AdamWState, batch: Params):
        (loss, metrics), grads = value_and_grad(model, params, batch)
        new_params, new_opt, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_grad_step(model: Model):
    """Forward+backward only — the SWIRL ``fwdbwd`` workflow step."""

    def grad_step(params: Params, batch: Params):
        (loss, metrics), grads = value_and_grad(model, params, batch)
        return grads, {"loss": loss, **metrics}

    return grad_step


def make_prefill_step(model: Model):
    def prefill_step(params: Params, batch: Params, cache: Params):
        logits, cache = model.prefill(
            params, batch["tokens"], cache,
            src_embeds=batch.get("src_embeds"), patch_embeds=batch.get("patch_embeds"),
        )
        next_tok = torch.argmax(unshard(logits[:, -1], [-1]), dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(model: Model):
    """One greedy decode step: token [B, 1] → (next token [B, 1] int32, cache)."""

    def serve_step(params: Params, cache: Params, token: torch.Tensor):
        logits, cache = model.decode_step(params, token, cache)
        next_tok = torch.argmax(unshard(logits[:, -1], [-1]), dim=-1, keepdim=True).to(torch.int32)
        return next_tok, cache

    return serve_step


# ---------------------------------------------------------------------------
# Dry-run input stand-ins (meta tensors — no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> dict[str, torch.Tensor]:
    """Batch stand-ins for one (arch, shape) cell, as the reference's.

    For the vision frontend the patch stub occupies ``frontend_len`` of the
    sequence budget (total context = assigned seq_len).  Enc-dec models get
    ``frontend_len`` encoder frames on top of the decoder's seq_len tokens.
    """
    b = shape.global_batch
    l = shape.seq_len
    tok_dtype = torch.int32
    d = cfg.d_model
    emb_dtype = getattr(torch, cfg.dtype)
    specs: dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        tok_l = l - cfg.frontend_len if cfg.frontend == "vision" else l
        specs["tokens"] = _meta((b, tok_l), tok_dtype)
        specs["labels"] = _meta((b, tok_l), tok_dtype)
    elif shape.kind == "prefill":
        tok_l = l - cfg.frontend_len if cfg.frontend == "vision" else l
        specs["tokens"] = _meta((b, tok_l), tok_dtype)
    else:  # decode: one token; the cache holds seq_len rows
        specs["tokens"] = _meta((b, 1), tok_dtype)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        specs["src_embeds"] = _meta((b, cfg.frontend_len, d), emb_dtype)
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["patch_embeds"] = _meta((b, cfg.frontend_len, d), emb_dtype)
    return specs


class _FactoriesOnMeta(TorchDispatchMode):
    """Every op that takes a ``device`` makes its tensor on ``meta`` instead,
    and draws nothing from its generator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
            if "generator" in kwargs:
                kwargs["generator"] = None
        return func(*args, **kwargs)


def abstract_params(model: Model) -> Params:
    """``model.init``'s tree of params as meta tensors (the model's device
    is not touched; a CPU generator is passed and never drawn from)."""
    with _FactoriesOnMeta():
        return Model(model.cfg, "cpu").init(torch.Generator())


def abstract_opt_state(params_shape: Params) -> AdamWState:
    return adamw.init(params_shape)


def abstract_cache(model: Model, batch: int, max_len: int) -> Params:
    return Model(model.cfg, "meta").init_cache(batch, max_len)
