"""Step functions: train and grad (autograd), prefill and serve.

The port of ``repro.launch.steps`` without its dry-run specs (ROADMAP queue
A, A8).  ``jax.value_and_grad(model.loss, has_aux=True)`` becomes autograd
over fresh leaves that require grad: the gradient tree has the params'
structure and each leaf its param's dtype (bf16 for bf16 params), and a
param that the loss does not reach gets zeros, as in JAX.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._bridge import tree_leaves, tree_unflatten
from repro_torch.models import Model
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
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(model: Model):
    """One greedy decode step: token [B, 1] → (next token [B, 1] int32, cache)."""

    def serve_step(params: Params, cache: Params, token: torch.Tensor):
        logits, cache = model.decode_step(params, token, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
        return next_tok, cache

    return serve_step
