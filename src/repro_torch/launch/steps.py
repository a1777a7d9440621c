"""Serving step functions (the reference's ``make_prefill_step`` / ``make_serve_step``)."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import Model

Params = dict[str, Any]


def make_prefill_step(model: Model):
    def prefill_step(params: Params, batch: Params, cache: Params):
        logits, cache = model.prefill(params, batch["tokens"], cache)
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
