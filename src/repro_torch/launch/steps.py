"""Step functions (train and grad by autograd, prefill, serve) and dry-run
input specs.

The port of ``repro.launch.steps``.  ``jax.value_and_grad(model.loss, has_aux=True)`` becomes autograd
over fresh leaves that require grad: the gradient tree has the params'
structure and each leaf its param's dtype (bf16 for bf16 params), and a
param that the loss does not reach gets zeros, as in JAX.  On DTensors
the greedy steps gather the logits' vocab dim before ``argmax``: DTensor's
``argmax`` over a sharded dim failed on the ``(2, 16, 16)`` mesh at one
sequence a rank.  While a profiler records, a prefill and a decode step
are the spans ``serve.prefill`` and ``serve.decode``
(:func:`repro_torch.obs.step_span`), argmax included.

A decode step on the card is replayed from one CUDA graph per KV cache
(:class:`ServeStep`): its host dispatch (~3100 launches for a MoE model)
otherwise takes several times its device time.

The dry-run's stand-ins for ``jax.ShapeDtypeStruct`` trees are tensors on
the ``meta`` device: shapes and dtypes, no storage.  :func:`abstract_params`
runs the model's own ``init`` with every factory sent to ``meta`` (a meta
tensor has no generator to draw from), so the tree, shapes and dtypes are
``init``'s exactly and nothing is allocated (qwen1.5-110b alone is 222 GB).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._bridge import tree_leaves, tree_unflatten
from repro_torch.configs.shapes import Shape
from repro_torch.kernels import ops as kops
from repro_torch.models import Model, ModelConfig
from repro_torch.models.hints import get_hints, unshard
from repro_torch.obs.events import span, step_span
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
        with step_span("serve.prefill"):
            logits, cache = model.prefill(
                params, batch["tokens"], cache,
                src_embeds=batch.get("src_embeds"), patch_embeds=batch.get("patch_embeds"),
            )
            next_tok = torch.argmax(unshard(logits[:, -1], [-1]), dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(model: Model) -> ServeStep:
    """One greedy decode step: token [B, 1] → (next token [B, 1] int32, cache)."""
    return ServeStep(model)


#: The cache entries a decode step reads without replacing them: ``len``
#: (a device scalar), ``layers`` of entries written in place, and an
#: encoder-decoder model's ``enc_out``.
_FIXED_CACHE = frozenset(("len", "layers", "enc_out"))


def why_eager(params: Params, cache: Params, token: torch.Tensor) -> str | None:
    """Why a decode step on these inputs runs eagerly, or None where it may
    be replayed from a CUDA graph.

    A graph reads every tensor at the address it had at capture, so the
    step must read its inputs from buffers that outlive it: grad off, no
    sharding hints, no DTensor (a graph cannot hold a collective's plan),
    CUDA tensors, a token ``[B, 1]``, and a cache whose every entry is
    written in place or fixed for the cache's life.  A recurrent mixer's
    ``state``, which each step replaces by a new tensor, is not.
    """
    if torch.is_grad_enabled():
        return "grad is on"
    if get_hints() is not None:
        return "sharding hints are set"
    layers = cache["layers"]
    if set(cache) - _FIXED_CACHE or any(_in_place(e) is None for e in layers):
        return "the cache holds an entry that the step replaces (a recurrent state)"
    tensors = [token, cache["len"], *(t for e in layers for t in e.values())]
    if "enc_out" in cache:
        tensors.append(cache["enc_out"])
    if any(isinstance(t, DTensor) for t in tensors):
        return "a DTensor in the cache or the token"
    if not all(t.is_cuda for t in tensors):
        return "the token or the cache is not on a CUDA device"
    if token.dim() != 2 or token.shape[1] != 1:
        return f"the token is {tuple(token.shape)}, not [B, 1]"
    if any(isinstance(p, DTensor) for p in tree_leaves(params)):
        return "a DTensor among the params"
    return None


def _in_place(e: Params) -> tuple[str, str] | None:
    """The names of a layer entry's two tensors where the step writes it in
    place (attention's ``k``, ``v``; MLA's ``c_kv``, ``k_pe``), else None.
    Cheap: a replay checks every layer's entry on the host before it runs."""
    a, b = ("k", "v") if "k" in e else ("c_kv", "k_pe")
    return (a, b) if len(e) == 2 and a in e and b in e else None


def _layout(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.shape, t.stride()


def _addresses(cache: Params) -> tuple | None:
    """Where and how a graph reads the cache: the address, shape and strides
    of each tensor of each layer's entry (K and V, or MLA's ``c_kv`` and
    ``k_pe``), then of ``enc_out``; None for a cache with another kind of
    entry."""
    out = []
    for e in cache["layers"]:
        names = _in_place(e)
        if names is None:
            return None
        out += (_layout(e[names[0]]), _layout(e[names[1]]))
    if "enc_out" in cache:
        out.append(_layout(cache["enc_out"]))
    return tuple(out)


@dataclass
class _DecodeGraph:
    """One captured decode step and what it reads by address."""

    graph: torch.cuda.CUDAGraph
    params: Params  # held: the key is its identity, and the graph reads its leaves
    addresses: tuple  # the cache's buffers, not held: only a cache that lies there now replays
    context: tuple  # token shape, dtype, device; inference mode; attention impl
    tok_in: torch.Tensor  # static inputs, copied into before a replay
    len_in: torch.Tensor
    tok_out: torch.Tensor  # outputs in the graph's pool, copied out after a replay
    len_out: torch.Tensor
    launches: dict[str, int]  # kernel launches a replay makes (ops.launch_counts)


def _context(token: torch.Tensor) -> tuple:
    return (tuple(token.shape), token.dtype, token.device, torch.is_inference_mode_enabled(), kops.get_attn_impl())


class ServeStep:
    """The greedy decode step, replayed on the card from a CUDA graph.

    Where :func:`why_eager` allows, the first call for a key (the params
    tree by identity; the cache's K/V and ``enc_out`` by address, shape and
    strides; the token's shape, dtype and device; inference mode; the
    attention impl) drops the graph it holds, runs the step eagerly on the
    object's side stream (that run is the call's result, and it makes the
    stream's cuBLAS workspace and the decode kernel's counters before any
    capture), then captures the same body on that stream with a static
    token and ``len`` as inputs.  Each later call with the key copies its
    token and ``len`` in (one ``_foreach_copy_``; the cache's buffers are
    read where they lie), replays, and copies the next token and ``len``
    out into new tensors (another), so no result is overwritten by a later
    call: the step's device operations are the eager step's and these two.
    A replay adds to the kernels' launch counts what the capture counted,
    and opens the span ``serve.decode.replay`` inside ``serve.decode``.
    ``captures`` and ``replays`` count both kinds of call.

    The graph holds the params until a call with another key, or until
    this object is dropped.  It does not hold the cache: a graph writes and
    reads the cache's memory by address, so it is replayed only for a cache
    whose buffers lie there now, with the same shapes and strides, which
    is then that cache, and a cache the caller drops is freed at once.
    One object serves one thread at a time: a replay writes its static inputs.
    """

    def __init__(self, model: Model):
        self.model = model
        self.captures = 0
        self.replays = 0
        self._graph: _DecodeGraph | None = None
        self._side: torch.cuda.Stream | None = None  # every capture's stream, so its per-stream state is made once

    def __call__(self, params: Params, cache: Params, token: torch.Tensor):
        with step_span("serve.decode"):
            g = self._graph
            if g is not None and self._matches(g, params, cache, token):
                return self._replay(g, cache, token)
            if why_eager(params, cache, token) is None:
                return self._capture(params, cache, token)
            return self._eager(params, cache, token)

    def _eager(self, params: Params, cache: Params, token: torch.Tensor):
        logits, cache = self.model.decode_step(params, token, cache)
        next_tok = torch.argmax(unshard(logits[:, -1], [-1]), dim=-1, keepdim=True).to(torch.int32)
        return next_tok, cache

    @staticmethod
    def _matches(g: _DecodeGraph, params: Params, cache: Params, token: torch.Tensor) -> bool:
        return (
            params is g.params
            and not torch.is_grad_enabled()
            and get_hints() is None
            and _context(token) == g.context
            and _addresses(cache) == g.addresses
        )

    def _replay(self, g: _DecodeGraph, cache: Params, token: torch.Tensor):
        with span("serve.decode.replay"):
            torch._foreach_copy_([g.tok_in, g.len_in], [token, cache["len"]])
            g.graph.replay()
            tok, ln = torch.empty_like(g.tok_out), torch.empty_like(g.len_out)
            torch._foreach_copy_([tok, ln], [g.tok_out, g.len_out])
        kops.add_launch_counts(g.launches)
        self.replays += 1
        return tok, {**cache, "len": ln}

    def _capture(self, params: Params, cache: Params, token: torch.Tensor):
        self._graph = None  # the older graph, its pool and its hold on the params go first
        cur = torch.cuda.current_stream(token.device)
        if self._side is None:
            self._side = torch.cuda.Stream(token.device)
        side = self._side
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._eager(params, cache, token)
        tok_in, len_in = torch.empty_like(token), torch.empty_like(cache["len"])
        before = kops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                tok_out, cache_out = self._eager(params, {**cache, "len": len_in}, tok_in)
            finally:
                graph.capture_end()  # the stream leaves capture, after an error too
        # The capture launched nothing; each replay launches what it counted.
        launches = {k: n - before.get(k, 0) for k, n in kops.launch_counts().items() if n != before.get(k, 0)}
        kops.add_launch_counts({k: -n for k, n in launches.items()})
        cur.wait_stream(side)
        out[0].record_stream(cur)
        out[1]["len"].record_stream(cur)
        self._graph = _DecodeGraph(graph, params, _addresses(cache), _context(token), tok_in, len_in,
                                   tok_out, cache_out["len"], launches)
        self.captures += 1
        return out


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
