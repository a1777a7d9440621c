"""Model assembly for the dense, MoE and recurrent families: blocks → layer stack → LM forward.

The port of ``repro.models.model`` for decoders whose blocks are a mixer
(attention, or the recurrent ``mamba``, ``mlstm`` and ``slstm`` of
:mod:`repro_torch.models.recurrent`) followed by a dense MLP (``mlp``,
``dense0``), a Mixture-of-Experts FFN (``moe``,
:mod:`repro_torch.models.moe`) or nothing.  The reference stacks
the parameters of each pattern position over ``repeats`` and walks the stack
with ``lax.scan``; the port keeps one parameter dict per layer, in
``cfg.layer_seq()`` order, and walks them in a Python loop.  The same block
code serves the cache-free forward, prefill (cache write) and decode (cache
append).  The cache holds one entry a layer, by its mixer, as the
reference's ``init_block_cache``: ``{"k", "v"}`` for attention, written in
place (see ``layers.attention_block``), and ``{"state": <NamedTuple>}`` for
a recurrent mixer, replaced by the state each call returns.

``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant) when grad is on and there is no
cache.  The reference's ``jax.checkpoint`` policy,
``dots_with_no_batch_dims_saveable``, keeps the matmul outputs; whole-block
recompute gives the same numbers with more recompute.

Each block returns its MoE aux loss beside ``x`` (none for a dense FFN),
and the stack sums them in layer order, under remat too, as the reference's
``_apply_stack``; ``Model.loss`` adds ``router_aux_weight ×`` the sum.

What is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item: encoder-decoder, the vision frontend, ``attn_local``, the logit
softcaps and ``post_block_norm``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._bridge import resolve_device

from .config import ModelConfig
from .layers import (
    apply_mlp,
    apply_norm,
    attention_block,
    init_attention,
    init_kv_cache,
    init_linear,
    init_mlp,
    init_norm,
    linear,
)
from .moe import apply_moe, init_moe
from .recurrent import (
    init_mamba,
    init_mamba_state,
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
    mamba_mix,
    mlstm_mix,
    slstm_mix,
)

Params = dict[str, Any]

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of what ``cfg``
    needs that the port does not have yet."""
    def todo(what: str, item: str):
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to repro_torch yet (ROADMAP queue A, {item})"
        )

    for mixer, ffn in cfg.layer_seq():
        if mixer == "attn_local":
            todo("sliding-window attention (attn_local)", "A6 other families")
        if mixer not in ("attn", "mamba", "mlstm", "slstm"):
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")
        if ffn not in ("mlp", "dense0", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {ffn!r}")
    if cfg.is_encoder_decoder:
        todo("encoder-decoder", "A6 other families")
    if cfg.frontend != "none":
        todo(f"the {cfg.frontend} frontend", "A6 other families")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        todo("logit softcapping", "A6 other families")
    if cfg.post_block_norm:
        todo("post_block_norm", "A6 other families")


_MIXER_INIT = {"attn": init_attention, "mamba": init_mamba, "mlstm": init_mlstm, "slstm": init_slstm}
_MIXER_APPLY = {"mamba": mamba_mix, "mlstm": mlstm_mix, "slstm": slstm_mix}


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: tuple[str, str], dtype) -> Params:
    mixer, ffn = kind
    p: Params = {
        "norm1": init_norm(cfg, dtype, gen.device),
        "mixer": _MIXER_INIT[mixer](gen, cfg, dtype),
    }
    if ffn != "none":
        p["norm2"] = init_norm(cfg, dtype, gen.device)
        if ffn == "moe":
            p["ffn"] = init_moe(gen, cfg, dtype)
        else:  # "mlp", "dense0"
            p["ffn"] = init_mlp(gen, cfg, cfg.d_ff, dtype)
    return p


def init_block_cache(
    cfg: ModelConfig, kind: tuple[str, str], batch: int, max_len: int, dtype, device
) -> Params:
    """Cache entry for one layer (no "len": it is shared model-wide)."""
    mixer, _ = kind
    if mixer == "attn":
        kv = init_kv_cache(cfg, batch, max_len, dtype, device)
        return {"k": kv["k"], "v": kv["v"]}
    if mixer == "mamba":
        return {"state": init_mamba_state(cfg, batch, dtype, device)}
    if mixer == "mlstm":
        return {"state": init_mlstm_state(cfg, batch, device)}
    if mixer == "slstm":
        return {"state": init_slstm_state(cfg, batch, device)}
    raise ValueError(mixer)


def apply_block(
    cfg: ModelConfig,
    kind: tuple[str, str],
    p: Params,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool,
    cache: Params | None,  # this layer's entry, or None
    cache_len: torch.Tensor | None = None,  # the shared length, None without a cache
) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """Returns ``(x', new cache entry, aux loss)``; aux is None without a MoE FFN."""
    mixer, ffn = kind
    aux = None
    h = apply_norm(cfg, p["norm1"], x)
    new_cache = None
    if mixer == "attn":
        kv_cache = None if cache is None else {"k": cache["k"], "v": cache["v"], "len": cache_len}
        out, upd = attention_block(
            cfg, p["mixer"], h, positions=positions, causal=causal, cache=kv_cache,
            use_rope=cfg.use_rope,
        )
        if upd is not None:
            new_cache = {"k": upd["k"], "v": upd["v"]}
    else:
        out, st = _MIXER_APPLY[mixer](cfg, p["mixer"], h, cache["state"] if cache else None)
        new_cache = {"state": st}
    x = x + out
    if ffn != "none":
        h = apply_norm(cfg, p["norm2"], x)
        if ffn == "moe":
            out, aux = apply_moe(cfg, p["ffn"], h)
        else:
            out = apply_mlp(cfg, p["ffn"], h)
        x = x + out
    return x, new_cache, aux


def _remat_block(cfg: ModelConfig, kind, positions, p: Params, x: torch.Tensor):
    """A cache-free block for ``checkpoint``: ``(x', aux)``."""
    x, _, aux = apply_block(cfg, kind, p, x, positions=positions, causal=True, cache=None)
    return x, aux


@dataclass(frozen=True)
class Model:
    """``Model(cfg, device)``; params are plain dicts of tensors on ``device``."""

    cfg: ModelConfig
    device: Any = "cuda"

    def __post_init__(self):
        check_ported(self.cfg)
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random params with the reference's shapes, scales and dtypes.

        ``gen`` must live on the model's device.  Norm weights start at zero
        (the norms scale by ``1 + w``).
        """
        cfg = self.cfg
        if torch.device(gen.device).type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        dtype = _dtype(cfg)
        vp = padded_vocab(cfg)
        embed = torch.randn((vp, cfg.d_model), generator=gen, device=self.device)
        params: Params = {"embed": (embed * (1.0 / math.sqrt(cfg.d_model))).to(dtype)}
        del embed  # the fp32 draw would otherwise stay alive through the layers' init
        params["final_norm"] = init_norm(cfg, dtype, self.device)
        if not cfg.tied_embeddings:
            params["lm_head"] = init_linear(gen, cfg.d_model, vp, dtype)
        params["layers"] = [init_block(gen, cfg, kind, dtype) for kind in cfg.layer_seq()]
        return params

    # -- embedding / head ------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        emb = params["embed"]
        x = emb.index_select(0, tokens.reshape(-1)).reshape(*tokens.shape, emb.shape[1])
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        if cfg.tied_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = linear(params["lm_head"], x)
        if padded_vocab(cfg) != cfg.vocab:  # mask padded rows (differentiable: a masked_fill)
            pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _stack(
        self, params: Params, x: torch.Tensor, *, positions: torch.Tensor, cache: Params | None
    ) -> tuple[torch.Tensor, list[Params] | None, torch.Tensor | None]:
        """``(x, new cache layers or None, aux)``: aux sums the blocks' MoE
        losses in layer order (an fp32 scalar; None when no block has a MoE FFN)."""
        cfg = self.cfg
        new_layers = [] if cache is not None else None
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        aux_total = None
        for i, (kind, p) in enumerate(zip(cfg.layer_seq(), params["layers"])):
            if remat:
                block = partial(_remat_block, cfg, kind, positions)
                x, aux = checkpoint(block, p, x, use_reentrant=False)
            else:
                c, ln = (None, None) if cache is None else (cache["layers"][i], cache["len"])
                x, nc, aux = apply_block(
                    cfg, kind, p, x, positions=positions, causal=True, cache=c, cache_len=ln
                )
                if new_layers is not None:
                    new_layers.append(nc)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, new_layers, aux_total

    # -- forward -----------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Cache-free causal forward: tokens [B, L] → logits [B, L, Vp]."""
        return self._forward(params, tokens)[0]

    def _forward(self, params: Params, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(logits, aux)``, as the reference's ``forward``."""
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x, _, aux = self._stack(params, self._embed(params, tokens), positions=pos, cache=None)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), aux

    # -- loss ----------------------------------------------------------------
    def loss(
        self, params: Params, batch: dict[str, torch.Tensor], *, seq_chunk: int = 1024
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Next-token CE (labels == -1 ignored) + the MoE aux loss, as the reference.

        The CE is taken over ``seq_chunk`` positions at a time, each chunk's
        ``log_softmax`` in fp32.  ``aux`` is the MoE blocks' summed
        load-balance loss (0 for the dense families).
        Returns ``(loss, {"ce", "aux", "tokens"})``, fp32 scalars.
        """
        cfg = self.cfg
        logits, aux = self._forward(params, batch["tokens"])
        labels = batch["labels"]
        dev = logits.device
        l = logits.shape[1]
        chunk = min(seq_chunk, l)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        count = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(0, l, chunk):
            logp = torch.log_softmax(logits[:, s : s + chunk].float(), dim=-1)
            lb = labels[:, s : s + chunk].long()
            tgt = torch.gather(logp, -1, lb.clamp_min(0)[..., None])[..., 0]
            mask = (lb >= 0).float()
            total = total - torch.sum(tgt * mask)
            count = count + torch.sum(mask)
        ce = total / torch.clamp_min(count, 1.0)
        loss = ce + cfg.moe.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "tokens": count}

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        """``{"len": int32 scalar, "layers": [entry per layer]}`` on the device;
        an entry is ``{"k", "v"}`` for attention, ``{"state"}`` for a recurrent mixer."""
        dtype = _dtype(self.cfg)
        layers = [
            init_block_cache(self.cfg, kind, batch, max_len, dtype, self.device)
            for kind in self.cfg.layer_seq()
        ]
        return {"len": torch.zeros((), dtype=torch.int32, device=self.device), "layers": layers}

    def prefill(
        self, params: Params, tokens: torch.Tensor, cache: Params
    ) -> tuple[torch.Tensor, Params]:
        """Consume the prompt [B, L0]; returns (last-position logits [B, 1, Vp], cache)."""
        ln = cache["len"]
        pos = ln + torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x, layers, _ = self._stack(params, self._embed(params, tokens), positions=pos, cache=cache)
        logits = self._logits(params, x[:, -1:])
        return logits, {**cache, "layers": layers, "len": ln + tokens.shape[1]}

    def decode_step(
        self, params: Params, token: torch.Tensor, cache: Params
    ) -> tuple[torch.Tensor, Params]:
        """One decode step: token [B, 1] → (logits [B, 1, Vp], cache)."""
        return self.prefill(params, token, cache)
