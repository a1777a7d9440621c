"""Model assembly for the dense families: blocks → layer stack → LM forward.

The port of ``repro.models.model`` for dense decoders.  The reference stacks
the parameters of each pattern position over ``repeats`` and walks the stack
with ``lax.scan``; the port keeps one parameter dict per layer, in
``cfg.layer_seq()`` order, and walks them in a Python loop.  The same block
code serves the cache-free forward, prefill (cache write) and decode (cache
append).  The cache is written in place (see ``layers.attention_block``).

What is not dense raises ``NotImplementedError`` naming its ROADMAP item:
MoE, the recurrent mixers, encoder-decoder, the vision frontend,
``attn_local``, the logit softcaps and ``post_block_norm``.  ``remat`` has no
meaning when serving and is ignored.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

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

Params = dict[str, Any]

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def _check_dense(cfg: ModelConfig) -> None:
    def todo(what: str, item: str):
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to repro_torch yet (ROADMAP queue A, {item})"
        )

    for mixer, ffn in cfg.layer_seq():
        if mixer in ("mamba", "mlstm", "slstm"):
            todo(f"the {mixer} mixer", "A5 recurrent mixers")
        if mixer == "attn_local":
            todo("sliding-window attention (attn_local)", "A6 other families")
        if mixer != "attn":
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")
        if ffn == "moe":
            todo("the MoE FFN", "A4 MoE")
        if ffn not in ("mlp", "dense0", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {ffn!r}")
    if cfg.is_encoder_decoder:
        todo("encoder-decoder", "A6 other families")
    if cfg.frontend != "none":
        todo(f"the {cfg.frontend} frontend", "A6 other families")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        todo("logit softcapping", "A6 other families")
    if cfg.post_block_norm:
        todo("post_block_norm", "A6 other families")


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: tuple[str, str], dtype) -> Params:
    _, ffn = kind
    p: Params = {
        "norm1": init_norm(cfg, dtype, gen.device),
        "mixer": init_attention(gen, cfg, dtype),
    }
    if ffn != "none":
        p["norm2"] = init_norm(cfg, dtype, gen.device)
        p["ffn"] = init_mlp(gen, cfg, cfg.d_ff, dtype)
    return p


def apply_block(
    cfg: ModelConfig,
    kind: tuple[str, str],
    p: Params,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool,
    cache: Params | None,  # {"k", "v", "len"} for this layer, or None
) -> tuple[torch.Tensor, Params | None]:
    _, ffn = kind
    h = apply_norm(cfg, p["norm1"], x)
    out, new_cache = attention_block(
        cfg, p["mixer"], h, positions=positions, causal=causal, cache=cache,
        use_rope=cfg.use_rope,
    )
    x = x + out
    if ffn != "none":
        h = apply_norm(cfg, p["norm2"], x)
        x = x + apply_mlp(cfg, p["ffn"], h)
    return x, new_cache


@dataclass(frozen=True)
class Model:
    """``Model(cfg, device)``; params are plain dicts of tensors on ``device``."""

    cfg: ModelConfig
    device: Any = "cuda"

    def __post_init__(self):
        _check_dense(self.cfg)
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
        if padded_vocab(cfg) != cfg.vocab:  # mask padded rows
            logits[..., cfg.vocab :] = -1e30
        return logits

    def _stack(
        self, params: Params, x: torch.Tensor, *, positions: torch.Tensor, cache: Params | None
    ) -> tuple[torch.Tensor, list[Params] | None]:
        cfg = self.cfg
        new_layers = [] if cache is not None else None
        for i, (kind, p) in enumerate(zip(cfg.layer_seq(), params["layers"])):
            c = None
            if cache is not None:
                c = {**cache["layers"][i], "len": cache["len"]}
            x, nc = apply_block(cfg, kind, p, x, positions=positions, causal=True, cache=c)
            if new_layers is not None:
                new_layers.append({"k": nc["k"], "v": nc["v"]})
        return x, new_layers

    # -- forward -----------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Cache-free causal forward: tokens [B, L] → logits [B, L, Vp]."""
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x, _ = self._stack(params, self._embed(params, tokens), positions=pos, cache=None)
        return self._logits(params, x)

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        """``{"len": int32 scalar, "layers": [{"k", "v"} per layer]}`` on the device."""
        dtype = _dtype(self.cfg)
        layers = []
        for _ in self.cfg.layer_seq():
            kv = init_kv_cache(self.cfg, batch, max_len, dtype, self.device)
            layers.append({"k": kv["k"], "v": kv["v"]})
        return {"len": torch.zeros((), dtype=torch.int32, device=self.device), "layers": layers}

    def prefill(
        self, params: Params, tokens: torch.Tensor, cache: Params
    ) -> tuple[torch.Tensor, Params]:
        """Consume the prompt [B, L0]; returns (last-position logits [B, 1, Vp], cache)."""
        ln = cache["len"]
        pos = ln + torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x, layers = self._stack(params, self._embed(params, tokens), positions=pos, cache=cache)
        logits = self._logits(params, x[:, -1:])
        return logits, {**cache, "layers": layers, "len": ln + tokens.shape[1]}

    def decode_step(
        self, params: Params, token: torch.Tensor, cache: Params
    ) -> tuple[torch.Tensor, Params]:
        """One decode step: token [B, 1] → (logits [B, 1, Vp], cache)."""
        return self.prefill(params, token, cache)
