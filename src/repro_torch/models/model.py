"""Model assembly for every family: blocks → layer stacks → LM / enc-dec forward.

The port of ``repro.models.model``.  A block is a mixer (attention, global
``attn`` or sliding-window ``attn_local``, the recurrent ``mamba``,
``mlstm`` and ``slstm`` of :mod:`repro_torch.models.recurrent`, or the
port's own latent attention ``mla`` of :mod:`repro_torch.models.mla`), an
optional cross-attention over the encoder's output (encoder-decoder
models), and a dense MLP (``mlp``, ``dense0``), a Mixture-of-Experts FFN
(``moe``, :mod:`repro_torch.models.moe`) or nothing; with
``post_block_norm`` the mixer's and the FFN's outputs are normed again
before the residual (Gemma-2).  The reference stacks the parameters of each
pattern position over ``repeats`` and walks the stack with ``lax.scan``;
the port keeps one parameter dict per layer, in ``cfg.layer_seq()`` order,
and walks them in a Python loop.  The same block code serves the cache-free
forward, prefill (cache write) and decode (cache append).

Param layout (a dict of tensors on the model's device)::

    embed         [Vp, d]                  (the LM head too when tied)
    final_norm    {"w"} or {"w", "b"}
    lm_head       {"w": [d, Vp]}           untied only
    layers        [block, ...]             the decoder, cfg.layer_seq() order
    enc_layers    [block, ...]             encoder-decoder only: n_enc_layers
    enc_norm      {"w"} or {"w", "b"}      ("attn", "mlp") blocks
    vision_proj   {"w": [d, d]}            vision frontend only

A block is ``{"norm1", "mixer", "post_norm1"?, "norm_cross"?, "cross"?,
"norm2"?, "ffn"?, "post_norm2"?}``, with the reference's names.

The cache is ``{"len", "layers"}`` plus ``"enc_out"`` for an
encoder-decoder model: one entry a layer, by its mixer, as the reference's
``init_block_cache``: ``{"k", "v"}`` for attention (global or local),
written in place (see ``layers.attention_block``), ``{"c_kv", "k_pe"}``
for MLA, also written in place, and ``{"state":
<NamedTuple>}`` for a recurrent mixer, replaced by the state each call
returns.  Prefill encodes ``src_embeds`` into ``enc_out``, and every
decoder call recomputes each layer's cross K/V from it, as the reference
does.  A vision model prepends ``vision_proj(patch_embeds)`` to the tokens,
so its positions and its cache count the patches.

``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant) when grad is on and there is no
cache.  The reference's ``jax.checkpoint`` policy,
``dots_with_no_batch_dims_saveable``, keeps the matmul outputs; whole-block
recompute gives the same numbers with more recompute.

Each block returns its MoE aux loss beside ``x`` (none for a dense FFN),
and the stack sums them in layer order, under remat too, as the reference's
``_apply_stack``; ``Model.loss`` adds ``router_aux_weight ×`` the sum.

With params placed on a mesh (``launch.sharding.distribute_params``) the
same code runs on DTensors (see :mod:`repro_torch.models.hints`).  Under
``set_hints`` a MoE FFN takes the reference's expert-local dispatch (H2,
``moe.apply_moe_sharded``) when the experts and tokens divide the mesh, and
a cache-free stack keeps its residual stream sequence-sharded over TP (H4):
``x`` is constrained at the stack's entry and after every block.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._bridge import resolve_device

from .config import ModelConfig
from .hints import DTensor, constrain, get_hints, matmul, replicated_like, shard_map
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
    split_heads,
)
from .mla import init_mla, init_mla_cache, mla_block
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
    """Raise ``ValueError`` on a mixer or an FFN that no family has."""
    for mixer, ffn in cfg.layer_seq():
        if mixer not in _MIXER_INIT:
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")
        if ffn not in ("mlp", "dense0", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {ffn!r}")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``n_enc_layers`` ("attn", "mlp") blocks,
    as the reference builds it."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, prefix_pattern=(), pattern=(("attn", "mlp"),))


_MIXER_INIT = {"attn": init_attention, "attn_local": init_attention, "mamba": init_mamba,
               "mlstm": init_mlstm, "slstm": init_slstm, "mla": init_mla}
_MIXER_APPLY = {"mamba": mamba_mix, "mlstm": mlstm_mix, "slstm": slstm_mix}


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: tuple[str, str], dtype, *,
               cross: bool = False) -> Params:
    mixer, ffn = kind
    p: Params = {
        "norm1": init_norm(cfg, dtype, gen.device),
        "mixer": _MIXER_INIT[mixer](gen, cfg, dtype),
    }
    if cfg.post_block_norm:
        p["post_norm1"] = init_norm(cfg, dtype, gen.device)
    if cross:
        p["norm_cross"] = init_norm(cfg, dtype, gen.device)
        p["cross"] = init_attention(gen, cfg, dtype)
    if ffn != "none":
        p["norm2"] = init_norm(cfg, dtype, gen.device)
        if ffn == "moe":
            p["ffn"] = init_moe(gen, cfg, dtype)
        else:  # "mlp", "dense0"
            p["ffn"] = init_mlp(gen, cfg, cfg.d_ff, dtype)
        if cfg.post_block_norm:
            p["post_norm2"] = init_norm(cfg, dtype, gen.device)
    return p


def init_block_cache(
    cfg: ModelConfig, kind: tuple[str, str], batch: int, max_len: int, dtype, device
) -> Params:
    """Cache entry for one layer (no "len": it is shared model-wide)."""
    mixer, _ = kind
    if mixer in ("attn", "attn_local"):
        kv = init_kv_cache(cfg, batch, max_len, dtype, device)
        return {"k": kv["k"], "v": kv["v"]}
    if mixer == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, device)
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
    enc_out: torch.Tensor | None = None,  # [B, S, d], for a block with cross-attention
) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """Returns ``(x', new cache entry, aux loss)``; aux is None without a MoE FFN."""
    mixer, ffn = kind
    aux = None
    h = apply_norm(cfg, p["norm1"], x)
    new_cache = None
    if mixer in ("attn", "attn_local"):
        window = cfg.sliding_window if mixer == "attn_local" else 0
        kv_cache = None if cache is None else {"k": cache["k"], "v": cache["v"], "len": cache_len}
        out, upd = attention_block(
            cfg, p["mixer"], h, positions=positions, causal=causal, window=window,
            cache=kv_cache, use_rope=cfg.use_rope,
        )
        if upd is not None:
            new_cache = {"k": upd["k"], "v": upd["v"]}
    elif mixer == "mla":
        mla_cache = None if cache is None else {**cache, "len": cache_len}
        out, upd = mla_block(cfg, p["mixer"], h, positions=positions, cache=mla_cache)
        if upd is not None:
            new_cache = {"c_kv": upd["c_kv"], "k_pe": upd["k_pe"]}
    else:
        out, st = _MIXER_APPLY[mixer](cfg, p["mixer"], h, cache["state"] if cache else None)
        new_cache = {"state": st}
    if cfg.post_block_norm:
        out = apply_norm(cfg, p["post_norm1"], out)
    x = x + out
    if "cross" in p:
        h = apply_norm(cfg, p["norm_cross"], x)
        b, s, _ = enc_out.shape
        ck = split_heads(linear(p["cross"]["k"], enc_out), cfg.n_kv_heads, cfg.head_dim)
        cv = split_heads(linear(p["cross"]["v"], enc_out), cfg.n_kv_heads, cfg.head_dim)
        out, _ = attention_block(
            cfg, p["cross"], h, positions=positions, causal=False, cross_kv=(ck, cv), use_rope=False,
        )
        x = x + out
    if ffn != "none":
        h = apply_norm(cfg, p["norm2"], x)
        if ffn == "moe":
            from .moe import apply_moe_sharded

            hints = get_hints()
            if (
                hints is not None
                and hints.local_moe_dispatch
                and cfg.moe.n_experts % hints.tp_size == 0
                and (x.shape[0] * x.shape[1]) % hints.dp_size == 0
                and x.shape[0] % hints.dp_size == 0
            ):
                out, aux = apply_moe_sharded(cfg, p["ffn"], h)
            else:
                out, aux = apply_moe(cfg, p["ffn"], h)
        else:
            out = apply_mlp(cfg, p["ffn"], h)
        if cfg.post_block_norm:
            out = apply_norm(cfg, p["post_norm2"], out)
        x = x + out
    return x, new_cache, aux


def _remat_block(cfg: ModelConfig, kind, positions, causal, p: Params, x: torch.Tensor, enc_out):
    """A cache-free block for ``checkpoint``: ``(x', aux)``."""
    x, _, aux = apply_block(cfg, kind, p, x, positions=positions, causal=causal, cache=None, enc_out=enc_out)
    return x, aux


def _apply_stack(
    cfg: ModelConfig,
    layers: list[Params],
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool,
    cache: Params | None,
    enc_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list[Params] | None, torch.Tensor | None]:
    """``(x, new cache layers or None, aux)`` of the blocks ``layers`` (in
    ``cfg.layer_seq()`` order); aux sums the blocks' MoE losses in layer
    order (an fp32 scalar; None when no block has a MoE FFN)."""
    # H4 (hints): Megatron-SP residual stream — between blocks the
    # [B, L, d] activations live sequence-sharded over the TP axis.
    h = get_hints()
    sp_resid = (
        h is not None
        and h.seq_parallel_residual
        and cache is None  # decode keeps L=1
        and x.shape[1] % h.tp_size == 0
        and x.shape[0] % h.dp_size == 0
    )

    def sp(z):
        return constrain(z, h.dp_spec(), h.tp_axis, None) if sp_resid else z

    x = sp(x)
    new_layers = [] if cache is not None else None
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux_total = None
    for i, (kind, p) in enumerate(zip(cfg.layer_seq(), layers, strict=True)):
        if remat:
            block = partial(_remat_block, cfg, kind, positions, causal)
            x, aux = checkpoint(block, p, x, enc_out, use_reentrant=False)
        else:
            c, ln = (None, None) if cache is None else (cache["layers"][i], cache["len"])
            x, nc, aux = apply_block(
                cfg, kind, p, x, positions=positions, causal=causal, cache=c, cache_len=ln,
                enc_out=enc_out,
            )
            if new_layers is not None:
                new_layers.append(nc)
        x = sp(x)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, new_layers, aux_total


def _embed_on_shards(emb: DTensor, tokens: DTensor) -> DTensor:
    """The embedding lookup on DTensors, vocab-parallel as Megatron's: each
    rank looks its tokens up in its own rows of the table (zeros for a token
    outside them), and the output is a partial sum over the mesh dims that
    shard the vocab.  On torch 2.11, DTensor's rule for the lookup's
    backward (``index_add``) paired the whole index with batch-sharded rows
    when the table and the tokens are sharded over different mesh dims."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = emb.device_mesh
    e_pl = tuple(p if p.is_shard(0) else Replicate() for p in emb.placements)
    t_pl = tuple(p if p.is_shard(0) and not e.is_shard(0) else Replicate() for e, p in zip(e_pl, tokens.placements))
    out_pl = tuple(Partial() if e.is_shard(0) else t for e, t in zip(e_pl, t_pl))
    _, (off, _) = compute_local_shape_and_global_offset(emb.shape, mesh, e_pl)

    def lookup(e, t):
        local = t.long() - off
        ok = (local >= 0) & (local < e.shape[0])
        rows = e.index_select(0, torch.where(ok, local, 0).reshape(-1)).reshape(*t.shape, e.shape[1])
        return rows * ok[..., None].to(rows.dtype)

    return shard_map(lookup, mesh, (e_pl, t_pl), out_pl)(emb, tokens)


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
        (the norms scale by ``1 + w``), LayerNorm's at one with a zero bias.
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
        if cfg.is_encoder_decoder:
            enc = encoder_config(cfg)
            params["enc_layers"] = [init_block(gen, enc, kind, dtype) for kind in enc.layer_seq()]
            params["enc_norm"] = init_norm(cfg, dtype, self.device)
        params["layers"] = [
            init_block(gen, cfg, kind, dtype, cross=cfg.is_encoder_decoder) for kind in cfg.layer_seq()
        ]
        if cfg.frontend == "vision":
            params["vision_proj"] = init_linear(gen, cfg.d_model, cfg.d_model, dtype)
        return params

    # -- embedding / head / frontends ------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        emb = params["embed"]
        if isinstance(emb, DTensor):
            x = _embed_on_shards(emb, tokens)
        else:
            x = emb.index_select(0, tokens.reshape(-1)).reshape(*tokens.shape, emb.shape[1])
        if self.cfg.embed_scale:
            x = x * replicated_like(torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype), x)
        return x

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        if cfg.tied_embeddings:
            logits = matmul(x, params["embed"].T)
        else:
            logits = linear(params["lm_head"], x)
        if cfg.final_logit_softcap > 0.0:  # in the logits' dtype, as the reference
            c = cfg.final_logit_softcap
            logits = torch.tanh(logits / c) * c
        if padded_vocab(cfg) != cfg.vocab:  # mask padded rows (differentiable: a masked_fill)
            pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
            logits = logits.masked_fill(replicated_like(pad, logits), -1e30)
        return logits

    def _encode(self, params: Params, src_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over ``src_embeds`` [B, S, d]: bidirectional, then ``enc_norm``."""
        pos = torch.arange(src_embeds.shape[1], dtype=torch.int32, device=src_embeds.device)
        x, _, _ = _apply_stack(encoder_config(self.cfg), params["enc_layers"], src_embeds,
                               positions=pos, causal=False, cache=None)
        return apply_norm(self.cfg, params["enc_norm"], x)

    def _inputs(self, params: Params, tokens, src_embeds, patch_embeds):
        """``(x, enc_out)``: the token embeddings, behind the projected patches
        for a vision model, and the encoder's output for an enc-dec one (else None)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        enc_out = None
        if cfg.is_encoder_decoder:
            if src_embeds is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder model needs src_embeds")
            enc_out = self._encode(params, src_embeds.to(x.dtype))
        if cfg.frontend == "vision":
            if patch_embeds is None:
                raise ValueError(f"{cfg.name}: a vision model needs patch_embeds")
            pe = linear(params["vision_proj"], patch_embeds.to(x.dtype))
            x = torch.cat([pe, x], dim=1)
        return x, enc_out

    # -- forward -----------------------------------------------------------------
    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,
        *,
        src_embeds: torch.Tensor | None = None,  # [B, S, d], audio frontend (enc-dec)
        patch_embeds: torch.Tensor | None = None,  # [B, P, d], vision frontend (prepended)
    ) -> torch.Tensor:
        """Cache-free causal forward: tokens [B, L] → logits [B, (P +) L, Vp]."""
        return self._forward(params, tokens, src_embeds, patch_embeds)[0]

    def _forward(self, params: Params, tokens, src_embeds=None, patch_embeds=None):
        """``(logits, aux)``, as the reference's ``forward``."""
        x, enc_out = self._inputs(params, tokens, src_embeds, patch_embeds)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, _, aux = _apply_stack(self.cfg, params["layers"], x, positions=pos, causal=True, cache=None,
                                 enc_out=enc_out)
        if aux is None:
            aux = replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        return self._logits(params, x), aux

    # -- loss ----------------------------------------------------------------
    def loss(
        self, params: Params, batch: dict[str, torch.Tensor], *, seq_chunk: int = 1024
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Next-token CE (labels == -1 ignored) + the MoE aux loss, as the reference.

        ``batch`` holds ``tokens`` and ``labels``, and ``src_embeds`` or
        ``patch_embeds`` where the model has that frontend; a vision model's
        CE is taken over the token positions only.  The CE is taken over
        ``seq_chunk`` positions at a time, each chunk's ``log_softmax`` in
        fp32.  ``aux`` is the MoE blocks' summed load-balance loss (0 for the
        dense families).  Returns ``(loss, {"ce", "aux", "tokens"})``, fp32 scalars.
        """
        cfg = self.cfg
        logits, aux = self._forward(params, batch["tokens"], batch.get("src_embeds"), batch.get("patch_embeds"))
        labels = batch["labels"]
        if cfg.frontend == "vision":  # loss only over the token region
            logits = logits[:, -labels.shape[1] :]
        dev = logits.device
        l = logits.shape[1]
        chunk = min(seq_chunk, l)
        total = replicated_like(torch.zeros((), dtype=torch.float32, device=dev), logits)
        count = replicated_like(torch.zeros((), dtype=torch.float32, device=dev), logits)
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
        """``{"len": int32 scalar, "layers": [entry per layer]}`` on the device,
        and ``"enc_out"`` [batch, frontend_len, d] for an encoder-decoder model;
        an entry is ``{"k", "v"}`` for attention, ``{"c_kv", "k_pe"}`` for MLA,
        ``{"state"}`` for a recurrent mixer.  A vision model's ``max_len``
        counts its patches."""
        cfg = self.cfg
        dtype = _dtype(cfg)
        layers = [
            init_block_cache(cfg, kind, batch, max_len, dtype, self.device) for kind in cfg.layer_seq()
        ]
        cache: Params = {"len": torch.zeros((), dtype=torch.int32, device=self.device), "layers": layers}
        if cfg.is_encoder_decoder:
            cache["enc_out"] = torch.zeros((batch, cfg.frontend_len, cfg.d_model), dtype=dtype, device=self.device)
        return cache

    def _decode(self, params: Params, x: torch.Tensor, cache: Params, enc_out) -> tuple[torch.Tensor, Params]:
        """The decoder over ``x`` [B, L, d] at positions ``len ..``; returns
        (the last position's logits [B, 1, Vp], the cache)."""
        ln = cache["len"]
        pos = ln + torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, layers, _ = _apply_stack(self.cfg, params["layers"], x, positions=pos, causal=True, cache=cache,
                                    enc_out=enc_out)
        return self._logits(params, x[:, -1:]), {**cache, "layers": layers, "len": ln + x.shape[1]}

    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,
        cache: Params,
        *,
        src_embeds: torch.Tensor | None = None,
        patch_embeds: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, Params]:
        """Consume the prompt [B, L0] (behind the patches of a vision model,
        after encoding ``src_embeds`` for an enc-dec one, into ``enc_out``);
        returns (last-position logits [B, 1, Vp], cache)."""
        x, enc_out = self._inputs(params, tokens, src_embeds, patch_embeds)
        if enc_out is not None:
            cache = {**cache, "enc_out": enc_out}
        return self._decode(params, x, cache, enc_out)

    def decode_step(
        self, params: Params, token: torch.Tensor, cache: Params
    ) -> tuple[torch.Tensor, Params]:
        """One decode step: token [B, 1] → (logits [B, 1, Vp], cache)."""
        return self._decode(params, self._embed(params, token), cache, cache.get("enc_out"))
