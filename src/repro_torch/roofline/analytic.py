"""Analytic FLOP and HBM-traffic models per (config × shape).

A copy of ``repro.roofline.analytic``: the same arithmetic over the port's
own ``ModelConfig`` and ``Shape``, so both packages give the same numbers.
The reference's reasons for the models, kept below, speak of XLA; in the
port, the dry-run counts every op that runs (no loop body hides its
repeats), and its byte count is the unfused one too.

Why analytic: the production program scans its layer stack, and XLA's
``cost_analysis`` counts a while-loop body ONCE, so compiled-artifact FLOPs
under-report by ~the repeat count; conversely the CPU backend's
"bytes accessed" counts every unfused operand access and over-reports HBM
traffic by orders of magnitude versus a fusing TPU backend.  The models
below count matmul FLOPs exactly from the layer dimensions and estimate
fused HBM traffic from first principles.  They are validated against an
*unrolled* compiled cell (llama3.2-3b × train_4k) in the §Roofline log —
agreement is within ~15%.

Multipliers: train = fwd + bwd(2×) + remat-recompute(1×) = 4× forward
FLOPs inside remat'd blocks, 3× for the LM head (outside remat);
prefill/decode = 1× forward.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig

VOCAB_PAD = 256


def _padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def _attn_len(kind: str, seq_len: int, window: int) -> float:
    """Average attended KV length per query token."""
    if kind == "decode":
        return float(seq_len)  # one token attends over the whole cache
    eff = (seq_len + 1) / 2.0  # causal average
    if window > 0:
        eff = min(eff, float(window))
    return eff


def _mixer_fwd_flops_per_token(
    cfg: ModelConfig, mixer: str, kind: str, seq_len: int
) -> float:
    d = cfg.d_model
    if mixer in ("attn", "attn_local"):
        proj = 2.0 * d * (2 * cfg.q_dim + 2 * cfg.kv_dim)
        window = cfg.sliding_window if mixer == "attn_local" else 0
        l_eff = _attn_len(kind, seq_len, window)
        attn = 4.0 * cfg.q_dim * l_eff  # qk^T + pv
        return proj + attn
    if mixer == "mla":  # the port's own (an MLAModelConfig): its projections, then q·k over n + r and p·v
        a = cfg.mla
        proj = 2.0 * (cfg._mixer_params("mla") - a.kv_lora_rank)  # all but the latent's norm
        per_key = 2.0 * cfg.n_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim)
        return proj + per_key * _attn_len(kind, seq_len, 0)
    if mixer == "mamba":
        di = cfg.ssm.expand * d
        ds = cfg.ssm.d_state
        dtr = max(1, d // 16)
        return (
            2.0 * d * 2 * di  # in_proj
            + 2.0 * cfg.ssm.d_conv * di  # conv
            + 2.0 * di * (dtr + 2 * ds)  # x_proj
            + 2.0 * dtr * di  # dt_proj
            + 9.0 * di * ds  # scan recurrence (elementwise)
            + 2.0 * di * ds  # C·h readout
            + 2.0 * di * d  # out_proj
        )
    if mixer == "mlstm":
        qd = cfg.q_dim
        c = 1.0 if kind == "decode" else min(cfg.ssm.chunk, seq_len)
        intra = 2.0 * 2.0 * qd * (c / 2.0)  # qk^T + weighted v within chunk
        inter = 3.0 * 2.0 * qd * cfg.head_dim  # carry read + update
        return 2.0 * d * 3 * qd + intra + inter + 2.0 * qd * d
    if mixer == "slstm":
        return 16.0 * d * d  # 4 input + 4 recurrent matmuls
    raise ValueError(mixer)


def _ffn_fwd_flops_per_token(cfg: ModelConfig, ffn: str) -> float:
    d = cfg.d_model
    if ffn == "none":
        return 0.0
    if ffn == "mlp":
        mult = 3 if cfg.activation.endswith("_glu") else 2
        return 2.0 * mult * d * cfg.d_ff
    if ffn == "dense0":
        return 2.0 * 3 * d * cfg.d_ff
    if ffn == "moe":
        m = cfg.moe
        routed = 2.0 * 3 * d * m.d_expert * m.top_k * m.capacity_factor
        shared = 2.0 * 3 * d * (m.n_shared * m.d_expert)
        router = 2.0 * d * m.n_experts
        return routed + shared + router
    raise ValueError(ffn)


def analytic_flops_global(cfg: ModelConfig, shape: Shape) -> float:
    """Total FLOPs of one step across all chips."""
    kind = shape.kind
    if kind == "decode":
        tokens = float(shape.global_batch)
        seq_for_attn = shape.seq_len
    else:
        tokens = float(shape.seq_len * shape.global_batch)
        seq_for_attn = shape.seq_len

    block_fwd = 0.0
    for mixer, ffn in cfg.layer_seq():
        block_fwd += _mixer_fwd_flops_per_token(cfg, mixer, kind, seq_for_attn)
        block_fwd += _ffn_fwd_flops_per_token(cfg, ffn)

    if cfg.is_encoder_decoder:
        # decoder blocks add cross-attention to frontend_len encoder rows
        cross = 2.0 * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + 4.0 * cfg.q_dim * cfg.frontend_len
        block_fwd += cross * cfg.n_layers
        # encoder runs over frontend_len rows (per sequence, train/prefill)
        enc_fwd_per_tok = cfg.n_enc_layers * (
            _mixer_fwd_flops_per_token(cfg, "attn", "prefill", cfg.frontend_len)
            + _ffn_fwd_flops_per_token(cfg, "mlp")
        )
        enc_tokens = (
            float(shape.global_batch * cfg.frontend_len)
            if kind != "decode"
            else 0.0
        )
    else:
        enc_fwd_per_tok, enc_tokens = 0.0, 0.0

    head_fwd = 2.0 * cfg.d_model * _padded_vocab(cfg)

    if kind == "train":
        block_mult, head_mult = 4.0, 3.0
    else:
        block_mult, head_mult = 1.0, 1.0
    head_tokens = tokens if kind == "train" else float(shape.global_batch)
    # prefill computes the full-seq logits? we only take the last position;
    # the head runs on 1 row per sequence for prefill/decode.

    total = (
        tokens * block_fwd * block_mult
        + enc_tokens * enc_fwd_per_tok * block_mult
        + head_tokens * head_fwd * head_mult
    )
    return total


@dataclass(frozen=True)
class MemoryModel:
    params_bytes: float
    opt_bytes: float
    grad_bytes: float
    act_bytes: float
    kv_bytes: float
    logits_bytes: float

    @property
    def total(self) -> float:
        return (
            self.params_bytes
            + self.opt_bytes
            + self.grad_bytes
            + self.act_bytes
            + self.kv_bytes
            + self.logits_bytes
        )


def analytic_hbm_bytes_per_device(
    cfg: ModelConfig,
    shape: Shape,
    *,
    model_ways: int,
    data_ways: int,
) -> MemoryModel:
    """Estimated fused HBM traffic per device per step.

    Sharding model: params over ``model`` (TP/EP); batch over data axes;
    optimizer moments additionally over ``data`` (ZeRO-1).
    """
    p_local = cfg.param_count() / model_ways
    kind = shape.kind
    b_local = max(1, shape.global_batch // data_ways)
    l = shape.seq_len
    d = cfg.d_model
    dt = 2.0  # bf16

    if kind == "train":
        tokens_local = b_local * l
        params = p_local * dt * 3  # fwd read + bwd read + update write
        opt = (p_local / data_ways) * 4.0 * 2 * 2  # m,v read+write fp32
        grads = p_local * dt * 2  # write + read (+AR staging not counted here)
        # activations: per layer one saved residual stream (remat policy),
        # written fwd / read bwd, plus ~2× recompute traffic
        act = cfg.n_layers * tokens_local * d * dt * 4
        kv = 0.0
        logits = b_local * l * (_padded_vocab(cfg) / model_ways) * dt * 4
    elif kind == "prefill":
        tokens_local = b_local * l
        params = p_local * dt
        opt = grads = 0.0
        act = cfg.n_layers * tokens_local * d * dt * 2
        # KV cache write once + chunked re-reads (q_chunk = 2048)
        n_attn = sum(1 for m, _ in cfg.layer_seq() if m.startswith("attn"))
        rereads = max(1, l // 2048) / 2  # causal: half the blocks on average
        kv = n_attn * b_local * l * cfg.kv_dim * 2 * dt * (1 + rereads)
        logits = b_local * (_padded_vocab(cfg) / model_ways) * dt
    else:  # decode
        params = p_local * dt  # whole model read once per token step
        opt = grads = 0.0
        act = cfg.n_layers * b_local * d * dt * 4
        n_attn = sum(1 for m, _ in cfg.layer_seq() if m.startswith("attn"))
        if shape.global_batch >= data_ways:
            cache_rows_local = b_local * l
        else:  # SP long-context: sequence sharded over data
            cache_rows_local = shape.global_batch * l / data_ways
        # KV heads (or head_dim) are model-sharded → per-device kv_dim slice
        kv = n_attn * cache_rows_local * (cfg.kv_dim / model_ways) * 2 * dt
        # recurrent state traffic
        n_rec = sum(
            1 for m, _ in cfg.layer_seq() if m in ("mamba", "mlstm", "slstm")
        )
        di = cfg.ssm.expand * d
        rec = n_rec * b_local * (di / model_ways) * cfg.ssm.d_state * 4.0 * 2
        act += rec
        logits = b_local * (_padded_vocab(cfg) / model_ways) * dt
    return MemoryModel(
        params_bytes=params,
        opt_bytes=opt,
        grad_bytes=grads,
        act_bytes=act,
        kv_bytes=kv,
        logits_bytes=logits,
    )
