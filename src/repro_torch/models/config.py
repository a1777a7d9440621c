"""Model configuration — the port's own copy of ``repro.models.config``.

The fields, defaults, derived values, the parameter counts that the
roofline reads (``param_count``, ``active_param_count``), the unrolled
variant and the smoke reduction are the reference's, so a config means the same model in both packages, and the
port serves every one of them (see :mod:`repro_torch.models.model`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

Activation = Literal["silu_glu", "gelu_glu", "relu_sq", "gelu"]
NormKind = Literal["rmsnorm", "layernorm"]


@dataclass(frozen=True)
class MoECfg:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared: int = 0  # always-active shared experts (DeepSeek-MoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 1024  # selective-scan chunk length


@dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention (DeepSeek-V2): a ``kv_lora_rank``-wide
    latent of K and V and one shared RoPE key of ``qk_rope_head_dim``, with
    YaRN's rotary scaling (``factor`` over ``original_max_position``)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0: q is one projection of x (no q LoRA)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Block layout: (mixer, ffn) pairs; mixer in attn/attn_local/mamba/mlstm/
    # slstm (and mla, on an MLAModelConfig), ffn in mlp/moe/dense0/none.
    prefix_pattern: tuple[tuple[str, str], ...] = ()
    pattern: tuple[tuple[str, str], ...] = (("attn", "mlp"),)

    # Attention details
    use_rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0  # used by attn_local
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_block_norm: bool = False

    # FFN / embeddings
    activation: Activation = "silu_glu"
    norm: NormKind = "rmsnorm"
    tied_embeddings: bool = False
    embed_scale: bool = False  # sqrt(d) embedding multiplier

    moe: MoECfg = field(default_factory=MoECfg)
    ssm: SSMCfg = field(default_factory=SSMCfg)

    # Encoder-decoder and modality frontends
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    cross_attn: bool = False
    frontend: Literal["none", "vision", "audio"] = "none"
    frontend_len: int = 256

    # Numerics
    dtype: str = "bfloat16"
    remat: bool = True  # training only; serving ignores it

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        n_body = self.n_layers - len(self.prefix_pattern)
        if self.pattern and n_body % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: {n_body} body layers not divisible by "
                f"pattern of {len(self.pattern)}"
            )
        if not self.pattern and n_body != 0:
            raise ValueError(f"{self.name}: empty pattern with {n_body} body layers")

    @property
    def repeats(self) -> int:
        if not self.pattern:
            return 0
        return (self.n_layers - len(self.prefix_pattern)) // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_seq(self) -> tuple[tuple[str, str], ...]:
        """The full per-layer (mixer, ffn) sequence."""
        return self.prefix_pattern + self.pattern * self.repeats

    # -- parameter counting (used for MODEL_FLOPS and roofline) -------------
    def _mixer_params(self, mixer: str) -> int:
        d = self.d_model
        if mixer in ("attn", "attn_local"):
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            return p
        if mixer == "mamba":
            di = self.ssm.expand * d
            ds = self.ssm.d_state
            dtr = max(1, d // 16)  # dt_rank
            return (
                d * 2 * di  # in_proj (x, z)
                + self.ssm.d_conv * di + di  # depthwise conv w + b
                + di * (dtr + 2 * ds)  # x_proj → (dt, B, C)
                + dtr * di + di  # dt_proj + bias
                + di * ds + di  # A_log, D
                + di * d  # out_proj
            )
        if mixer == "mlstm":
            # qkv + gates (i, f per head) + out
            return d * 3 * self.q_dim + 2 * d * self.n_heads + self.q_dim * d
        if mixer == "slstm":
            # recurrent cell: 4 gates × (input + recurrent) projections
            return 8 * d * d + 4 * d
        raise ValueError(mixer)

    def _ffn_params(self, ffn: str) -> int:
        d = self.d_model
        if ffn == "none":
            return 0
        if ffn == "mlp":
            mult = 3 if self.activation.endswith("_glu") else 2
            return mult * d * self.d_ff
        if ffn == "moe":
            m = self.moe
            mult = 3  # experts are gated MLPs
            routed = m.n_experts * mult * d * m.d_expert
            shared = m.n_shared * mult * d * m.d_expert
            router = d * m.n_experts
            return routed + shared + router
        if ffn == "dense0":  # DeepSeek layer-0 dense MLP (d_ff stored in d_ff)
            return 3 * self.d_model * self.d_ff
        raise ValueError(ffn)

    def param_count(self) -> int:
        d = self.d_model
        n = self.vocab * d  # embedding
        if not self.tied_embeddings:
            n += self.vocab * d  # lm head
        layers = self.layer_seq()
        if self.is_encoder_decoder:
            # encoder self-attn blocks + decoder (self + cross) blocks
            enc = self.n_enc_layers * (
                self._mixer_params("attn") + self._ffn_params("mlp") + 2 * d
            )
            dec = self.n_layers * (
                2 * self._mixer_params("attn") + self._ffn_params("mlp") + 3 * d
            )
            return n + enc + dec + d
        for mixer, ffn in layers:
            n += self._mixer_params(mixer) + self._ffn_params(ffn)
            n += 2 * d if ffn != "none" else d  # norms
            if self.post_block_norm:
                n += 2 * d
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not any(f == "moe" for _, f in self.layer_seq()):
            return self.param_count()
        d, m = self.d_model, self.moe
        inactive_experts = m.n_experts - m.top_k
        per_moe_layer = inactive_experts * 3 * d * m.d_expert
        n_moe = sum(1 for _, f in self.layer_seq() if f == "moe")
        return self.param_count() - n_moe * per_moe_layer


@dataclass(frozen=True)
class MLAModelConfig(ModelConfig):
    """A config whose mixer may be ``mla``: :class:`ModelConfig` and its
    ``mla`` section.  A subclass, so that the ten archs' configs keep the
    reference's fields exactly (``dataclasses.asdict`` of each equals the
    JAX package's)."""

    mla: MLACfg = field(default_factory=MLACfg)

    def _mixer_params(self, mixer: str) -> int:
        if mixer != "mla":
            return super()._mixer_params(mixer)
        m, d, h = self.mla, self.d_model, self.n_heads
        return (
            d * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)  # q
            + d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv_a: the latent and the RoPE key
            + m.kv_lora_rank  # kv_norm
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)  # kv_b
            + h * m.v_head_dim * d  # o
        )


def unrolled_variant(cfg: ModelConfig, *, ssm_chunk: int | None = None) -> ModelConfig:
    """All layers in ``prefix_pattern``, as the reference's (whose dry-run
    unrolls its scanned stack so that ``cost_analysis`` sees every layer).
    The port keeps one param dict a layer and walks them in a Python loop, so
    the same model results: only ``prefix_pattern``, ``pattern`` and, when
    given, the SSM chunk change."""
    kw = dict(prefix_pattern=cfg.layer_seq(), pattern=())
    if ssm_chunk is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, chunk=ssm_chunk)
    return dataclasses.replace(cfg, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests (as the reference's)."""
    pat = cfg.pattern
    prefix = cfg.prefix_pattern
    n_layers = len(prefix) + len(pat)  # one repeat of the pattern
    moe = cfg.moe
    if moe.n_experts:
        moe = dataclasses.replace(
            moe,
            n_experts=max(4, moe.top_k + 1) if moe.n_experts > 4 else moe.n_experts,
            top_k=min(moe.top_k, 2),
            d_expert=32,
        )
    n_heads = min(cfg.n_heads, 4)
    if isinstance(cfg, MLAModelConfig):
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(1, min(cfg.n_kv_heads, n_heads)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        moe=moe,
        ssm=dataclasses.replace(cfg.ssm, chunk=16),
        frontend_len=8 if cfg.frontend != "none" else cfg.frontend_len,
        remat=False,
        dtype="float32",
    )
