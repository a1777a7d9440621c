"""Model configuration — the port's own copy of ``repro.models.config``.

The fields, defaults, derived values and the smoke reduction are the
reference's, so a config means the same model in both packages.  The port
serves only the dense subset so far (see :mod:`repro_torch.models.model`);
the other fields are kept so that every reference config can be expressed.
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
    # slstm, ffn in mlp/moe/dense0/none.
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
