"""Model zoo of the port: configs, layers, mixers (attention/Mamba/xLSTM), MoE, facade, converter."""

from .config import ModelConfig, MoECfg, SSMCfg, smoke_variant
from .convert import params_from_jax, params_to_jax
from .layers import get_attn_impl, set_attn_impl
from .model import Model, padded_vocab

__all__ = [
    "ModelConfig",
    "MoECfg",
    "SSMCfg",
    "smoke_variant",
    "Model",
    "padded_vocab",
    "params_from_jax",
    "params_to_jax",
    "set_attn_impl",
    "get_attn_impl",
]
