"""Architecture registry: ``--arch <id>`` → ModelConfig (+ smoke variants).

The reference's ten archs, each config a copy of the reference's.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig, smoke_variant

from . import (
    deepseek_moe_16b,
    gemma2_27b,
    granite_moe_1b_a400m,
    internvl2_1b,
    jamba_v0_1_52b,
    llama3_2_3b,
    nemotron_4_15b,
    qwen1_5_110b,
    seamless_m4t_medium,
    xlstm_125m,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        seamless_m4t_medium,
        gemma2_27b,
        nemotron_4_15b,
        llama3_2_3b,
        qwen1_5_110b,
        xlstm_125m,
        internvl2_1b,
        granite_moe_1b_a400m,
        deepseek_moe_16b,
        jamba_v0_1_52b,
    )
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    return smoke_variant(cfg) if smoke else cfg


__all__ = ["ARCHS", "get_config"]
