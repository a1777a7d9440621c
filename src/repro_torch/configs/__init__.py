"""Architecture registry of the archs the port serves: ``--arch <id>`` → ModelConfig."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig, smoke_variant

from . import llama3_2_3b

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (llama3_2_3b,)}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(
            f"arch {arch!r} is not served by repro_torch yet; it serves {sorted(ARCHS)}"
        )
    cfg = ARCHS[arch]
    return smoke_variant(cfg) if smoke else cfg


__all__ = ["ARCHS", "get_config"]
