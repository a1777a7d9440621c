"""Roofline analysis: collectives counted as they run, the analytic FLOP and
HBM models, and the three-term model on H100 cards."""

from .analysis import (
    CHIPS,
    ChipSpec,
    Roofline,
    chip_sku,
    model_flops,
    roofline,
    slstm_extra_flops,
)
from .collectives import CollectiveCounter, CollectiveStats

__all__ = [
    "Roofline",
    "roofline",
    "model_flops",
    "slstm_extra_flops",
    "CollectiveCounter",
    "CollectiveStats",
    "CHIPS",
    "ChipSpec",
    "chip_sku",
]
