"""Optimisation: AdamW + schedule, ZeRO-1 specs, int8 gradient compression."""

from .adamw import AdamWConfig, AdamWState, global_norm, init, schedule, update
from .compress import (
    Compressed,
    allreduce_mean,
    compress,
    compressed_bytes,
    decompress,
)
from .zero import zero1_specs

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "init",
    "update",
    "schedule",
    "global_norm",
    "compress",
    "decompress",
    "allreduce_mean",
    "Compressed",
    "compressed_bytes",
    "zero1_specs",
]
