"""Optimisation: AdamW + schedule, int8 gradient compression (ZeRO-1 specs
wait for ROADMAP queue A, A7)."""

from .adamw import AdamWConfig, AdamWState, global_norm, init, schedule, update
from .compress import (
    Compressed,
    allreduce_mean,
    compress,
    compressed_bytes,
    decompress,
)

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
]
