"""Arithmetic that several metric readers share."""

from bench.counts import PEAK_BF16_FLOPS


def idle_share(record):
    """Percent of the traced stretch with no device operation running."""
    if record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def mfu(record):
    """Percent of the dense bf16 peak that the window's model FLOPs reach."""
    w = record.get("window")
    if not w or w["seconds"] <= 0:
        return None
    return 100.0 * w["flops"] / (w["seconds"] * PEAK_BF16_FLOPS)
