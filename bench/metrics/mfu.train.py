"""Model FLOPs of the window's training iterations (forward and backward,
recompute not counted) over the window's seconds, as a share of the card's
dense bf16 peak."""

from bench.harness.readers import mfu


def read(record):
    return mfu(record)
