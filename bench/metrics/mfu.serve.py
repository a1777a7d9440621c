"""Model FLOPs of the window's prefills and decode steps over the window's
seconds, as a share of the card's dense bf16 peak."""

from bench.harness.readers import mfu


def read(record):
    return mfu(record)
