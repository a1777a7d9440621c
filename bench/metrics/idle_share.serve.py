"""Share of the traced stretch of decode steps with no device operation running."""

from bench.harness.readers import idle_share


def read(record):
    return idle_share(record)
