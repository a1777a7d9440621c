"""Mean host time of a decode step in the traced stretch: the duration of
the program's ``serve.decode`` spans (the step's call, argmax included)."""

from bench.harness import spans


def read(record):
    sp = spans.program(record)
    steps = [s.end - s.start for s in sp or () if s.name == "serve.decode"]
    return 1e-3 * sum(steps) / len(steps) if steps else None
