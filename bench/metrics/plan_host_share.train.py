"""Share of the traced ``train.iteration``'s wall time during which no step
of the SWIRL plan runs (no ``exec`` span open on any thread): the plan's
compile, the runtime's build, its scheduling rounds, its pool's start and
stop."""

from bench.harness import spans
from bench.harness.profile import _union


def read(record):
    sp = spans.program(record)
    if sp is None:
        return None
    iters = _union([(s.start, s.end) for s in sp if s.name == "train.iteration"])
    execs = _union([(s.start, s.end) for s in sp if s.kind == "exec"])
    total = spans.length(iters)
    return 100.0 * (1.0 - spans.overlap(iters, execs) / total) if total > 0 else None
