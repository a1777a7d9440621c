"""Share of the traced stretch's device-idle time that lies outside every
``serve.decode`` span: the token's copy to the host and the serving loop
between steps."""

from bench.harness import spans
from bench.harness.profile import _union


def read(record):
    sp = spans.program(record)
    if sp is None:
        return None
    s0, s1 = record["stretch"]
    busy = _union([(d[1], d[1] + d[2]) for d in record["device"]])
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    steps = _union([(s.start, s.end) for s in sp if s.name == "serve.decode"])
    total = spans.length(idle)
    return 100.0 * (total - spans.overlap(idle, steps)) / total if total > 0 else None
