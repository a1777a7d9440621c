"""Share of the traced stretch's ``serve.decode`` spans that hold a
``serve.decode.replay`` span on the same thread: the decode steps replayed
from a CUDA graph (0 where the program has no such span)."""

from bench.harness import spans


def read(record):
    sp = spans.program(record)
    if sp is None:
        return None
    steps = [s for s in sp if s.name == "serve.decode"]
    replays = spans.by_thread(s for s in sp if s.name == "serve.decode.replay")
    held = sum(any(s.start <= a and b <= s.end for a, b in replays.get(s.thread, [])) for s in steps)
    return 100.0 * held / len(steps) if steps else None
