"""Share of the ``serve.decode`` spans' host time spent inside the MoE
layers' stage spans (``model.moe.*``) on the same thread."""

from bench.harness import spans


def read(record):
    sp = spans.program(record)
    if sp is None:
        return None
    steps = spans.by_thread(s for s in sp if s.name == "serve.decode")
    moe = spans.by_thread(s for s in sp if s.name.startswith("model.moe."))
    total = sum(spans.length(iv) for iv in steps.values())
    inside = sum(spans.overlap(iv, moe.get(t, [])) for t, iv in steps.items())
    return 100.0 * inside / total if total > 0 else None
