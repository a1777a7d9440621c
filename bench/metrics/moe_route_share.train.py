"""Share of the traced iteration's device time in operations launched inside
the MoE layers' ``model.moe.route`` spans (router, softmax, top-k, slots and
the aux loss; the forward's and the remat recompute's, each on its own
thread)."""

from bench.harness import spans


def read(record):
    sp = spans.program(record)
    return None if sp is None else spans.device_share(record, sp, {"model.moe.route"})
