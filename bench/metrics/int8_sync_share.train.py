"""Share of the traced iteration's device time in operations launched inside
the int8 gradient sync's spans: ``optim.compress`` (in each pod's
``fwdbwd``), ``optim.decompress`` and ``optim.allreduce_mean`` (in
``gradsync``)."""

from bench.harness import spans

NAMES = {"optim.compress", "optim.decompress", "optim.allreduce_mean"}


def read(record):
    sp = spans.program(record)
    return None if sp is None else spans.device_share(record, sp, NAMES)
