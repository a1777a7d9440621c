"""Device operations (kernels, copies, memsets) a decode step: every one the
profiler recorded in the traced stretch, over the stretch's steps."""


def read(record):
    if not record["device"]:
        return None
    return len(record["device"]) / record["steps"]
