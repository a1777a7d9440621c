"""Share of the traced iteration's device time spent in the kernels that the
trainer's ``update_fn`` (AdamW over every leaf) launched: device operations
whose launch, matched by its correlation id, lies on the thread and inside
a ``bench.update_fn`` range."""


def read(record):
    ranges = [(tid, s, e) for name, tid, s, e in record["ranges"] if name == "bench.update_fn"]
    total = sum(d[2] for d in record["device"])
    if not ranges or total <= 0:
        return None
    inside = 0.0
    for _, _, dur, corr in record["device"]:
        launch = record["launches"].get(corr)
        if launch and any(tid == launch[0] and s <= launch[1] <= e for tid, s, e in ranges):
            inside += dur
    return 100.0 * inside / total if inside > 0 else None
