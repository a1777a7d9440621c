"""Share of the traced stretch's device busy time that the absorbed MLA
decode kernel's launches (``mla_split_kernel``, ``mla_merge_kernel``) take:
how much of a decode step the latent attention is (nothing where none ran)."""

PARTS = ("mla_split_kernel", "mla_merge_kernel")


def read(record):
    mine = [d for d in record["device"] if any(part in d[0] for part in PARTS)]
    if not mine or record["busy_s"] <= 0:
        return None
    return 100.0 * sum(d[2] for d in mine) * 1e-6 / record["busy_s"]
