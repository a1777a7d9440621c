"""The absorbed MLA decode kernel's share of its roofline: the least time
the card could take for its calls in the traced stretch (the ``c_kv`` and
``k_pe`` rows below each step's ``kv_len``, the queries and the output, each
moved once at the HBM rate, or its FLOPs at the bf16 peak, whichever is
longer), over the profiled time of its two launches, ``mla_split_kernel``
and ``mla_merge_kernel``.  Nothing is read unless the stretch holds exactly
one launch of each per MLA layer and step."""

from bench.counts import kernels, mla
from bench.harness.weights import layer_seq

PARTS = ("mla_split_kernel", "mla_merge_kernel")


def read(record):
    m, wl = record["model"], record["cell"]
    layers = sum(1 for mixer, _ in layer_seq(m) if mixer == "mla")
    want = layers * record["steps"]
    launches = {part: [d for d in record["device"] if part in d[0]] for part in PARTS}
    if not want or any(len(v) != want for v in launches.values()):
        return None
    b, h, a = wl["batch"], m["n_heads"], m["mla"]
    c, r = a["kv_lora_rank"], a["qk_rope_head_dim"]
    least = layers * sum(
        kernels.least_seconds(mla.mla_decode_flops(b, h, kv, c, r), mla.mla_decode_bytes(b, h, kv, c, r))
        for kv in record["kv_lens"]
    )
    return 100.0 * least / (sum(d[2] for v in launches.values() for d in v) * 1e-6)
