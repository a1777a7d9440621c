"""The decode-attention kernel's share of its roofline: the least time the
card could take for its launches in the traced stretch (q, the K and V rows
below each step's ``kv_len``, and the output, each moved once at the HBM
rate, or its FLOPs at the bf16 peak, whichever is longer), over the
kernel's profiled time.  Nothing is read unless the stretch holds exactly
one launch per attention layer and step."""

from bench.counts import kernels
from bench.harness.weights import layer_seq


def read(record):
    m, wl = record["model"], record["cell"]
    launches = [d for d in record["device"] if "decode_split_kernel" in d[0]]
    layers = sum(1 for mixer, _ in layer_seq(m) if mixer == "attn")
    if not launches or len(launches) != layers * record["steps"]:
        return None
    b, hq, hkv, hd = wl["batch"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    least = layers * sum(
        kernels.least_seconds(4 * b * hq * hd * kv, kernels.decode_attention_bytes(b, hq, hkv, hd, kv))
        for kv in record["kv_lens"]
    )
    return 100.0 * least / (sum(d[2] for d in launches) * 1e-6)
