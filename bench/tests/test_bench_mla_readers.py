"""The absorbed MLA decode kernel's readers, and its bytes and FLOPs, on
canned input."""

import pytest

from bench.counts import kernels, mla
from bench.harness import core

M = {"n_layers": 2, "d_model": 16, "n_heads": 4, "n_kv_heads": 4, "head_dim": 8, "d_ff": 8, "vocab": 10,
     "prefix_pattern": [["mla", "dense0"]], "pattern": [["mla", "moe"]],
     "mla": {"kv_lora_rank": 512, "qk_rope_head_dim": 64}}


def reader(name):
    return core.load_reader(name).read


def canned(device=None):
    split, merge = "void (anonymous namespace)::mla_split_kernel<2>(...)", "(anonymous)::mla_merge_kernel(...)"
    return {
        # 2 MLA layers x 2 steps: a split (2 us) and a merge (1 us) each, beside other work
        "device": device if device is not None else [
            (split, 0.0, 2.0, 1), (merge, 3.0, 1.0, 2), ("gemv", 5.0, 10.0, 3), (split, 20.0, 2.0, 4),
            (merge, 23.0, 1.0, 5), (split, 30.0, 2.0, 6), (merge, 33.0, 1.0, 7), (split, 40.0, 2.0, 8),
            (merge, 43.0, 1.0, 9)],
        "busy_s": 24e-6, "window_s": 50e-6, "steps": 2, "kv_lens": [100, 101],
        "cell": {"batch": 3}, "model": M,
    }


def test_the_kernels_bytes_and_flops():
    # rows [3, 100, 576], queries [3, 4, 576], output [3, 4, 512], 2 bytes each
    assert mla.mla_decode_bytes(3, 4, 100) == 2 * (3 * 100 * 576 + 3 * 4 * 576 + 3 * 4 * 512)
    assert mla.mla_decode_flops(3, 4, 100) == 2 * 3 * 4 * 100 * (512 + 64 + 512)
    # at the long-prompt cell's shape the kernel is bound by bytes: ~44 us
    b, f = mla.mla_decode_bytes(4, 16, 32100), mla.mla_decode_flops(4, 16, 32100)
    assert kernels.least_seconds(f, b) == b / 3.35e12 and 43e-6 < b / 3.35e12 < 45e-6


def test_mla_decode_roofline():
    least = 2 * sum(kernels.least_seconds(mla.mla_decode_flops(3, 4, kv), mla.mla_decode_bytes(3, 4, kv))
                    for kv in (100, 101))
    assert reader("mla_decode_roofline")(canned()) == pytest.approx(100 * least / 12e-6)
    # a stretch that misses a merge, or holds no MLA kernel, reads nothing
    assert reader("mla_decode_roofline")(canned(canned()["device"][:-1])) is None
    assert reader("mla_decode_roofline")(canned([("gemv", 5.0, 10.0, 3)])) is None
    # the decode-attention reader does not take the MLA kernel for its own
    assert reader("decode_attention_roofline")(canned()) is None


def test_mla_decode_share():
    assert reader("mla_decode_share.decode")(canned()) == pytest.approx(100 * 12e-6 / 24e-6)
    assert reader("mla_decode_share.decode")(canned([("gemv", 5.0, 10.0, 3)])) is None
