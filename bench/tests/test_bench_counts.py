"""The yardstick's arithmetic against numbers worked by hand."""

import pytest

from bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, flops, kernels

# d 4, 2 query heads and 1 KV head of 2, one attention + MLP layer (d_ff 8), vocab 10.
TOY = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab": 10,
       "prefix_pattern": [], "pattern": [["attn", "mlp"]]}
# The same with a MoE FFN: 4 experts of width 3, top 2, one shared expert.
TOY_MOE = dict(TOY, pattern=[["attn", "moe"]], moe={"n_experts": 4, "top_k": 2, "d_expert": 3, "n_shared": 1})


def test_body_and_head_macs():
    # q 4x4 + k, v 4x2 each + o 4x4 = 48; MLP 3 x 4 x 8 = 96.
    assert flops.body_macs(TOY) == 144
    # attention 48; router 4 x 4 = 16; (2 + 1) experts x 3 x 4 x 3 = 108.
    assert flops.body_macs(TOY_MOE) == 172
    assert flops.head_macs(TOY) == 40


def test_prefill_decode_and_train_flops():
    # 1 prompt of 3: 2 x 3 x 144 = 864, head at the last position 2 x 40 = 80,
    # attention: keys 1 + 2 + 3 = 6, 4 x 2 heads x 2 wide x 6 = 96.
    assert flops.prefill(TOY, 1, 3) == 1040
    # 2 sequences, each new token sees 5 keys: 2 x 2 x (144 + 40) = 736, 4 x 2 x 2 x 10 = 160.
    assert flops.decode_step(TOY, 2, 5) == 896
    # 1 row of 3: 6 x 3 x 184 = 3312, attention 3 x 96 = 288.
    assert flops.train_iteration(TOY, 1, 3) == 3600


def test_kernel_bytes_and_flops():
    # 2 x 8 x (2 x 2 x 4 + 2 x 2 x 2 x 10) = 16 x 96
    assert kernels.decode_attention_bytes(2, 4, 2, 8, 10) == 1536
    # causal 3 rows: 1 + 2 + 3 = 6 keys, 4 x 2 x 4 x 6
    assert kernels.flash_attention_flops(1, 2, 4, 3) == 192
    # after 2 cached rows: 3 + 4 + 5 = 12 keys
    assert kernels.flash_attention_flops(1, 2, 4, 3, q_offset=2) == 384
    # 2 x 4 x (2 x 2 x 3 + 2 x 1 x 5)
    assert kernels.flash_attention_bytes(1, 2, 1, 4, 3, 5) == 176


def test_peaks_and_least_time():
    assert PEAK_BF16_FLOPS == 989e12 and PEAK_HBM_BYTES == 3.35e12
    assert kernels.least_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert kernels.least_seconds(1.0, 6.7e12) == pytest.approx(2.0)
