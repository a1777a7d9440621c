"""Bytes and FLOPs a kernel launch needs, each input read once and each
output written once, at the cell's shapes; and the least time the card
could take for them."""

from __future__ import annotations

from . import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def decode_attention_bytes(batch: int, hq: int, hkv: int, hd: int, kv_len: int, elem: int = 2) -> int:
    """One decode-attention launch: q [B, Hq, hd], the K and V rows below
    ``kv_len`` [B, Hkv, kv_len, hd] each, and the output [B, Hq, hd]."""
    return elem * hd * (2 * batch * hq + 2 * batch * hkv * kv_len)


def flash_attention_flops(batch: int, hq: int, hd: int, lq: int, q_offset: int = 0) -> int:
    """Causal flash attention: query row ``r`` sees ``q_offset + r + 1`` keys,
    two products of ``2 hd`` FLOPs a key."""
    keys = lq * q_offset + lq * (lq + 1) // 2
    return 4 * batch * hq * hd * keys


def flash_attention_bytes(batch: int, hq: int, hkv: int, hd: int, lq: int, lk: int, elem: int = 2) -> int:
    """q and the output [B, Hq, Lq, hd], K and V [B, Hkv, Lk, hd]."""
    return elem * hd * batch * (2 * hq * lq + 2 * hkv * lk)


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the compute bound and the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
