"""Bytes and FLOPs of one call of the port's absorbed MLA decode kernel
(``mla_split_kernel`` then ``mla_merge_kernel``), each input read once and
each output written once; the split partials that pass between the two
launches are the kernel's own overhead and are not counted."""

from __future__ import annotations


def mla_decode_bytes(batch: int, heads: int, kv_len: int, latent: int = 512, rope: int = 64, elem: int = 2) -> int:
    """The cache rows below ``kv_len`` ([B, kv_len, latent + rope]: ``c_kv``
    and ``k_pe``), the queries ([B, H, latent + rope]: ``q_lat`` and
    ``q_pe``) and the output ([B, H, latent])."""
    return elem * batch * ((kv_len + heads) * (latent + rope) + heads * latent)


def mla_decode_flops(batch: int, heads: int, kv_len: int, latent: int = 512, rope: int = 64) -> int:
    """Each head scores each valid row over ``latent + rope`` dims and sums
    its ``latent``-wide value: ``2 H (latent + rope + latent)`` a row."""
    return 2 * batch * heads * kv_len * (2 * latent + rope)
