"""Model FLOPs of a prefill, a decode step and a training iteration.

Model FLOPs count the work the model defines, two a multiply-add: every
weight product of a token (each layer's mixer and FFN, as its kind's
``macs`` in ``bench/layers/<kind>.py`` counts them), the LM head where
logits are taken, and causal attention (a query at position ``p`` sees
``p + 1`` keys, each costing its layer's mixer ``key_flops``: ``4 H hd``
for attention).  Capacity padding, recompute and elementwise work are not
counted.  ``m`` is a configuration's ``model`` section.
"""

from __future__ import annotations

from collections import Counter

from .. import layers


def layer_seq(m: dict) -> list[tuple[str, str]]:
    """Each layer's ``(mixer, ffn)``: the prefix, then the pattern repeated."""
    prefix = [tuple(k) for k in m.get("prefix_pattern", [])]
    pattern = [tuple(k) for k in m["pattern"]]
    return prefix + pattern * ((m["n_layers"] - len(prefix)) // len(pattern))


def body_macs(m: dict) -> int:
    """Multiply-adds of one token's weight products below the LM head."""
    kinds = Counter(layer_seq(m))  # each kind once: the serve driver counts every step inside its window
    return sum(n * (layers.load(mixer).macs(m) + layers.load(ffn).macs(m)) for (mixer, ffn), n in kinds.items())


def head_macs(m: dict) -> int:
    return m["d_model"] * m["vocab"]


def attention_flops(m: dict, keys_seen: int) -> int:
    """Causal attention of queries that together see ``keys_seen`` keys, all layers."""
    mixers = Counter(mixer for mixer, _ in layer_seq(m))
    return keys_seen * sum(n * layers.load(mixer).key_flops(m) for mixer, n in mixers.items())


def prefill(m: dict, batch: int, prompt_len: int) -> int:
    """A prefill of ``batch`` prompts; logits at the last position only."""
    keys = batch * prompt_len * (prompt_len + 1) // 2
    return 2 * batch * prompt_len * body_macs(m) + 2 * batch * head_macs(m) + attention_flops(m, keys)


def decode_step(m: dict, batch: int, kv_len: int) -> int:
    """One decode step of ``batch`` sequences whose new token sees ``kv_len`` keys."""
    return 2 * batch * (body_macs(m) + head_macs(m)) + attention_flops(m, batch * kv_len)


def train_iteration(m: dict, batch: int, seq_len: int) -> int:
    """Forward and backward (twice the forward) over ``batch`` rows of
    ``seq_len``, logits at every position."""
    tokens = batch * seq_len
    keys = batch * seq_len * (seq_len + 1) // 2
    return 6 * tokens * (body_macs(m) + head_macs(m)) + 3 * attention_flops(m, keys)
