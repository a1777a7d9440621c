"""Model FLOPs of a prefill, a decode step and a training iteration.

Model FLOPs count the work the model defines, two a multiply-add: every
weight product of a token (attention projections, the dense MLP or, in a
MoE layer, the router, the ``top_k`` routed experts and the shared ones,
whether or not capacity drops a choice), the LM head where logits are
taken, and causal attention (a query at position ``p`` scores and sums
``p + 1`` keys: ``4 H hd (p + 1)``).  Capacity padding, recompute and
elementwise work are not counted.  ``m`` is a configuration's ``model``
section.
"""

from __future__ import annotations


def layer_seq(m: dict) -> list[tuple[str, str]]:
    """Each layer's ``(mixer, ffn)``: the prefix, then the pattern repeated."""
    prefix = [tuple(k) for k in m.get("prefix_pattern", [])]
    pattern = [tuple(k) for k in m["pattern"]]
    return prefix + pattern * ((m["n_layers"] - len(prefix)) // len(pattern))


def body_macs(m: dict) -> int:
    """Multiply-adds of one token's weight products below the LM head."""
    d, hd = m["d_model"], m["head_dim"]
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    total = 0
    for mixer, ffn in layer_seq(m):
        total += d * qd + 2 * d * kvd + qd * d
        if ffn in ("mlp", "dense0"):
            total += 3 * d * m["d_ff"]
        elif ffn == "moe":
            moe = m["moe"]
            total += d * moe["n_experts"] + (moe["top_k"] + moe.get("n_shared", 0)) * 3 * d * moe["d_expert"]
    return total


def head_macs(m: dict) -> int:
    return m["d_model"] * m["vocab"]


def attention_flops(m: dict, keys_seen: int) -> int:
    """Causal attention of queries that together see ``keys_seen`` keys, all layers."""
    return 4 * m["n_heads"] * m["head_dim"] * keys_seen * len(layer_seq(m))


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
