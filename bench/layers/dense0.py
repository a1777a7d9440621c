"""DeepSeek's dense layer 0: the dense MLP (its width is ``d_ff``)."""

from .mlp import leaves, macs  # noqa: F401
