"""Hand-written CUDA kernels for Hopper (+ plain PyTorch versions in ref.py).

``rmsnorm``, ``flash_attention`` and ``decode_attention`` each hold one
kernel's wrapper and launch count; ``ops`` adapts them to the model's layout.
Each kernel is built from ``csrc/`` with ``nvcc`` at first use and loaded with
``ctypes``: importing this package builds nothing.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
