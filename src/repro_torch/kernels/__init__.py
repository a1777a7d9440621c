"""Hand-written CUDA kernels for Hopper (+ plain PyTorch versions in ref.py).

``rmsnorm``, ``flash_attention``, ``decode_attention``, ``mla_decode`` and
``moe_slots`` each hold one kernel's wrapper: its argument checks, its plan
and its launch.  ``_build`` is their registry: it names the five once, builds
and binds them, and counts their calls; ``ops`` holds the kernel-or-plain
switch, adapts the wrappers to the model's layout and reads the counts.
Each kernel is built from ``csrc/`` with ``nvcc`` at first use and loaded with
``ctypes``: importing this package builds nothing.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
