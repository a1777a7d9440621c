"""numpy ↔ torch, tree mapping, and the choice of device.

bf16 travels between the packages as a ``uint16`` view of its bits (as the
reference's checkpoints store it), so the port never needs ``ml_dtypes``: a
``uint16`` array handed to :func:`to_torch` is read as bf16, and a bf16
tensor leaves :func:`to_numpy` as ``uint16``.  The port keeps no ``uint16``
data of its own, so the convention is unambiguous.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """A copy of ``a`` on ``device``; ``uint16`` (or a bf16 array) → bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array, e.g. np.asarray(jax_array)
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.tensor(a).to(device)  # torch.tensor copies: no aliasing of `a`


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 → its ``uint16`` bits."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
