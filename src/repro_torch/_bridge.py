"""numpy ↔ torch, trees, and the choice of device.

bf16 travels between the packages as a ``uint16`` view of its bits (as the
reference's checkpoints store it), so the port never needs ``ml_dtypes``: a
``uint16`` array handed to :func:`to_torch` is read as bf16, and a bf16
tensor leaves :func:`to_numpy` as ``uint16``.  The port keeps no ``uint16``
data of its own, so the convention is unambiguous.

Trees are nested dicts, lists, tuples and NamedTuples with ``None`` as an
empty subtree, as in ``jax.tree_util``.  :func:`tree_flatten_with_path`
walks them in JAX's order (dict keys sorted, sequences by index,
NamedTuples by field) and names each leaf by its path as
``jax.tree_util.tree_flatten_with_path`` does, so that the checkpoints of
the two packages carry the same leaf names in the same order.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """A copy of ``a`` on ``device``; ``uint16`` (or a bf16 array) → bf16.

    A tensor is copied as it is, dtype and all."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
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


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of nested dicts, lists, tuples and
    NamedTuples; a NamedTuple keeps its class."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_flatten_with_path(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``[(name, leaf)]`` in JAX's leaf order; ``name`` joins the path's
    keys, indices and field names with ``/`` (``decoder/body/0/mixer/q/w``)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [("/".join(prefix), tree)]
    return [kv for k, v in items for kv in tree_flatten_with_path(v, prefix + (k,))]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in JAX's order, by ``leaves``."""
    it = iter(leaves)
    end = object()

    def build(t):
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}  # the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, list):
            return [build(v) for v in t]
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        if t is None:
            return None
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the tree has")
        return leaf

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
