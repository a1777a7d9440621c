"""ZeRO-1: shard optimizer moments over the data axis.

The port of ``repro.optim.zero``.  Params are TP-sharded (their spec uses
the ``model`` axis); AdamW moments are element-wise state, so each may
*additionally* be sharded over ``data``, the classic ZeRO-1 memory split.
``zero1_specs`` augments each param spec: the first dimension that (a) is
unsharded and (b) divides the data-axis size takes ``"data"``.  Placed with
these specs (``launch.sharding.distribute_params``), the moments update
sharded, and DTensor gathers the param delta over ``data`` where it meets
the param.
"""

from __future__ import annotations

from typing import Any

from repro_torch.launch.sharding import PartitionSpec as P

PyTree = Any


def _augment(spec: P, shape: tuple[int, ...], data_axis: str, data_size: int) -> P:
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % data_size == 0 and dim >= data_size:
            parts[i] = data_axis
            return P(*parts)
    return P(*parts)  # nothing divisible — leave as the param spec


def zero1_specs(
    param_specs: PyTree,
    param_shapes: PyTree,
    *,
    data_axis: str = "data",
    data_size: int = 1,
) -> PyTree:
    """PartitionSpecs for AdamW m/v given the param specs and shapes.

    ``param_shapes`` has the specs' structure down to each spec's place,
    where it holds anything with ``.shape`` (a tensor, on ``meta`` too) or a
    shape tuple."""

    def walk(spec, shape):
        if isinstance(spec, P):
            return _augment(spec, tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape),
                            data_axis, data_size)
        if isinstance(spec, dict):
            return {k: walk(v, shape[k]) for k, v in spec.items()}
        if isinstance(spec, (list, tuple)):
            return type(spec)(walk(v, s) for v, s in zip(spec, shape, strict=True))
        if spec is None:
            return None
        raise TypeError(f"not a spec tree: {type(spec).__name__}")

    return walk(param_specs, param_shapes)
