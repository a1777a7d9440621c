"""Payload-size and step-cost estimators for the scheduler.

A copy of ``repro/sched/estimate.py``.

The makespan simulator needs two numbers the SWIRL calculus deliberately
abstracts away: how many *bytes* each data element carries, and how long
each ``exec`` takes.  Both come in as pluggable models with layered sources:

* :class:`SizeModel` — explicit per-datum byte sizes, harvested from
  :class:`~repro_torch.core.compile.StepMeta.output_bytes` declarations
  (:meth:`SizeModel.from_step_metas`), measured from real payloads'
  ``nbytes`` (:meth:`SizeModel.from_payloads`), or derived from an assigned
  workload shape (:meth:`SizeModel.for_shape` — the same
  ``tokens × d_model × dtype`` activation-boundary model the reference's
  ``roofline/analytic.py`` uses for HBM traffic).
* :class:`CostModel` — per-step execution seconds, harvested from
  :class:`~repro_torch.core.compile.StepMeta.expected_seconds` (the same hint the
  runtime's straggler speculation consumes).

Unknown entries fall back to defaults, so a schedule can always be computed;
better estimates just make it better.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field, replace
from typing import Any, Mapping

from repro_torch.core.compile import StepMeta


@dataclass(frozen=True)
class SizeModel:
    """Bytes carried by each data element (``default_bytes`` otherwise)."""

    default_bytes: int = 1024
    sizes: Mapping[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "sizes", {d: int(n) for d, n in dict(self.sizes).items()}
        )

    def bytes_of(self, data: str) -> int:
        return self.sizes.get(data, self.default_bytes)

    def updated(self, sizes: Mapping[str, int]) -> "SizeModel":
        return replace(self, sizes={**self.sizes, **dict(sizes)})

    @classmethod
    def from_step_metas(
        cls,
        metas: Mapping[str, StepMeta | Any],
        *,
        default_bytes: int = 1024,
    ) -> "SizeModel":
        """Harvest ``StepMeta.output_bytes`` declarations from a registry."""
        sizes: dict[str, int] = {}
        for meta in metas.values():
            if isinstance(meta, StepMeta) and meta.output_bytes:
                sizes.update(
                    {d: int(n) for d, n in meta.output_bytes.items()}
                )
        return cls(default_bytes=default_bytes, sizes=sizes)

    @classmethod
    def from_payloads(
        cls,
        payloads: Mapping[Any, Any],
        *,
        default_bytes: int = 1024,
    ) -> "SizeModel":
        """Measure real payloads: ``(location, datum) -> value`` or
        ``datum -> value`` maps; arrays report ``nbytes``, everything else
        ``sys.getsizeof``."""
        sizes: dict[str, int] = {}
        for key, value in payloads.items():
            d = key[1] if isinstance(key, tuple) else key
            nb = getattr(value, "nbytes", None)
            sizes[d] = int(nb) if nb is not None else sys.getsizeof(value)
        return cls(default_bytes=default_bytes, sizes=sizes)

    @classmethod
    def for_shape(
        cls,
        shape,
        *,
        d_model: int | None = None,
        cfg=None,
        dtype_bytes: int = 2,
        sizes: Mapping[str, int] | None = None,
    ) -> "SizeModel":
        """Default every datum to one activation boundary of ``shape``.

        ``shape`` is a :class:`repro_torch.configs.shapes.Shape` or a name from
        :data:`repro_torch.configs.shapes.SHAPES`; the boundary is
        ``tokens × d_model × dtype_bytes`` with ``tokens`` counted as in
        the reference's ``roofline/analytic.py::analytic_flops_global`` (decode moves
        one row per sequence).  ``d_model`` comes from ``cfg`` (a
        :class:`repro_torch.models.config.ModelConfig`) when not given directly.
        """
        from repro_torch.configs.shapes import SHAPES, Shape

        if isinstance(shape, str):
            shape = SHAPES[shape]
        if not isinstance(shape, Shape):
            raise TypeError(f"not a shape: {shape!r}")
        if d_model is None:
            if cfg is None:
                raise TypeError("for_shape needs d_model= or cfg=")
            d_model = cfg.d_model
        tokens = (
            shape.global_batch
            if shape.kind == "decode"
            else shape.seq_len * shape.global_batch
        )
        return cls(
            default_bytes=int(tokens * d_model * dtype_bytes),
            sizes=sizes or {},
        )


@dataclass(frozen=True)
class CostModel:
    """Execution seconds per step (``default_exec_s`` otherwise)."""

    default_exec_s: float = 1e-3
    costs: Mapping[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "costs", {s: float(c) for s, c in dict(self.costs).items()}
        )

    def exec_s(self, step: str) -> float:
        return self.costs.get(step, self.default_exec_s)

    def updated(self, costs: Mapping[str, float]) -> "CostModel":
        return replace(self, costs={**self.costs, **dict(costs)})

    @classmethod
    def from_step_metas(
        cls,
        metas: Mapping[str, StepMeta | Any],
        *,
        default_exec_s: float = 1e-3,
    ) -> "CostModel":
        """Harvest ``StepMeta.expected_seconds`` hints from a registry."""
        costs = {
            name: float(meta.expected_seconds)
            for name, meta in metas.items()
            if isinstance(meta, StepMeta) and meta.expected_seconds is not None
        }
        return cls(default_exec_s=default_exec_s, costs=costs)

    @classmethod
    def from_profile(
        cls,
        profile: Any,
        *,
        default_exec_s: float = 1e-3,
    ) -> "CostModel":
        """Calibrate per-step costs from a measured run.

        ``profile`` is a :class:`repro_torch.obs.RunProfile` (anything with an
        ``exec_durations() -> {step: [seconds, ...]}`` method) or a plain
        mapping ``step -> seconds`` / ``step -> [seconds, ...]``.  Each
        step's cost becomes the mean of its measured exec-span durations,
        closing the loop between the simulator's guesses and what a
        backend actually did.
        """
        if hasattr(profile, "exec_durations"):
            samples: Mapping[str, Any] = profile.exec_durations()
        elif isinstance(profile, Mapping):
            samples = profile
        else:
            raise TypeError(
                "from_profile needs a RunProfile or a mapping, got "
                f"{type(profile).__name__}"
            )
        costs: dict[str, float] = {}
        for step, val in samples.items():
            if isinstance(val, (int, float)):
                costs[step] = float(val)
            else:
                vals = [float(v) for v in val]
                if vals:
                    costs[step] = sum(vals) / len(vals)
        return cls(default_exec_s=default_exec_s, costs=costs)
