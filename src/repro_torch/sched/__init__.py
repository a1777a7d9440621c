"""``repro_torch.sched`` — cost-model-driven placement & data-movement scheduling.

A copy of ``repro/sched``: the same searches in the same order, so
placements, makespans and bytes equal the reference's.

The layer between ``Plan`` and ``Lowered``: SWIRL's rewriting (R1-R3)
deletes *redundant* communications, this subsystem decides *where steps run*
so that communications become redundant in the first place.

Pieces:

* :class:`NetworkModel` / :class:`Link` — per-location-pair bandwidth and
  latency, with named presets (``uniform``, ``two-rack``,
  ``cpu+accelerator``);
* :class:`SizeModel` / :class:`CostModel` — payload byte-sizes and step
  exec-seconds, harvested from :class:`~repro_torch.core.compile.StepMeta`, real
  payloads, or assigned workload shapes;
* :func:`simulate` — replay a plan's traces against the cost model:
  per-location timelines, makespan, critical path, cross-location bytes;
* :func:`auto_placement` (+ :func:`greedy_placement`,
  :func:`refine_placement`, :func:`round_robin_placement`) — critical-path
  greedy placement with local-search refinement, reported as a
  :class:`ScheduleReport`.

Front door: ``plan.schedule(network=NetworkModel.preset("two-rack"))`` or
``plan.lower(backend, placement="auto", network=...)``.
"""

from .estimate import CostModel, SizeModel
from .incremental import PlacementScorer, UnsupportedRules
from .network import LOCAL_LINK, Link, NetworkModel
from .place import (
    auto_placement,
    evaluate_placement,
    greedy_placement,
    movable_steps,
    refine_placement,
    round_robin_placement,
)
from .report import ScheduleReport
from .simulate import SimEvent, Simulation, SimulationError, simulate

__all__ = [
    "Link",
    "LOCAL_LINK",
    "NetworkModel",
    "SizeModel",
    "CostModel",
    "simulate",
    "Simulation",
    "SimEvent",
    "SimulationError",
    "auto_placement",
    "greedy_placement",
    "refine_placement",
    "round_robin_placement",
    "evaluate_placement",
    "movable_steps",
    "PlacementScorer",
    "UnsupportedRules",
    "ScheduleReport",
]
