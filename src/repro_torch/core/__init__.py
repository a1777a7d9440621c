"""SWIRL core — the plan machinery, copied from ``repro.core``.

The port keeps its own copy of every JAX-free module it runs (it imports
nothing of :mod:`repro`):

* :mod:`~repro_torch.core.graph`     — workflow / distributed-workflow models (§2)
* :mod:`~repro_torch.core.syntax`    — the SWIRL calculus terms (§3, Def. 8)
* :mod:`~repro_torch.core.encoding`  — ``⟦·⟧ : W_I → W_W`` (§3.2, Defs. 10-12)
* :mod:`~repro_torch.core.flat`      — the flat IR and its single-pass rewrites
* :mod:`~repro_torch.core.optimizer` — rewriting rules ``⟦·⟧ : W_W → W_O`` (§4, Def. 15)
* :mod:`~repro_torch.core.parser`    — ``.swirl`` surface syntax (§5)
* :mod:`~repro_torch.core.translate` — front-end translators incl. 1000 Genomes (§5-6)
* :mod:`~repro_torch.core.compile`   — the step metadata model
* :mod:`~repro_torch.core.semantics` — reduction semantics, Figs. 2-3 (LTS)
* :mod:`~repro_torch.core.bisim`     — weak barbed bisimulation (Def. 16 / Thm. 1),
  behind ``Plan.certify``
"""

from .graph import (
    DistributedWorkflow,
    DistributedWorkflowInstance,
    Workflow,
    WorkflowInstance,
    make_workflow,
)
from .syntax import (
    NIL,
    Exec,
    LocationConfig,
    Nil,
    Par,
    Recv,
    Send,
    Seq,
    Trace,
    WorkflowSystem,
    config,
    congruent,
    normalize,
    par,
    seq,
    system,
)
from .semantics import (
    CommTransition,
    ExecTransition,
    RunResult,
    apply_transition,
    barbs,
    enabled_transitions,
    reachable_states,
    run,
)
from .encoding import building_block, encode, encode_flat
from .flat import (
    FLAT_RULES,
    FlatConfig,
    FlatSystem,
    FlatTrace,
    flatten_trace,
    rewrite_flat_pipeline,
)
from .optimizer import (
    REWRITE_RULES,
    REWRITE_RULES_TREE,
    OptimizationStats,
    rewrite_spatial,
    rewrite_spatial_tree,
    rewrite_system,
    rewrite_system_tree,
)
from .bisim import weak_barbed_bisimilar
from .parser import dumps, loads, parse_system, parse_trace
from .translate import (
    DagTranslator,
    PipelineTranslator,
    SWIRLTranslator,
    TrainPipelineTranslator,
    genomes_1000,
)
from .compile import Channel, StepFn, StepMeta

__all__ = [
    "Workflow",
    "WorkflowInstance",
    "DistributedWorkflow",
    "DistributedWorkflowInstance",
    "make_workflow",
    "NIL",
    "Nil",
    "Exec",
    "Send",
    "Recv",
    "Seq",
    "Par",
    "Trace",
    "LocationConfig",
    "WorkflowSystem",
    "config",
    "system",
    "seq",
    "par",
    "normalize",
    "congruent",
    "run",
    "RunResult",
    "barbs",
    "enabled_transitions",
    "apply_transition",
    "reachable_states",
    "ExecTransition",
    "CommTransition",
    "encode",
    "encode_flat",
    "building_block",
    "FLAT_RULES",
    "FlatTrace",
    "FlatConfig",
    "FlatSystem",
    "flatten_trace",
    "rewrite_flat_pipeline",
    "rewrite_system",
    "rewrite_system_tree",
    "rewrite_spatial",
    "rewrite_spatial_tree",
    "REWRITE_RULES",
    "REWRITE_RULES_TREE",
    "OptimizationStats",
    "weak_barbed_bisimilar",
    "parse_system",
    "parse_trace",
    "dumps",
    "loads",
    "SWIRLTranslator",
    "DagTranslator",
    "TrainPipelineTranslator",
    "PipelineTranslator",
    "genomes_1000",
    "StepFn",
    "StepMeta",
    "Channel",
]
