"""``repro_torch.swirl`` — the public name of the port's staged API.

Thin re-export of :mod:`repro_torch.api`, as ``repro.swirl`` is of
``repro.api``::

    from repro_torch import swirl

    result = (
        swirl.trace(edges, mapping=mapping)
        .optimize(("R1R2", "R3"))
        .lower("torch", fuse=True)        # platform="cpu" off the card
        .compile(step_fns)
        .run()
    )
"""

from .api import (  # noqa: F401
    AppliedRewrite,
    BisimCertificate,
    ConcurrentRunError,
    Executable,
    ExecutionResult,
    Lowered,
    Plan,
    clear_compile_cache,
    compile_cache_stats,
    trace,
)
from .backends import (  # noqa: F401
    available_backends,
    get_backend,
    register_backend,
)
from .sched import (  # noqa: F401
    CostModel,
    NetworkModel,
    ScheduleReport,
    SizeModel,
    simulate,
)

__all__ = [
    "trace",
    "Plan",
    "Lowered",
    "Executable",
    "ExecutionResult",
    "AppliedRewrite",
    "BisimCertificate",
    "ConcurrentRunError",
    "clear_compile_cache",
    "compile_cache_stats",
    "register_backend",
    "get_backend",
    "available_backends",
    "NetworkModel",
    "SizeModel",
    "CostModel",
    "ScheduleReport",
    "simulate",
]
