"""Deprecation plumbing for the legacy (pre-staged-API) entry points.

A copy of the deprecation half of ``repro/_compat.py`` (the JAX-version
shims are the reference's alone).  The staged pipeline
(:mod:`repro_torch.api`) is the single front door to the toolchain; the
historical bundle layer (``compile_bundles``, ``emit_python_source``,
``emit_all``) and direct construction of the legacy runtimes
(``ThreadedRuntime``, ``Runtime``) keep working but emit
:class:`DeprecationWarning`.  The backends themselves reuse the same building
blocks, so they run under :func:`suppress_deprecations` — a user going
through ``swirl.trace(...).lower(...).compile(...)`` never sees a warning for
machinery the pipeline drives on their behalf.
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager

_state = threading.local()


def _suppressed() -> bool:
    return getattr(_state, "depth", 0) > 0


@contextmanager
def suppress_deprecations():
    """Mark legacy calls made on behalf of the staged pipeline as internal."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def warn_legacy(old: str, new: str, *, stacklevel: int = 3) -> None:
    """Emit the standard deprecation message unless inside the pipeline."""
    if _suppressed():
        return
    warnings.warn(
        f"{old} is deprecated; use the staged API instead: {new}",
        DeprecationWarning,
        stacklevel=stacklevel,
    )
