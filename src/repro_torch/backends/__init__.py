"""The port's backend registry.

``Plan.lower(backend="...")`` resolves names through this registry.  It is
the port's own and holds two backends, ``inprocess`` (the reference
trainer's, checkpointable) and ``torch`` (places each location on a CUDA
device, fuses and traces); it never touches ``repro.backends``, whose
registry the reference's sweeps enumerate.
Factories are zero-argument callables returning a :class:`Backend`; they are
invoked lazily so registering a backend never imports its dependencies.
"""

from __future__ import annotations

from typing import Callable

from .base import (
    Backend,
    BackendCapabilityError,
    BackendProgram,
    ExecutionResult,
    UnknownBackendError,
)

__all__ = [
    "Backend",
    "BackendProgram",
    "BackendCapabilityError",
    "ExecutionResult",
    "UnknownBackendError",
    "register_backend",
    "get_backend",
    "available_backends",
]

BackendFactory = Callable[[], Backend]


def _builtin(module: str) -> BackendFactory:
    def load() -> Backend:
        import importlib

        return importlib.import_module(module).factory()

    return load


_REGISTRY: dict[str, BackendFactory] = {
    "inprocess": _builtin("repro_torch.backends.inprocess"),
    "torch": _builtin("repro_torch.backends.torch_backend"),
}


def register_backend(
    name: str, factory: BackendFactory, *, overwrite: bool = False
) -> None:
    """Register ``factory`` under ``name`` (in process)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"backend {name!r} is already registered")
    _REGISTRY[name] = factory


def get_backend(name: str) -> Backend:
    """Instantiate the backend registered under ``name``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None
    backend = factory()
    if not isinstance(backend, Backend):
        raise TypeError(
            f"backend factory for {name!r} returned {type(backend).__name__},"
            " not a repro_torch.backends.Backend"
        )
    return backend


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
