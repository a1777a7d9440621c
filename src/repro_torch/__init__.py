"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, for an NVIDIA H100.

It mirrors the JAX package's module names (``models``, ``configs``,
``kernels``, ``launch``, ``optim``, ``ckpt``, ``data``, and SWIRL's own
``core``, ``exec``, ``backends``, ``api`` and ``swirl``) and imports nothing of it, nor ``jax``: what it needs
of a JAX-free module it keeps as its own copy.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; asking for ``cuda`` on a machine
without one raises.  Every TPU kernel of the reference is a hand-written
CUDA kernel here (:mod:`repro_torch.kernels`).

Subpackages are imported lazily, so ``import repro_torch`` stays cheap.
"""

from importlib import import_module

__version__ = "0.1.0"

_SUBMODULES = (
    "api",
    "backends",
    "ckpt",
    "configs",
    "core",
    "data",
    "exec",
    "kernels",
    "launch",
    "models",
    "optim",
    "swirl",
    "workflow",
)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
