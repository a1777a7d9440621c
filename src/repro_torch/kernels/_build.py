"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch/`` at the root of the checkout.  The
library's file name carries a hash of its source, of every header in
``csrc/`` and of the compiler flags, so an edited kernel or header is rebuilt
and a stale library is never loaded.  :func:`build` compiles several
kernels in parallel, one ``nvcc`` process each.

This module is also the kernels' registry: :data:`KERNELS` names each
kernel once, an :class:`Entry` binds one entry point of a library and
launches it, and :data:`launches` counts each kernel's calls under one lock
(read through ``ops.launch_counts``).  :func:`stand_in` is what a kernel's
wrapper does with a tensor off the card.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on a machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "mla_decode", "moe_slots")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)

# Codes of csrc/common.cuh's rt::Dtype.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()

# Calls of each kernel since the last reset (what counts: ``ops``), under one
# lock: the ``inprocess`` backend fires the trainer's pods on threads at once.
launches = dict.fromkeys(KERNELS, 0)
launch_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build or to launch.

    Its own class so that a caller that recovers from other errors (the
    data plane falls back from a body that cannot be captured into a CUDA
    graph) lets this one through.
    """

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, all at once.

    Returns the seconds each build took (0.0 for one already built).  The
    compiler's output, ``-Xptxas -v`` included, is kept beside the library
    as ``<name>.log``.  Raises :class:`KernelError` naming every failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: lib_path(n) for n in names if not lib_path(n).exists()}
    if not todo:
        return {n: 0.0 for n in names}
    nvcc = _nvcc()
    procs = {}
    t0 = time.monotonic()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    secs, failed = {n: 0.0 for n in names}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs)."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error_string")(rc).decode()
        raise KernelError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def count(name: str, n: int = 1) -> None:
    with launch_lock:
        launches[name] += n


class Entry:
    """One entry point of a kernel's library, bound with ``argtypes`` at its
    first call (the library built and loaded first if need be)."""

    def __init__(self, name: str, argtypes: list, symbol: str = ""):
        self.name, self.symbol, self.argtypes = name, symbol or f"{name}_launch", argtypes
        self._fn = None

    def fn(self):
        """The bare ctypes function, which returns the launch's CUDA error code."""
        if self._fn is None:
            lib = load(self.name)
            with _lock:
                if self._fn is None:
                    fn = getattr(lib, self.symbol)
                    fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
                    self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device`` with ``args`` (the stream among them), raise
        on an error, and count the call."""
        fn = self._fn or self.fn()
        if device.index == torch.cuda.current_device():
            rc = fn(*args)
        else:
            with torch.cuda.device(device):
                rc = fn(*args)
        check(self.name, rc)
        count(self.name)


def stand_in(name: str, x: torch.Tensor, plain, *args, **kw):
    """A kernel's call on a tensor ``x`` off the card: ``plain(*args, **kw)``
    on a CPU tensor, counted as the kernel's call where the switch sends
    ``x`` to a kernel (forced, as a CPU rehearsal of the card's counts does),
    unless its output is empty; any other device raises."""
    from . import ops  # the switch; ops imports this module

    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    forced = ops.use_kernel(x)
    out = plain(*args, **kw)
    if forced and (out[0] if isinstance(out, tuple) else out).numel():
        count(name)
    return out


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def scalar_arg(x, device: torch.device, what: str) -> tuple[int | None, int]:
    """A length or offset as (device pointer, host value) for a kernel.

    A device ``int32`` scalar tensor is passed by pointer, so the host never
    waits for it; a Python int is passed by value.
    """
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32 or x.numel() != 1 or x.device != device:
            raise ValueError(
                f"{what} must be a one-element int32 tensor on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        return x.data_ptr(), 0
    return None, int(x)
