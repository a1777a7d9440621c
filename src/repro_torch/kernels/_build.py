"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch/`` at the root of the checkout.  The
library's file name carries a hash of its source, of every header in
``csrc/`` and of the compiler flags, so an edited kernel or header is rebuilt
and a stale library is never loaded.  :func:`build` compiles several
kernels in parallel, one ``nvcc`` process each.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on a machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
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
KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)

# Codes of csrc/common.cuh's rt::Dtype.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()


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


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
