"""Checkpoints in the reference's on-disk layout, readable by either package.

The port of ``repro.ckpt.checkpoint``.  One step directory::

    <dir>/step_000000123/
        manifest.json       # step, and each leaf's name, file, shape, dtype
        leaf_00000.npy      # one file per leaf, in JAX's leaf order

is written under ``.tmp_step_*`` and renamed into place once its manifest is
written, so a ``step_*`` directory without a manifest is an interrupted
write, which :func:`latest_step` ignores; the newest ``keep`` complete steps
are kept.  Leaf names are paths as ``jax.tree_util.tree_flatten_with_path``
spells them (:func:`repro_torch._bridge.tree_flatten_with_path`).  A bf16
tensor is stored as its ``uint16`` bits under the dtype name
``"bfloat16"``, as the reference stores it; which leaves are bf16 is read
from the tensor's dtype.  :func:`load_checkpoint` returns host numpy arrays
with bf16 leaves as ``uint16`` views (the :mod:`repro_torch._bridge`
convention), ready for ``to_torch`` or ``params_from_jax``.  The other
exotic dtypes the reference names (float8) have no tensor here yet.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch._bridge import to_numpy, tree_flatten_with_path, tree_unflatten

PyTree = Any


def _host_leaves(tree: PyTree) -> list[tuple[str, np.ndarray, str]]:
    """``[(name, host array, dtype name)]``: a snapshot of every leaf."""
    out = []
    for name, leaf in tree_flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            dtype = "bfloat16" if leaf.dtype == torch.bfloat16 else None
            arr = to_numpy(leaf)
        else:
            arr, dtype = np.array(leaf), None
        out.append((name, arr, dtype or arr.dtype.name))
    return out


def save_checkpoint(directory: str | Path, step: int, tree: PyTree, *, keep: int = 3) -> Path:
    """Synchronous save; returns the step directory."""
    return _write(Path(directory), step, _host_leaves(tree), keep=keep)


def _write(root: Path, step: int, leaves: list, *, keep: int) -> Path:
    sdir = root / f"step_{step:09d}"
    tmp = root / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype_name) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if sdir.exists():
        shutil.rmtree(sdir)
    tmp.rename(sdir)  # atomic commit
    _gc(root, keep)
    return sdir


def _gc(root: Path, keep: int) -> None:
    steps = sorted(
        (p for p in root.glob("step_*") if (p / "manifest.json").exists()),
        key=lambda p: p.name,
    )
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> int | None:
    root = Path(directory)
    if not root.exists():
        return None
    best = None
    for p in root.glob("step_*"):
        if not (p / "manifest.json").exists():
            continue  # interrupted write
        m = re.match(r"step_(\d+)", p.name)
        if m:
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def load_checkpoint(directory: str | Path, step: int, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (leaves matched by name) as host
    numpy arrays; a ``"bfloat16"`` leaf comes back as its ``uint16`` bits."""
    sdir = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((sdir / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}
    names = [n for n, _ in tree_flatten_with_path(like)]
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(f"checkpoint is missing leaves: {missing[:5]} ...")
    leaves = []
    for name in names:
        entry = by_name[name]
        arr = np.load(sdir / entry["file"])
        if entry["dtype"] == "bfloat16" and arr.dtype != np.uint16:
            raise ValueError(f"leaf {name!r} is bfloat16 but stored as {arr.dtype}")
        leaves.append(arr)
    return tree_unflatten(like, leaves)


class async_save:
    """Snapshot now, write in the background; ``wait()`` to join.

    Usage::

        saver = async_save(dir, step, {"params": params, "opt": opt})
        ...next train step...
        saver.wait()
    """

    def __init__(self, directory: str | Path, step: int, tree: PyTree, *, keep: int = 3):
        # Device→host copy happens synchronously (consistent snapshot)…
        leaves = _host_leaves(tree)
        self.result: Path | None = None
        self._exc: BaseException | None = None

        def work():
            try:
                self.result = _write(Path(directory), step, leaves, keep=keep)
            except BaseException as e:  # noqa: BLE001  (re-raised by wait())
                self._exc = e

        # …the serialisation/IO overlaps the next step.
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self, timeout: float | None = None) -> Path:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"checkpoint write still running after {timeout} s")
        if self._exc is not None:
            raise self._exc
        assert self.result is not None
        return self.result
