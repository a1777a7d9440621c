"""The port stands alone: it imports neither ``jax`` nor the JAX package, and
its entry points run on CUDA unless asked for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15  # every module of the port was imported


def test_chip_smoke_imports_no_jax():
    src = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro\n" not in src


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    from repro_torch.configs import get_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve("llama3.2-3b", smoke=True, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="is_available"):
        Model(get_config("llama3.2-3b", smoke=True))


def test_cli_defaults_to_cuda_and_raises_without_it():
    code = (
        "import sys, torch; torch.cuda.is_available = lambda: False; "
        "sys.argv = ['serve']; "
        "from repro_torch.launch.serve import main; main()"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "is_available() is False" in out.stderr
