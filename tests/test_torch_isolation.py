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
print(" ".join(names))
assert not bad, bad
import os, torch.distributed as dist
assert not dist.is_initialized(), "an import started a process group"
assert "XLA_FLAGS" not in os.environ, "an import set XLA_FLAGS"
"""

# The training slice's modules, which the walk above must reach.
TRAINING = (
    "repro_torch.launch.train", "repro_torch.launch.steps", "repro_torch.optim.adamw",
    "repro_torch.optim.compress", "repro_torch.ckpt.checkpoint", "repro_torch.data.pipeline",
    "repro_torch.models.convert",
)
# The MoE slice's modules, which it must reach too.
MOE = (
    "repro_torch.models.moe", "repro_torch.configs.granite_moe_1b_a400m",
    "repro_torch.configs.deepseek_moe_16b",
)

# The recurrent slice's modules, which it must reach too.
RECURRENT = (
    "repro_torch.models.recurrent", "repro_torch.configs.xlstm_125m",
    "repro_torch.configs.jamba_v0_1_52b",
)

# The other families' configs (the A6 slice), which it must reach too.
FAMILIES = (
    "repro_torch.configs.gemma2_27b", "repro_torch.configs.nemotron_4_15b",
    "repro_torch.configs.qwen1_5_110b", "repro_torch.configs.internvl2_1b",
    "repro_torch.configs.seamless_m4t_medium",
)

# The inprocess backend and the modules it runs on (the training slice on the
# card lowers to it), which it must reach too.
INPROCESS = ("repro_torch.workflow.runtime", "repro_torch.exec.central", "repro_torch.backends.inprocess")

# The distribution slice's modules (mesh, specs, ZeRO-1, hints), which it must reach too.
DISTRIBUTION = ("repro_torch.launch.mesh", "repro_torch.launch.sharding", "repro_torch.optim.zero",
                "repro_torch.models.hints")

# The dry-run and roofline slice's modules (A8), which it must reach too.
DRYRUN = ("repro_torch.launch.dryrun", "repro_torch.roofline", "repro_torch.roofline.analysis",
          "repro_torch.roofline.analytic", "repro_torch.roofline.collectives", "repro_torch.roofline.counting",
          "repro_torch.roofline.report")

# The threaded backend's slice: its wire, the bundle layer and the legacy
# oracles, which it must reach too.
THREADED = ("repro_torch._compat", "repro_torch.core.compile", "repro_torch.exec.emit",
            "repro_torch.workflow.channels", "repro_torch.workflow.transport",
            "repro_torch.workflow.threaded", "repro_torch.workflow.runtime",
            "repro_torch.backends.threaded_backend")

# The multiprocess backend's slice: elastic recovery, the random instance
# generator and the serving layer, which it must reach too.
MULTIPROCESS = ("repro_torch.backends.multiprocess", "repro_torch.exec.elastic",
                "repro_torch.workflow.elastic", "repro_torch.core.randgen", "repro_torch.serve",
                "repro_torch.serve.admission", "repro_torch.serve.cache", "repro_torch.serve.client",
                "repro_torch.serve.gateway", "repro_torch.serve.service", "repro_torch.serve.submission")


def test_port_imports_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15  # every module of the port was imported
    imported = set(out.stdout.splitlines()[1].split())
    walked = set(TRAINING + MOE + RECURRENT + FAMILIES + INPROCESS + DISTRIBUTION + DRYRUN + THREADED
                 + MULTIPROCESS)
    assert walked <= imported, sorted(walked - imported)


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
