"""Quickstart on the PyTorch port: a 5-step DAG through the staged pipeline.

The counterpart of ``examples/quickstart.py`` over ``repro_torch``:
``swirl.trace`` encodes the DAG into a SWIRL plan, ``.optimize()`` applies
the paper's rewriting rules (with a machine-checked bisimulation
certificate), ``.lower(backend)`` picks an execution target by name, and
``.compile(steps).run()`` executes it.  The step bodies make tensors on the
device, and the same plan runs on the port's three backends with identical
results: ``inprocess`` and ``threaded`` leave each tensor where its step put
it, ``torch`` places each location on the device.

Run: ``PYTHONPATH=src python examples/torch_quickstart.py`` (on ``cuda``;
``--device cpu`` for the CPU)
"""

import argparse

import torch

from repro_torch import swirl

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

# 1. Describe the workflow: preprocess fans out to two trainers, whose
#    outputs meet in an evaluation step; a report consumes the evaluation.
edges = {
    "preprocess": ["train_a", "train_b"],
    "train_a": ["evaluate"],
    "train_b": ["evaluate"],
    "evaluate": ["report"],
    "report": [],
}
mapping = {
    "preprocess": ("cpu0",),
    "train_a": ("gpu0",),
    "train_b": ("gpu1",),
    "evaluate": ("gpu0",),  # co-located with train_a → R1 kicks in
    "report": ("cpu0",),
}

# 2. trace → Plan, then optimise with the paper's ⟦·⟧ rewriting.  The
#    certificate is Thm. 1 checked mechanically: plan ≈ optimised plan.
plan = swirl.trace(edges, mapping=mapping).optimize(certify=True)
print(plan.explain())

# 3. Attach step bodies, lower to a backend by name, and run.
step_fns = {
    "preprocess": lambda inp: {"d^preprocess": torch.arange(10, device=device)},
    "train_a": lambda inp: {"d^train_a": inp["d^preprocess"].sum()},
    "train_b": lambda inp: {"d^train_b": inp["d^preprocess"].max()},
    "evaluate": lambda inp: {"d^evaluate": inp["d^train_a"] + inp["d^train_b"]},
    # sink step: no output ports — the score stays in cpu0's data scope
    "report": lambda inp: {},
}

for backend in ("inprocess", "threaded", "torch"):
    options = {"platform": "cpu"} if backend == "torch" and device == "cpu" else {}
    result = plan.lower(backend, **options).compile(step_fns).run()
    score = result.payload("cpu0", "d^evaluate")
    assert score.device.type == device
    print(f"{backend:>10}: score = {int(score)}")
    assert int(score) == 54  # identical on every backend (bisimulation!)

print("OK")
