"""Paper §6 / Appendix B: the 1000 Genomes workflow end to end, on the PyTorch port.

The counterpart of ``examples/genomes_1000.py`` over ``repro_torch``: nine
locations, one chromosome (one instance), step bodies on tensors on the
device; runs on the ``threaded`` backend (one thread per location)
unoptimised and optimised, cross-checks the ``inprocess`` backend, reports
what the paper's optimisation saved, and prints the start of one
generated self-contained bundle (``repro_torch.exec.emit_location_source``).

Run: ``PYTHONPATH=src python examples/torch_genomes_1000.py`` (on ``cuda``;
``--device cpu`` for the CPU)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import swirl
from repro_torch.core.translate import genomes_1000
from repro_torch.exec import emit_location_source

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

# n individuals over a locations; m mutation_overlap / frequency steps over
# b / c locations — Table 1's shape, with m > b so R2 has work to do.
inst = genomes_1000(n=4, m=4, a=2, b=2, c=2)
print(f"locations: {sorted(inst.locations)}")

raw = swirl.trace(inst)
plan = raw.optimize()
stats = plan.stats
print(
    f"plan: {raw.system.total_actions()} actions, "
    f"{raw.system.comm_count()} comms; optimiser removed {stats.removed} "
    f"(local {stats.removed_local}, duplicate {stats.removed_duplicate})"
)

# Step bodies: individuals sort their chunk, individuals_merge averages,
# sifting filters, mutation_overlap / frequency reduce to statistics.
rng = np.random.default_rng(0)
init = {("l^d", d): torch.from_numpy(rng.random(4096)).to(device) for d in inst.g("l^d")}


def make_fns():
    fns = {}
    for s in inst.workflow.steps:
        outs = inst.out_data(s)
        if s == "s0":
            fns[s] = lambda i, outs=outs: {o: init[("l^d", o)] for o in outs}
        elif s.startswith("sI_"):
            fns[s] = lambda i, outs=outs: {
                o: torch.sort(list(i.values())[0]).values for o in outs
            }
        elif s == "sIM":
            fns[s] = lambda i, outs=outs: {
                o: torch.mean(torch.stack([i[k] for k in sorted(i)]), dim=0)
                for o in outs
            }
        elif s == "sSF":
            fns[s] = lambda i, outs=outs: {
                o: (lambda d: d[d > 0.5])(list(i.values())[0]) for o in outs
            }
        else:
            fns[s] = lambda i, outs=outs: {
                o: float(sum(torch.sum(v) for v in i.values())) for o in outs
            }
    return fns


for label, staged in (("unoptimised", raw), ("optimised", plan)):
    t0 = time.perf_counter()
    result = (
        staged.lower("threaded", timeout_s=60)
        .compile(make_fns())
        .run(initial_payloads=dict(init))
    )
    dt = time.perf_counter() - t0
    print(
        f"{label:12s}: {dt * 1e3:6.1f} ms, "
        f"{result.stats['sent']} messages"
    )

# Cross-check against the reduction-semantics (inprocess) backend.
result2 = (
    plan.lower("inprocess")
    .compile(make_fns())
    .run(initial_payloads=dict(init))
)
print(
    "sMO_1 statistic:",
    result2.location_data("l^MO_1").get("d^MO_1", "<reduced>"),
)

# Peek at one generated self-contained bundle (paper §5's compiler output),
# emitted straight from the per-location program IR.
program = plan.exec_program()["l^IM"]
print("\n--- generated bundle for l^IM (first 400 chars) ---")
print(emit_location_source(program)[:400])
