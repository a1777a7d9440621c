"""Cost-model-driven placement on the 1000 Genomes workflow, on the PyTorch port.

The counterpart of ``examples/schedule_placement.py`` over ``repro_torch``:
a two-rack network cost model, the makespan simulator, and
``Plan.schedule`` / ``placement="auto"`` lowering — the scheduler
co-locates producers with consumers, the R1/R2 rewrite then deletes the
now-local communications, and the ``threaded`` backend moves measurably
fewer messages.  The payloads are tensors on the device.

Run: ``PYTHONPATH=src python examples/torch_schedule_placement.py`` (on
``cuda``; ``--device cpu`` for the CPU)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import swirl
from repro_torch.core.translate import genomes_1000
from repro_torch.sched import CostModel, NetworkModel, SizeModel, simulate

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

inst = genomes_1000(n=4, m=4, a=2, b=2, c=2)
network = NetworkModel.preset("two-rack")
sizes = SizeModel(default_bytes=8 * 65536)  # 64k-float arrays
costs = CostModel(default_exec_s=2e-3)

plan = swirl.trace(inst).optimize()
print("== original placement ==")
sim = simulate(plan.system, network=network, sizes=sizes, costs=costs,
               exec_slots=1)
print(sim.summary())

print("\n== scheduled (two-rack, makespan objective) ==")
sched = plan.schedule(network, sizes=sizes, costs=costs)
print(sched.schedule_report.summary())

# Run both on the threaded backend and compare real message counts.
rng = np.random.default_rng(0)
init = {("l^d", d): torch.from_numpy(rng.random(65536)).to(device) for d in inst.g("l^d")}


def make_fns():
    fns = {}
    for s in inst.workflow.steps:
        outs = inst.out_data(s)
        if s == "s0":
            fns[s] = lambda i, outs=outs: {o: init[("l^d", o)] for o in outs}
        else:
            fns[s] = lambda i, outs=outs: {
                o: sum(torch.sum(v) for v in i.values()) for o in outs
            }
    return fns


for label, p in (("original", plan), ("scheduled", sched)):
    t0 = time.perf_counter()
    result = (
        p.lower("threaded", timeout_s=60)
        .compile(make_fns())
        .run(initial_payloads=dict(init))
    )
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(
        f"{label:10s}: {dt * 1e3:6.1f} ms wall, "
        f"{result.stats['sent']} messages, "
        f"{p.system.comm_count()} comms planned"
    )
