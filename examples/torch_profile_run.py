"""Observability on the PyTorch port: trace a scheduled run, diff it
against the simulator.

The counterpart of ``examples/profile_run.py`` over ``repro_torch``: the
1000 Genomes workflow is lowered to the ``threaded`` backend with
``trace=True``, its payloads tensors on the device, so the backend records
an exec/send/recv span for everything it does (an exec span ends once the
step's device work is done).  The resulting
:class:`repro_torch.obs.RunProfile` rides on the execution result:

* ``Plan.profile(result)`` aligns the recorded spans against the sched
  simulator's predicted timeline — per-step start drift, duration ratio,
  and achieved-vs-predicted cross-location bytes;
* ``CostModel.from_profile`` calibrates the simulator with the measured
  step durations, closing the predict → run → re-predict loop;
* ``profile.save_chrome_trace`` writes Chrome trace-event JSON, a
  per-location timeline with send→recv flow arrows for a trace viewer.

Run: ``PYTHONPATH=src python examples/torch_profile_run.py`` (on ``cuda``;
``--device cpu`` for the CPU, ``--out PATH`` for the trace's file)
"""

import argparse
import json

import numpy as np
import torch

from repro_torch import swirl
from repro_torch.core.translate import genomes_1000
from repro_torch.obs import validate_chrome_trace
from repro_torch.sched import CostModel, NetworkModel

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
ap.add_argument("--out", default="genomes_trace.json", help="the Chrome trace's file")
args = ap.parse_args()
device = args.device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

inst = genomes_1000(n=4, m=4, a=2, b=2, c=2)
rng = np.random.default_rng(0)
init = {("l^d", d): torch.from_numpy(rng.random(4096)).to(device) for d in inst.g("l^d")}


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


# 1. Schedule against a two-rack cost model, then lower with trace=True.
network = NetworkModel.preset("two-rack")
plan = swirl.trace(inst).optimize().schedule(network)
exe = plan.lower("threaded", trace=True, timeout_s=60).compile(make_fns())
result = exe.run(initial_payloads=dict(init))

# 2. The profile is attached to the result: spans + pipeline phases.
profile = result.profile
print(profile.summary())
print()

# 3. Predicted vs actual: align the spans against the simulator.
report = plan.profile(result, network=network)
print(report.summary())
print()

# 4. Calibrate the cost model from the measured run and re-predict.
calibrated = CostModel.from_profile(profile)
recal = plan.profile(result, network=network, costs=calibrated)
print(
    f"makespan predicted with default costs:    "
    f"{report.predicted_makespan * 1e3:8.2f} ms"
)
print(
    f"makespan predicted with measured costs:   "
    f"{recal.predicted_makespan * 1e3:8.2f} ms"
)
print(f"makespan actually measured:               "
      f"{report.actual_makespan * 1e3:8.2f} ms")

# 5. Export a Chrome trace and check it validates.
profile.save_chrome_trace(args.out)
with open(args.out) as f:
    validate_chrome_trace(json.load(f))
print(f"\nwrote {args.out} ({len(profile.spans)} spans)")
