"""Pipeline parallelism as a SWIRL plan, on the PyTorch port.

The counterpart of ``examples/pipeline_parallel.py`` over ``repro_torch``.
The pipeline-stage graph (stages × microbatches) is a distributed workflow
instance; the encoding derives each stage's trace, and the stage-to-stage
send/recv pairs are what a stage mesh axis would carry.  The plan runs on
the ``inprocess`` backend with each stage's MLP block on the device, and
prints the 1F1B-like schedule that falls out of SWIRL reduction order — no
scheduler was written, the dataflow is the schedule.

Run: ``PYTHONPATH=src python examples/torch_pipeline_parallel.py`` (on
``cuda``; ``--device cpu`` for the CPU)
"""

import argparse

import torch

from repro_torch import swirl
from repro_torch.core.translate import PipelineTranslator

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

N_STAGES, N_MICRO = 4, 3
D = 64

translator = PipelineTranslator(n_stages=N_STAGES, n_microbatches=N_MICRO)
plan = swirl.trace(translator).optimize()
inst = plan.instance
print(f"pipeline plan: {plan.system.total_actions()} actions, "
      f"{plan.system.comm_count()} comms (removed {plan.stats.removed})")
print(plan.system["stage1"].pretty()[:200], "…\n")

# Stage bodies: each stage applies its own MLP block, weights from a seed.
gen = torch.Generator().manual_seed(0)
weights = [(torch.randn(D, D, generator=gen) / D**0.5).to(device) for _ in range(N_STAGES)]


def stage_fn(w, x):
    return torch.relu(x @ w)


def microbatch(k: int) -> torch.Tensor:
    return torch.randn(8, D, generator=torch.Generator().manual_seed(100 + k)).to(device)


final_outputs: dict[int, torch.Tensor] = {}


def make_fns():
    fns = {}
    for j in range(N_STAGES):
        for k in range(N_MICRO):
            def f(inputs, j=j, k=k):
                x = microbatch(k) if j == 0 else inputs[f"act_{j - 1}to{j}_mb{k}"]
                y = stage_fn(weights[j], x)
                if j == N_STAGES - 1:
                    final_outputs[k] = y  # sink stage: deliver the result
                return {o: y for o in inst.out_data(f"stage{j}_mb{k}")}
            fns[f"stage{j}_mb{k}"] = f
    return fns


st = plan.lower("inprocess").compile(make_fns()).run().stats
print(f"executed {st.execs} stage-steps, {st.comms} stage transfers")
print("execution order:", " ".join(s for s, _, _ in st.exec_log))

# Reference: run the microbatches straight through one process.
for k in range(N_MICRO):
    x = microbatch(k)
    for j in range(N_STAGES):
        x = stage_fn(weights[j], x)
    assert final_outputs[k].device.type == device
    torch.testing.assert_close(final_outputs[k], x, rtol=0, atol=1e-6)
print("pipeline outputs match sequential execution ✓")
