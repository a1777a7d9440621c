"""Compile-once / run-many workflow serving on the PyTorch port.

The counterpart of ``examples/serve_batched.py`` over ``repro_torch``.  A
serving-shaped workflow — ingest fans out to two workers whose results
merge — is traced, optimised and lowered **once**; then a batch of request
instances streams through the same per-location program IR with
``Executable.run_many`` on the ``threaded`` backend.  Each request's datum
is a tensor on the device.  The naive serving loop pays trace → optimize →
lower → compile for every request; ``run_many`` amortises all of it and
pipelines the instances through persistent location threads.

Run: ``PYTHONPATH=src python examples/torch_serve_batched.py`` (on ``cuda``;
``--device cpu`` for the CPU)
"""

import argparse
import time

import torch

from repro_torch import swirl
from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

N = 40

workflow = make_workflow(
    ["ingest", "work_a", "work_b", "merge"],
    ["p_seed", "p_ingest", "p_a", "p_b"],
    [
        ("p_seed", "ingest"),
        ("ingest", "p_ingest"),
        ("p_ingest", "work_a"),
        ("p_ingest", "work_b"),
        ("work_a", "p_a"),
        ("work_b", "p_b"),
        ("p_a", "merge"),
        ("p_b", "merge"),
    ],
)
inst = DistributedWorkflowInstance(
    workflow=workflow,
    locations=frozenset({"gateway", "pool_a", "pool_b"}),
    mapping={
        "ingest": ("gateway",),
        "work_a": ("pool_a",),
        "work_b": ("pool_b",),
        "merge": ("gateway",),
    },
    data=frozenset({"d_seed", "d_ingest", "d_a", "d_b"}),
    placement={
        "d_seed": "p_seed",
        "d_ingest": "p_ingest",
        "d_a": "p_a",
        "d_b": "p_b",
    },
    initial_data={"gateway": frozenset({"d_seed"})},
)
steps = {
    "ingest": lambda i: {"d_ingest": i["d_seed"] * 2},
    "work_a": lambda i: {"d_a": i["d_ingest"] + 1},
    "work_b": lambda i: {"d_b": i["d_ingest"] + 2},
    "merge": lambda i: {},
}
requests = [{("gateway", "d_seed"): torch.tensor(i, device=device)} for i in range(N)]


def sync() -> None:
    if device == "cuda":
        torch.cuda.synchronize()


# Naive serving: the full pipeline per request.
t0 = time.perf_counter()
naive = [
    swirl.trace(inst)
    .optimize()
    .lower("threaded")
    .compile(steps)
    .run(initial_payloads=r)
    for r in requests
]
sync()
dt_naive = time.perf_counter() - t0

# Compile-once serving: one Executable, one run_many batch.
executable = swirl.trace(inst).optimize().lower("threaded").compile(steps)
t0 = time.perf_counter()
batch = executable.run_many(requests, max_concurrent=8)
sync()
dt_batch = time.perf_counter() - t0

for a, b in zip(batch, naive):
    assert a.data.keys() == b.data.keys()
    for loc in a.data:
        assert a.data[loc].keys() == b.data[loc].keys()
        assert all(torch.equal(v, b.data[loc][d]) for d, v in a.data[loc].items())
for i, result in enumerate(batch):
    assert result.payload("pool_a", "d_a").device.type == device
    assert int(result.payload("pool_a", "d_a")) == 2 * i + 1
    assert int(result.payload("pool_b", "d_b")) == 2 * i + 2

print(
    f"per-request pipeline : {N / dt_naive:7.1f} instances/s"
    f"  ({dt_naive * 1e3 / N:.2f} ms/request)"
)
print(
    f"compile-once run_many: {N / dt_batch:7.1f} instances/s"
    f"  ({dt_batch * 1e3 / N:.2f} ms/request)"
)
print(f"speedup: {dt_naive / dt_batch:.1f}x")

# The same compile-once idea at the model level: prefill + KV-cache greedy
# decode on the xLSTM smoke config (O(1)-state decode).
from repro_torch.launch.serve import serve  # noqa: E402

out = serve("xlstm-125m", smoke=True, batch=2, prompt_len=16, gen=8, device=device)
assert out["tokens"].shape == (2, 8)
print("OK")
