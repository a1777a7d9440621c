"""Distributed execution on the PyTorch port: the multiprocess backend.

The counterpart of ``examples/distributed_multiprocess.py`` over
``repro_torch``.  Every location (group) becomes its own worker process and
COMM messages cross the ack-based socket transport
(``multiprocessing.connection`` with pickle framing and resend on ack
timeout): a tensor a step sends goes through the host and is rebuilt on its
device at the receiver.  The step bodies compute on the device, so on
``cuda`` the workers are spawned (``start_method="spawn"``: a forked child
cannot use its parent's CUDA context) and the bodies are module-level
functions, which pickle.  This example shows:

1. the default one-process-per-location lowering (distinct PIDs);
2. cost-model scheduling pinning each network rack to one worker process;
3. a worker crash surfacing as a typed ``WorkerFailedError`` and the
   coordinator's checkpoint resuming the run without re-executing the
   steps that already finished.

Run: ``PYTHONPATH=src python examples/torch_distributed_multiprocess.py``
(on ``cuda``; ``--device cpu`` for the CPU, where the workers are forked)
"""

import argparse
import functools
import os

import torch

from repro_torch import swirl
from repro_torch.backends import WorkerFailedError
from repro_torch.core.translate import genomes_1000
from repro_torch.sched import NetworkModel

CHUNK = 1024  # elements of each chromosome chunk


def chunk(name: str, device: str) -> torch.Tensor:
    """The initial chunk ``name``, made from a seed of its own."""
    seed = sum(map(ord, name))
    return torch.rand(CHUNK, generator=torch.Generator().manual_seed(seed)).to(device)


def driver_step(outs, device, inputs):
    """``s0``: emit the chromosome chunks."""
    return {o: chunk(o, device) for o in outs}


def reduce_step(outs, device, inputs):
    """Every other step: the sum of its inputs, spread over a chunk."""
    total = sum(inputs[k].sum() for k in sorted(inputs))
    return {o: total * torch.ones(CHUNK, device=device) for o in outs}


def stores_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[loc].keys() == b[loc].keys() and all(torch.equal(v, b[loc][d]) for d, v in a[loc].items())
        for loc in a
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args().device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")
    opts = {"timeout_s": 120}
    if device == "cuda":
        opts["start_method"] = "spawn"

    # -- 1. one OS process per location --------------------------------------
    inst = genomes_1000(n=2, m=2, a=1, b=1, c=1)
    plan = swirl.trace(inst).optimize()
    step_fns = {
        s: functools.partial(driver_step if s == "s0" else reduce_step, sorted(inst.out_data(s)), device)
        for s in inst.workflow.steps
    }
    init = {("l^d", d): chunk(d, device) for d in inst.g("l^d")}

    exe = plan.lower("multiprocess", **opts).compile(step_fns)
    result = exe.run(initial_payloads=dict(init))
    pids = result.stats["pids"]
    print(f"coordinator pid {os.getpid()}; {result.stats['workers']} workers "
          f"({result.stats['start_method']}):")
    for wid, group in result.stats["groups"].items():
        print(f"  worker {wid} (pid {pids[wid]}): {', '.join(group)}")
    assert len(set(pids.values())) == result.stats["workers"]
    assert os.getpid() not in pids.values()
    assert result.payload("l^IM", "d^IM").device.type == device

    threaded = plan.lower("threaded", timeout_s=60).compile(step_fns).run(initial_payloads=dict(init))
    assert stores_equal(result.data, threaded.data)
    print("multiprocess == threaded: identical final stores\n")

    # -- 2. schedule placement → process pinning ------------------------------
    net = NetworkModel.preset("two-rack").bind(sorted(inst.locations))
    sched = plan.schedule(net)
    pinned = sched.lower("multiprocess", **opts).compile(step_fns).run(initial_payloads=dict(init))
    print(f"two-rack schedule → {pinned.stats['workers']} pinned workers:")
    for wid, group in pinned.stats["groups"].items():
        print(f"  worker {wid}: {', '.join(group)}")

    # -- 3. worker failure, checkpoint, resume --------------------------------
    victim = sorted(inst.workflow.steps)[-1]
    crashing = plan.lower("multiprocess", _kill_at_step=victim, **opts).compile(step_fns)
    try:
        crashing.run(initial_payloads=dict(init))
    except WorkerFailedError as e:
        print(f"\ninjected crash: {e}")
        ckpt = crashing.checkpoint()
        print(f"checkpoint holds {len(ckpt.completed_execs)} completed steps; resuming...")
        resumed = plan.lower("multiprocess", **opts).compile(step_fns).restore(ckpt).run(
            initial_payloads=dict(init))
        assert stores_equal(resumed.data, result.data)
        print("resumed run matches the clean run")
    else:
        raise AssertionError("the injected crash did not fail the run")

    print("OK")


if __name__ == "__main__":
    main()
