"""Workflow-as-a-service over HTTP on the PyTorch port: the gateway quickstart.

The counterpart of ``examples/gateway_client.py`` over ``repro_torch``.
Starts an in-process gateway (``repro_torch.serve``) whose step registry
holds the 1000 Genomes step bodies, which compute on the device, then
drives it the way a remote client would — over plain HTTP/1.1 with
keep-alive:

1. ``POST /v1/workflows`` with the workflow's ``.swirl`` text — the
   service compiles it through trace → optimize → lower → compile once
   and returns its content-address fingerprint;
2. resubmit — a cache hit, nothing recompiles;
3. ``POST /v1/workflows/{fp}/run`` and ``.../run_many`` — instances
   execute on the shared threaded Executable;
4. ``GET /v1/stats`` — cache hit rate + per-tenant admission counters;
5. graceful shutdown — in-flight work drains before the socket closes.

Responses are JSON, so each body hands back plain numbers and lists
(``.tolist()``, ``float``): the gateway writes any other value as its
``str``, a tensor included, as the reference's does a ``jax.Array``.

Run: ``PYTHONPATH=src python examples/torch_gateway_client.py`` (on
``cuda``; ``--device cpu`` for the CPU)
"""

import argparse

import torch

from repro_torch import swirl
from repro_torch.core.parser import dumps
from repro_torch.core.translate import genomes_1000
from repro_torch.serve import Gateway, GatewayClient, GatewayError, WorkflowService

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device
if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

# -- the server side ---------------------------------------------------------
# The operator deploys the service with a step registry; submissions may
# only reference registered steps.  Bodies compute on the device (float64,
# so that every value is the reference's) and return JSON-able values.
inst = genomes_1000(n=2, m=2, a=1, b=1, c=1)
SEED = {d: [float(i + 1), float(i + 2)] for i, d in enumerate(sorted(inst.g("l^d")))}


def on_device(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64, device=device)


def make_registry():
    fns = {}
    for s in inst.workflow.steps:
        outs = inst.out_data(s)
        if s == "s0":  # the driver step: emits the chromosome chunks
            fns[s] = lambda i, outs=outs: {o: SEED[o] for o in outs}
        elif s.startswith("sI_"):  # individuals: sort the chunk
            fns[s] = lambda i, outs=outs: {
                o: torch.sort(on_device(next(iter(i.values())))).values.tolist() for o in outs
            }
        elif s == "sIM":  # individuals_merge: element-wise mean
            fns[s] = lambda i, outs=outs: {
                o: torch.stack([on_device(i[k]) for k in sorted(i)]).mean(0).tolist() for o in outs
            }
        elif s == "sSF":  # sifting: keep values above threshold
            fns[s] = lambda i, outs=outs: {
                o: (lambda v: v[v > 2.0].tolist())(on_device(next(iter(i.values())))) for o in outs
            }
        else:  # mutation_overlap / frequency: reduce to a statistic
            fns[s] = lambda i, outs=outs: {
                o: float(sum(on_device(v).sum() for v in i.values())) for o in outs
            }
    return fns


service = WorkflowService(make_registry())
text = dumps(swirl.trace(inst).system)

with Gateway(service) as gateway:
    print(f"gateway listening on {gateway.url}")

    # -- the client side -----------------------------------------------------
    with GatewayClient(gateway.url) as client:
        receipt = client.submit({"swirl": text})
        fp = receipt["fingerprint"]
        print(
            f"submitted: fingerprint {fp[:16]}…  cached={receipt['cached']} "
            f"({receipt['actions']} actions, "
            f"{receipt['communications']} comms)"
        )
        assert receipt["cached"] is False

        again = client.submit({"swirl": text})
        assert again["fingerprint"] == fp and again["cached"] is True
        print("resubmitted: cache hit, no recompile")

        result = client.run(fp)
        final = result["data"]["l^IM"]["d^IM"]
        expect = [
            sum(vals) / len(vals)
            for vals in zip(sorted(SEED["d0_1"]), sorted(SEED["d0_2"]))
        ]
        assert final == expect, (final, expect)
        print(f"ran one instance: individuals_merge -> {final}")

        batch = client.run_many(fp, [{}] * 8, max_concurrent=4)
        assert len(batch["results"]) == 8
        assert all(
            r["data"]["l^IM"]["d^IM"] == expect for r in batch["results"]
        )
        print("ran a batch of 8 through the shared Executable")

        # Malformed submissions are structured 400s, never tracebacks.
        try:
            client.submit({"swirl": "<l, {d},\n  frobnicate(s)>"})
        except GatewayError as e:
            assert e.status == 400 and e.error["kind"] == "swirl-syntax"
            print(
                "malformed submission -> HTTP 400 "
                f"(line {e.error['line']}, column {e.error['column']})"
            )

        stats = client.stats()
        cache = stats["cache"]
        print(
            f"stats: {stats['counters']['instances_completed']} instances, "
            f"cache hit rate {cache['hit_rate']:.0%}, "
            f"{stats['counters']['compiles']} compile(s)"
        )
        assert stats["counters"]["compiles"] == 1
        assert stats["counters"]["instances_failed"] == 0

# Leaving the ``with`` block drained admitted work, then closed the socket.
print("gateway drained and closed. OK")
