"""Deterministic random layered workflow instances, at any scale.

A copy of ``repro/core/randgen.py``: the same seed gives the same instance
as the reference's.

One generator shared by the compile-time benchmarks
(``benchmarks/run.py compile``), the large-DAG smoke tests and the
flat-vs-tree differential property suite, so they all agree on what "an
N-step workflow" means: a layered DAG (always acyclic) with bounded
fan-in, a tunable fraction of spatially-constrained (multi-location)
steps, and a fixed seed → identical instance on every machine.
"""

from __future__ import annotations

import random

from .graph import DistributedWorkflowInstance, make_workflow

__all__ = ["random_layered_instance"]


def random_layered_instance(
    n_steps: int,
    *,
    n_locations: int = 4,
    seed: int = 0,
    max_width: int = 4,
    max_fan_in: int = 3,
    p_spatial: float = 0.1,
    p_sink_port: float = 0.5,
) -> DistributedWorkflowInstance:
    """A random layered DAG instance with exactly ``n_steps`` steps.

    Steps are laid out in layers of 1..``max_width``; each step consumes up
    to ``max_fan_in`` ports of the previous layer and (except some sinks)
    produces one port holding one data element.  With probability
    ``p_spatial`` a step is mapped onto two locations (a spatial
    constraint — the pattern rule R3 optimises); otherwise onto one.
    """
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1: {n_steps}")
    rng = random.Random(seed)
    locations = [f"l{i}" for i in range(n_locations)]

    widths: list[int] = []
    remaining = n_steps
    while remaining:
        w = min(remaining, rng.randint(1, max_width))
        widths.append(w)
        remaining -= w

    steps: list[str] = []
    ports: list[str] = []
    deps: list[tuple[str, str]] = []
    data: list[str] = []
    placement: dict[str, str] = {}
    mapping: dict[str, tuple[str, ...]] = {}
    prev_ports: list[str] = []
    sid = 0
    for layer, width in enumerate(widths):
        new_ports: list[str] = []
        for _ in range(width):
            s = f"s{sid}"
            sid += 1
            steps.append(s)
            if n_locations > 1 and rng.random() < p_spatial:
                mapping[s] = tuple(sorted(rng.sample(locations, 2)))
            else:
                mapping[s] = (rng.choice(locations),)
            if prev_ports:
                n_in = rng.randint(0, min(max_fan_in, len(prev_ports)))
                for p in rng.sample(prev_ports, n_in):
                    deps.append((p, s))
            if layer < len(widths) - 1 or rng.random() < p_sink_port:
                p, d = f"p{s}", f"d{s}"
                ports.append(p)
                data.append(d)
                placement[d] = p
                deps.append((s, p))
                new_ports.append(p)
        prev_ports = new_ports
    wf = make_workflow(steps, ports, deps)
    return DistributedWorkflowInstance(
        workflow=wf,
        locations=frozenset(locations),
        mapping=mapping,
        data=frozenset(data),
        placement=placement,
        initial_data={},
    )
