"""The readings that a cell's limits are set from, on the card at the cell's
own size: for each seed the program's numbers (a sound run, one batch or
the followed iterations, through the timed path), and on the seeds asked
for the control's (the fp32 reference's arithmetic with fp8 products, put
in the program's place) and each planted fault's.  One JSON line a seed.

    python3 -m bench.tests.readings --workload deepseek-moe-16b.decode \\
        --seeds 11,12,13 --control-seeds 11,12,13 [--faults] [--out FILE]

A serve cell's control reads, at each served position, the gap of the
token that the fp8 arithmetic puts first; a train cell's control is the
reference run again with fp8 products, compared with the fp32 one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench.harness import core  # noqa: E402


def serve_seed(ctx, control: bool, faults: bool) -> dict:
    import numpy as np
    import torch

    from bench.drivers import serve
    from bench.tests import faults as planted

    wl, ref = ctx.cell.workload, core.load_reference(ctx.cell.config, ctx.root)
    out = {}
    runs = [("program", None)] + ([(k, f) for k, f in planted.SERVE.items()] if faults else [])
    served = {}
    for name, plant in runs:
        st = serve.setup(ctx, plant)
        served[name] = np.stack(list(serve._batch(st, serve.prompts(ctx, 0), wl["gen"] - 1)), axis=1)
        serve.release(st)
        del st
    mms = (ref.fp32_mm, ref.fp8_mm) if control else (ref.fp32_mm,)
    tokens = torch.from_numpy(served["program"]).to(ctx.device)
    logits = serve.reference_logits(ctx, 0, tokens, mms)
    out["program"] = serve.numbers(ref.gaps(logits[0], tokens))
    if control:
        out["control"] = serve.numbers(ref.gaps(logits[0], logits[1].argmax(dim=-1)))
    for name in served:
        if name != "program":
            t = torch.from_numpy(served[name]).to(ctx.device)
            out[name] = serve.numbers(ref.gaps(serve.reference_logits(ctx, 0, t)[0], t))
    return out


def train_seed(ctx, control: bool, faults: bool) -> dict:
    from bench.drivers import train
    from bench.tests import faults as planted

    got = {}
    runs = [("program", None)] + ([(k, f) for k, f in planted.TRAIN.items()] if faults else [])
    for name, plant in runs:
        st = train.setup(ctx, plant)
        got[name] = train.readings(st)
        train.release(st)
        del st
    want = train.reference(ctx)
    out = {name: train.gaps(r, want) for name, r in got.items()}
    if control:
        ref = core.load_reference(ctx.cell.config, ctx.root)
        out["control"] = train.gaps(train.reference(ctx, ref.fp8_mm), want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true", help="plant each fault on the control seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    core.configure_env(core.ROOT)
    cell = core.find_cell(core.load_spec(), args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    run = {"serve": serve_seed, "train": train_seed}[cell.workload["driver"]]
    print(f"card: {core.card_line()}", flush=True)
    for seed in seeds:
        t0 = time.monotonic()
        ctx = core.Ctx(seed, 0.0, False, cell, "cuda", core.ROOT)
        line = {"workload": cell.name, "seed": seed, **run(ctx, seed in control, args.faults and seed in control)}
        line["seconds"] = time.monotonic() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
