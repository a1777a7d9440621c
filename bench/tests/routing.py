"""Where the program's numbers part from the reference's: its MoE routing
against the fp32 reference's, token by token, on the card at the cell's own
size.  The program's routing is taken from the port's ``moe.route`` as the
timed path calls it; the reference's from its own ``route``.

    python3 -m bench.tests.routing --workload deepseek-moe-16b.decode \\
        --seeds 11,12,13 [--out FILE]

A serve cell: one batch served as the window serves it; for each served
token, the MoE layers whose top-k set differs from the reference's at that
token's position ("flips"), the reference's margin between its k-th and
(k+1)-th expert there, and the token's gap; then how the widest gaps and
the flips coincide.  A train cell: the first iteration's routing of every
MoE call (forward and recompute, each pod), each matched to the reference
call of the same rows and layer that it agrees with most; flips a layer;
and which leaves the pods' mean gradient before the int8 sync is furthest
from the reference in.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench.harness import core  # noqa: E402


@contextmanager
def recording(ctx):
    """Record the top-k experts of every routing call of the port and of the
    cell's reference: ``(port, ref)``, each a list of ``[T, k]`` int64
    tensors (the reference's with its sorted probabilities' margin at k,
    ``[T]``)."""
    import torch

    from repro_torch.models import moe

    ref = core.load_reference(ctx.cell.config, ctx.root)
    port_calls, ref_calls = [], []
    port_route, ref_route = moe.route, ref.route

    def port_wrapped(cfg, p, xf):
        r = port_route(cfg, p, xf)
        port_calls.append(r.experts.detach().clone())
        return r

    def ref_wrapped(m, p, x, groups):
        out = ref_route(m, p, x, groups)
        k = m["moe"]["top_k"]
        vals = torch.sort(out[0].detach(), dim=-1, descending=True).values
        ref_calls.append((out[2].detach().clone(), (vals[:, k - 1] - vals[:, k]).clone()))
        return out

    moe.route, ref.route = port_wrapped, ref_wrapped
    try:
        yield port_calls, ref_calls
    finally:
        moe.route, ref.route = port_route, ref_route


def differ(a, b):
    """Per row, whether two ``[T, k]`` choice lists hold different expert sets."""
    import torch

    return (torch.sort(a, dim=-1).values != torch.sort(b.to(a.device), dim=-1).values).any(dim=-1)


def serve_look(ctx) -> dict:
    import numpy as np
    import torch

    from bench.drivers import serve

    wl, ref = ctx.cell.workload, core.load_reference(ctx.cell.config, ctx.root)
    b, l0, g = wl["batch"], wl["prompt_len"], wl["gen"]
    with recording(ctx) as (port_calls, ref_calls):
        st = serve.setup(ctx)
        port_calls.clear()  # the warm-up batch
        served = np.stack(list(serve._batch(st, serve.prompts(ctx, 0), g - 1)), axis=1)
        serve.release(st)
        del st
        tokens = torch.from_numpy(served).to(ctx.device)
        logits = serve.reference_logits(ctx, 0, tokens)[0]
    gap = ref.gaps(logits, tokens)  # [B, G]
    n_moe = len(ref_calls)
    s = l0 + g - 1
    flips = torch.zeros(b, g, n_moe, dtype=torch.bool, device=gap.device)
    margin = torch.zeros(b, g, n_moe, device=gap.device)
    for layer, (r_exp, r_margin) in enumerate(ref_calls):
        r_exp, r_margin = r_exp.view(b, s, -1), r_margin.view(b, s)
        for j in range(g):
            pos = l0 - 1 + j
            if j == 0:
                got = port_calls[layer].view(b, l0, -1)[:, l0 - 1]
            else:
                got = port_calls[n_moe * j + layer]
            flips[:, j, layer] = differ(got, r_exp[:, pos])
            margin[:, j, layer] = r_margin[:, pos]
    any_flip = flips.any(dim=-1)
    order = torch.argsort(gap.reshape(-1), descending=True)
    top = []
    for i in order[:10].tolist():
        r, j = divmod(i, g)
        layers = torch.nonzero(flips[r, j]).reshape(-1).tolist()
        top.append({"request": r, "token": j, "gap": float(gap[r, j]), "flipped_layers": layers,
                    "ref_margins": [float(margin[r, j, k]) for k in layers]})
    flipped_margins = margin[flips]
    return {
        "tokens": b * g,
        "port_calls": len(port_calls),
        "tokens_with_a_flip": int(any_flip.sum()),
        "flips": int(flips.sum()),
        "flip_margin_max": float(flipped_margins.max()) if flipped_margins.numel() else None,
        "flip_margin_median": float(flipped_margins.median()) if flipped_margins.numel() else None,
        "margin_median_all": float(margin.median()),
        "gap_mean_with_flip": float(gap[any_flip].mean()) if any_flip.any() else None,
        "gap_mean_without": float(gap[~any_flip].mean()),
        "gap_max_without_flip": float(gap[~any_flip].max()),
        "over_half": int((gap > 0.5).sum()),
        "over_half_with_flip": int(((gap > 0.5) & any_flip).sum()),
        "top10_with_flip": sum(1 for t in top if t["flipped_layers"]),
        "top": top,
    }


def leaf_paths(m: dict) -> list[str]:
    """The params' leaf paths in the order of ``weights.flatten``."""
    from bench.harness import weights

    def group(g):
        tree: dict = {}
        for path, *_ in weights.group_leaves(m, g):
            weights._put(tree, path, None)
        return tree

    return [p for p, _ in weights.flatten({**group(0), "layers": [group(1 + i) for i in range(m["n_layers"])]})]


def train_look(ctx) -> dict:
    import torch

    from bench.drivers import train
    from bench.harness import weights

    wl = ctx.cell.workload
    with recording(ctx) as (port_calls, ref_calls):
        st = train.setup(ctx)
        got = train.readings(st)
        train.release(st)
        del st
        want = train.reference(ctx)
    n_moe = sum(1 for _, ffn in weights.layer_seq(ctx.cell.model) if ffn == "moe")
    ref_first = ref_calls[: wl["pods"] * n_moe]  # the first iteration: pod by pod, layer by layer
    per_call = 2 * wl["pods"] * n_moe  # a forward and its recompute, each pod
    flips = [0] * n_moe
    matched = []
    for call in port_calls[:per_call]:
        best = min(((int(differ(call, r).sum()), i) for i, (r, _) in enumerate(ref_first) if r.shape == call.shape),
                   default=(None, None))
        matched.append(best[1])
        if best[1] is not None:
            flips[best[1] % n_moe] = max(flips[best[1] % n_moe], best[0])
    paths = leaf_paths(ctx.cell.model)
    dev = want["grad"].device
    ref_norms = train.train_step.leaf_norms(want["grad_leaves"])
    floor = torch.clamp_min(ref_norms, torch.median(ref_norms)).clamp_min(1e-30)
    diff = train.train_step.leaf_norms([a.to(dev) - b for a, b in zip(got["grad_leaves"], want["grad_leaves"])]) / floor
    worst = torch.argsort(diff, descending=True)[:5].tolist()
    moe_layers = [i for i, (_, ffn) in enumerate(weights.layer_seq(ctx.cell.model)) if ffn == "moe"]
    return {
        "port_calls": len(port_calls), "ref_calls_first_iteration": len(ref_first),
        "each_ref_call_matched": sorted(matched) == sorted(list(range(len(ref_first))) * 2),
        "tokens_a_call": int(ref_first[0][0].shape[0]) if ref_first else 0,
        "flips_by_layer": {str(moe_layers[i]): f for i, f in enumerate(flips)},
        "grad_diff_worst_leaves": [(paths[i], float(diff[i])) for i in worst],
        "grad_diff_median": float(torch.median(diff)),
        "router_diff_by_layer": {p.split("/")[1]: float(diff[i]) for i, p in enumerate(paths) if p.endswith("router/w")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    core.configure_env(core.ROOT)
    cell = core.find_cell(core.load_spec(), args.workload)
    look = {"serve": serve_look, "train": train_look}[cell.workload["driver"]]
    print(f"card: {core.card_line()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        ctx = core.Ctx(seed, 0.0, False, cell, "cuda", core.ROOT)
        line = {"workload": cell.name, "seed": seed, **look(ctx), "seconds": time.monotonic() - t0}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
