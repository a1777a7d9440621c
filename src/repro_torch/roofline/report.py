"""Render the §Dry-run / §Roofline tables from the port's dry-run JSONs.

A copy of ``repro.roofline.report`` over the records of
``repro_torch.launch.dryrun``: on a record that the reference's report can
read, every table is the reference's, character for character, column
names included ("HLO flops/dev" is the port's counted FLOPs a device,
"compile s" its 0).  A port record's ``temp_bytes`` is ``null`` (eager
PyTorch has no buffer assignment), shown as "n/a".

Usage::

    PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def load(dir_: str | Path) -> list[dict]:
    recs = [json.loads(p.read_text()) for p in sorted(Path(dir_).glob("*.json"))]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))
    return recs


def _f(x: float) -> str:
    if x == 0:
        return "0"
    if x >= 100:
        return f"{x:.0f}"
    if x >= 1:
        return f"{x:.2f}"
    return f"{x:.3g}"


def dryrun_table(recs: list[dict]) -> str:
    rows = [
        "| arch | shape | mesh | status | compile s | HLO flops/dev | arg GB/dev | temp GB/dev | collectives (count) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") == "skipped":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP ({r['reason'][:40]}…) | | | | | |"
            )
            continue
        if r.get("status") == "error":  # the port's fleet writes these too
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR ({r['error'][:40]}…) | | | | | |"
            )
            continue
        mem = r.get("memory_analysis", {})
        arg = mem.get("argument_bytes", 0) / 2**30
        tmp = mem.get("temp_bytes", 0)
        tmp = "n/a" if tmp is None else f"{tmp / 2**30:.1f}"
        cols = r.get("collectives", {}).get("count", {})
        colstr = ", ".join(f"{k}:{v}" for k, v in sorted(cols.items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
            f"| {r.get('compile_s', 0):.0f} "
            f"| {r['cost_analysis']['flops']:.3g} "
            f"| {arg:.1f} | {tmp} | {colstr} |"
        )
    return "\n".join(rows)


def roofline_table(recs: list[dict], mesh: str = "pod1") -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | bound s | useful-FLOP frac | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh or r.get("status") != "ok":
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {_f(rl['compute_s'])} | {_f(rl['memory_s'])} "
            f"| {_f(rl['collective_s'])} | **{rl['dominant']}** "
            f"| {_f(rl['bound_s'])} | {rl['useful_flops_fraction']:.2f} "
            f"| {rl['mfu_bound'] * 100:.1f}% |"
        )
    return "\n".join(rows)


def interesting_cells(recs: list[dict], mesh: str = "pod1") -> list[dict]:
    """Worst MFU bound, most collective-bound, most SWIRL-representative."""
    ok = [r for r in recs if r["mesh"] == mesh and r.get("status") == "ok"]
    worst = min(ok, key=lambda r: r["roofline"]["mfu_bound"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"])
    return [worst, coll]


def main() -> None:
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    recs = load(d)
    n_ok = sum(1 for r in recs if r.get("status") == "ok")
    n_skip = sum(1 for r in recs if r.get("status") == "skipped")
    n_err = sum(1 for r in recs if r.get("status") == "error")
    print(f"## Dry-run: {n_ok} stepped, {n_skip} documented skips, {n_err} errors\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16×16, per step)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
