"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the result line.

``BENCHMARK.json`` (at the root of the checkout) names configurations,
cells and metrics.  Everything else is found by name under ``bench/``:

* ``configs/<config>.json``: the configuration as it is run (its ``model``
  section is the port's ``ModelConfig``; ``numerics`` what the reference
  needs besides);
* ``workloads/<cell>.json``: the cell's ``driver``, traffic and limits;
* ``drivers/<driver>.py``: ``setup``, ``measure``, ``profile``, ``check``;
* ``metrics/<metric>.py``: ``read(record)`` of one per-layer metric;
* ``layers/<kind>.py``: a mixer or FFN kind's weights and FLOPs
  (:mod:`bench.layers`);
* the configuration's ``reference`` key: its plain reference, a module under
  ``reference/`` (:func:`load_reference`).

A run: the driver's ``setup`` (everything before the first timed step),
``measure`` (the window), with ``--trace 1`` its ``profile`` (a short traced
stretch read into a record, see :mod:`bench.harness.profile`), then the
peak memory, then ``check``, which frees the program's state and runs the
reference.  The result is one JSON line, the last of standard output; the
numbers compared, each beside its limit, are also the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a missing file)."""


def configure_env(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; set before torch loads."""
    cache = root / "build" / "bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def process_start() -> float:
    """The wall-clock time this process started (from ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict  # its BENCHMARK.json entry
    workload: dict  # workloads/<name>.json
    config: dict  # the configuration's file

    @property
    def model(self) -> dict:
        """The ``model`` section with the configuration's ``numerics`` beside it."""
        return {**self.config["model"], **self.config.get("numerics", {})}


def load_spec(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise Refused(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    entry = entries[name]
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    return Cell(name, entry, _read_json(root / "bench" / "workloads" / f"{name}.json"), _read_json(root / conf["file"]))


def load_driver(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def load_reader(metric: str, root: Path = ROOT):
    path = root / "bench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise Refused(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(conf: dict, root: Path = ROOT):
    """The plain reference that a configuration names: its ``reference`` key,
    a file under ``bench/reference/``.  It gives what the drivers call:
    ``serve_logits``, ``gaps``, ``forward_loss``, ``fp32_mm``, ``fp8_mm`` and
    ``exact_fp32``."""
    rel = Path(conf.get("reference") or "")
    named = rel.parent == Path("bench/reference") and rel.suffix == ".py" and rel.stem.isidentifier()
    if not named or not (root / rel).is_file():
        raise Refused(f"{conf.get('name')}: no reference {conf.get('reference')!r} (a file under bench/reference/)")
    return importlib.import_module(f"bench.reference.{rel.stem}")


def metrics_of(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ") or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_loaded() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


@dataclass
class Ctx:
    """What a driver is given: the run's arguments and its cell."""

    seed: int
    seconds: float
    trace: bool
    cell: Cell
    device: str
    root: Path

    @property
    def trace_path(self) -> Path:
        return self.root / "build" / "bench" / f"{self.cell.name}.trace.json"


def run(argv=None, *, root: Path = ROOT, device: str = "cuda", stdout=None, stderr=None) -> int:
    """One run of one cell; returns the exit code.  Prints the result line
    only when the run reached its end."""
    t_start = process_start()
    stdout, stderr = stdout or sys.stdout, stderr or sys.stderr
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    configure_env(root)
    import torch

    spec = load_spec(root)
    cell = find_cell(spec, args.workload, root)
    chips = cell.entry["chips"]
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"refused: the cell needs {chips} CUDA device(s), this machine has {n}", file=stderr)
        return 2
    if device == "cuda":
        print(f"card: {card_line()}; peaks: {PEAK_BF16_FLOPS:.4g} FLOP/s bf16 dense, "
              f"{PEAK_HBM_BYTES:.4g} B/s HBM (H100 SXM data sheet)", file=stderr, flush=True)
    ctx = Ctx(args.seed, args.seconds, bool(args.trace), cell, device, root)
    drv = load_driver(cell.workload["driver"])
    state = drv.setup(ctx)
    setup_s = time.time() - t_start
    window = drv.measure(state)
    wanted = metrics_of(spec, cell.name, ctx.trace)
    metrics, breakdown, dev_extra = {}, None, {}
    if ctx.trace:
        record = drv.profile(state)
        record.update(window.get("record", {}))
        for m in wanted:
            v = load_reader(m["name"], root).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = record["breakdown"]
        dev_extra = {"busy_s": record["busy_s"], "window_s": record["window_s"]}
    else:
        values = {**window["metrics"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted}
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    t_check = time.monotonic()
    verdict = drv.check(state)
    del state
    print(f"check took {time.monotonic() - t_check:.1f} s (after the window; not in setup_s)", file=stderr)
    bad = forbidden_loaded()
    if bad:
        print(f"refused: modules {bad} were loaded in this process", file=stderr)
        return 3
    checks = verdict["checks"]
    for name, v in verdict.get("readings", {}).items():
        print(f"reading {name} = {v!r} (not compared)", file=stderr)
    correct = all(v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r}){'' if v <= lim else '  FAILED'}", file=stderr)
    result = {
        "correct": correct,
        "attempted": window["attempted"],
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device, "kind": kind, "count": chips,
                   "memory_peak_bytes": peak, **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    stderr.flush()
    print(json.dumps(result), file=stdout, flush=True)
    return 0
