"""``torch`` backend — interpret location programs on CUDA devices.

The counterpart of the reference's ``jax`` backend
(``repro/backends/jax_backend.py``).  Each SWIRL location is pinned to a
device (round-robin over ``cuda:0..n-1``, or an explicit ``devices=``
option; ``platform="cpu"`` puts every location on the CPU; a ``schedule=``
report keeps each network group's locations on one contiguous block of
devices).  The compiled artifact then interprets the per-location program
IR deterministically:

* an enabled ``ExecOp`` runs the step function with its inputs resident on
  the leader location's device and replicates ``Out^D(s)`` onto every
  device of ``M(s)`` — the (EXEC) rule's "add to every ``D_i``" becomes
  ``Tensor.to(device)``;
* a matching ``SendOp``/``RecvOp`` pair moves the payload to the
  destination location's device — (COMM) as a device-to-device copy.

Only array payloads (``torch.Tensor`` / ``numpy.ndarray``) are staged
through the device API; plain Python payloads are copied by reference, so
results are identical with the reference's backends on non-numeric
workflows.

With ``fuse=True`` each straight-line EXEC run on one location is captured
once into a CUDA graph (``torch.cuda.CUDAGraph``) and replayed on later
calls — the card's counterpart of ``jax.jit`` on a segment.

With ``trace=True`` every comm, exec fire (interpreted or fused) and
policy retry is recorded as a span (:mod:`repro_torch.obs`) in the
reference backends' schema, and the result carries a
:class:`~repro_torch.obs.RunProfile`.  A host-clock span around a CUDA
launch would measure the enqueue, not the work, so a traced run
synchronises the span's device before it stamps the span's end (an exec's
leader device; both devices of a comm between two, none for a comm within
one device, which queues no work): each span covers its own device work,
at the price of the overlap between the host and the card (the ratio of
traced to untraced time is in ``PERF.md``).  An untraced run reads no
clock and synchronises nothing on behalf of tracing.
"""

from __future__ import annotations

import numbers
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._bridge import resolve_device
from repro_torch.core.compile import StepMeta
from repro_torch.core.syntax import WorkflowSystem
from repro_torch.exec.interp import (
    Cursor,
    Deadline,
    StepGuard,
    enabled_exec_picks,
    first_enabled_comm,
    record_comm_fire,
    record_exec_fire,
    record_policy_fire,
)
from repro_torch.exec.program import ExecProgram
from repro_torch.kernels._build import KernelError

from .base import Backend, BackendProgram, ExecutionResult, PayloadKey

#: Peak device-memory bytes/s by card (NVIDIA data sheets), the roof of the
#: fused segments' roofline.  A card not listed, or the CPU, has no roof.
HBM_BYTES_PER_S = {"H100 SXM": 3.35e12, "H100 PCIe": 2.0e12}


def hbm_peak(device: torch.device) -> float | None:
    """The peak memory bytes/s of ``device``, or ``None`` if it is unknown."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return None
    if "PCIe" in name:
        return HBM_BYTES_PER_S["H100 PCIe"]
    if "SXM" in name or "HBM3" in name:
        return HBM_BYTES_PER_S["H100 SXM"]
    return None


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _plan_segments(program, *, min_len: int = 2) -> dict[int, list]:
    """Partition the deterministic exec firing order into fusable runs.

    The reducer's firing order depends only on cursor states and data
    *names*, never on payload values, so it can be replayed statically:
    simulate the run loop (drain comms, fire the lowest-named enabled
    exec) without calling any step body and record where straight-line
    EXEC runs break — at a COMM boundary, or when the leader location
    changes (a fused program runs on one device).  Returns
    ``{start_exec_index: [(ExecOp, picks), ...]}`` for every run of at
    least ``min_len`` ops — the picks are recorded at plan time so the
    runtime replays cursor completions directly instead of re-scanning
    enabledness per op; the runtime counts fired execs and swaps in the
    jitted segment when the counter hits a start index.
    """
    cursors = {lp.location: Cursor(lp) for lp in program.programs}
    data = {lp.location: set(lp.data) for lp in program.programs}
    order = sorted(cursors)
    seq: list = []
    breaks: set[int] = set()
    while True:
        comm_fired = False
        while True:
            hit = first_enabled_comm(cursors, data, order)
            if hit is None:
                break
            op, src, i, j = hit
            cursors[src].complete(i)
            cursors[op.dst].complete(j)
            data[op.dst].add(op.data)
            comm_fired = True
        execs = sorted(
            enabled_exec_picks(cursors, data, order),
            key=lambda pair: pair[0].step,
        )
        if not execs:
            break
        op, picks = execs[0]
        if (
            not seq
            or comm_fired
            or min(op.locations) != min(seq[-1][0].locations)
        ):
            breaks.add(len(seq))
        seq.append((op, picks))
        for loc, i in picks:
            cursors[loc].complete(i)
            data[loc].update(op.outputs)
    segments: dict[int, list] = {}
    starts = sorted(breaks) + [len(seq)]
    for a, b in zip(starts, starts[1:]):
        if b - a >= min_len:
            segments[a] = seq[a:b]
    return segments


def _settle(*devices: torch.device) -> None:
    """Wait for the work queued on each CUDA device among ``devices``:
    a traced span ends only once its device work is done."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _fused_output(v: Any, device: torch.device) -> torch.Tensor | None:
    """A fused segment's output as a tensor, or ``None`` if it cannot be one.

    ``jax.jit`` returns every output as an array and fails on any other
    value; a CPU segment does the same here.  On the card, an output must
    already be a tensor on the segment's device: anything else was made
    outside the captured work and would not follow the inputs on replay.
    """
    if isinstance(v, torch.Tensor):
        return v if v.device == device else None
    if device.type != "cpu":
        return None
    if isinstance(v, (np.ndarray, np.generic, numbers.Number)):
        return torch.as_tensor(np.asarray(v))
    return None


class _Graph:
    """One captured segment: its graph and the static tensors it reads and
    writes, in the segment's ``ext`` and ``out_names`` order."""

    __slots__ = ("graph", "static_in", "static_out")

    def __init__(self, graph, static_in: list, static_out: list):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out


class _FusedSegment:
    """One straight-line EXEC run, run as a single call.

    The segment function threads a data-name environment through the run's
    step bodies and returns every datum the run produces, so the
    per-location stores a fused run leaves behind are identical to the
    interpreted ones.

    On the CPU the call is one Python call over the bodies.  On a CUDA
    device the first call with a given input signature (shapes and dtypes)
    runs the bodies eagerly on a side stream (warm-up: lazy
    initialisation, and the kernels' ``nvcc`` build, happen outside the
    capture), then captures them into a CUDA graph over static input
    tensors.  Every call copies the inputs into the static inputs, replays
    the graph and copies the outputs out into fresh tensors: the graph's
    own output buffers are overwritten by the next replay, and an earlier
    run's store must not change.  There is no donation (the reference
    donates overwritten inputs to XLA): the copy into the static inputs
    already leaves the caller's tensors untouched.
    """

    def __init__(self, acts: list, steps: Mapping[str, StepMeta]):
        self.acts = acts  # [(ExecOp, picks), ...] in firing order
        ops = [op for op, _ in acts]
        self.leader = min(ops[0].locations)
        produced: set[str] = set()
        ext: list[str] = []
        for op in ops:
            for d in op.inputs:
                if d not in produced and d not in ext:
                    ext.append(d)
            produced.update(op.outputs)
        self.ext = ext
        self.out_names: list[str] = []
        for op in ops:
            for d in op.outputs:
                if d not in self.out_names:
                    self.out_names.append(d)
        step_fns = {op.step: steps[op.step].fn for op in ops}
        out_names = list(self.out_names)

        def seg_fn(env: dict) -> dict:
            env = dict(env)
            for op in ops:
                out = step_fns[op.step]({d: env[d] for d in op.inputs})
                for d in op.outputs:
                    env[d] = out[d]
            return {d: env[d] for d in out_names}

        self.fn = seg_fn
        self.graphs: dict[tuple, _Graph] = {}  # input signature → graph
        self.calls = 0

    def __call__(
        self, env: dict, device: torch.device
    ) -> tuple[dict | None, bool]:
        """``(outputs, cold)``: ``outputs`` is None when the segment cannot
        be fused; ``cold`` marks a call that paid a capture (or, on the
        CPU, the first call, as the reference's first call pays its
        compile)."""
        if device.type != "cuda":
            cold = self.calls == 0
            out = {}
            for d, v in self.fn(env).items():
                out[d] = _fused_output(v, device)
                if out[d] is None:
                    return None, cold
            return out, cold
        sig = tuple((tuple(env[d].shape), env[d].dtype) for d in self.ext)
        g = self.graphs.get(sig)
        cold = g is None
        if cold:
            g = self._capture(env, device)
            if g is None:
                return None, True
            self.graphs[sig] = g
        if g.static_in:
            torch._foreach_copy_(g.static_in, [env[d] for d in self.ext])
        g.graph.replay()
        outs = [torch.empty_like(t) for t in g.static_out]
        if outs:  # steps that produce no data leave nothing to copy out
            torch._foreach_copy_(outs, g.static_out)
        return dict(zip(self.out_names, outs)), cold

    def _capture(self, env: dict, device: torch.device) -> _Graph | None:
        """Warm up, then capture the segment; None if it cannot be captured.

        An error of the bodies run eagerly (the warm-up), or of a kernel's
        build or launch, propagates; an error raised only under capture (a
        host sync, a copy to the host) means the segment stays interpreted.
        """
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.fn(env)
            cur.wait_stream(side)
            static_in = {d: env[d].clone() for d in self.ext}
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            error = None
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.fn(static_in)
                except Exception as e:
                    error = e
                try:
                    graph.capture_end()  # always: the stream must leave capture
                except RuntimeError as e:  # the capture was invalidated
                    error = error or e
            if isinstance(error, KernelError):
                raise error
            if error is not None:  # not capturable: a host sync, a copy to the host
                return None
            cur.wait_stream(side)
            static_out = [_fused_output(out[d], device) for d in self.out_names]
            if any(t is None for t in static_out):
                return None
            return _Graph(graph, [static_in[d] for d in self.ext], static_out)


@dataclass
class TorchDeviceProgram(BackendProgram):
    # Fused segments, their graphs and their static buffers are shared by
    # every run of this program (run_many runs instances on several
    # threads): a segment call holds this lock from its input copy to its
    # output copy.
    _fuse_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def _device_map(self) -> dict[str, torch.device]:
        devices = self.options.get("devices")
        if devices is None:
            platform = self.options.get("platform", "cuda")
            resolve_device(platform)
            if torch.device(platform).type == "cuda":
                devices = [
                    torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())
                ]
            else:
                devices = [torch.device(platform)]
        else:
            devices = [resolve_device(d) for d in devices]
        locs = sorted(self.program.locations())
        schedule = self.options.get("schedule")
        if schedule is not None and getattr(schedule, "network", None):
            # Placement scheduler hand-down: keep each network group's
            # locations on one contiguous device block, so the cheap links
            # of the cost model map to intra-device placement.
            net = schedule.network
            locs.sort(key=lambda l: (net.group_of(l) or "", l))
            return {
                loc: devices[i * len(devices) // len(locs)]
                for i, loc in enumerate(locs)
            }
        return {loc: devices[i % len(devices)] for i, loc in enumerate(locs)}

    def run(
        self, initial_payloads: Mapping[PayloadKey, Any] | None = None
    ) -> ExecutionResult:
        recorder = None
        if self.options.get("trace"):
            from repro_torch.obs.events import TraceRecorder

            recorder = TraceRecorder()
        device_of = self._device_map()
        stats = {
            "execs": 0,
            "comms": 0,
            "device_puts": 0,
            "bytes_moved": 0,
            "devices": {l: str(d) for l, d in device_of.items()},
        }
        # Uniform fault policy: the deterministic reducer guards each step
        # fire with the shared timeout + retry helper and checks the run
        # deadline once per reduction round.
        policy = self.options.get("policy")
        guard = None
        deadline = Deadline(None)
        if policy is not None:
            guard = StepGuard(
                policy,
                on_retry=None if recorder is None else (
                    lambda step, n, e: record_policy_fire(
                        recorder, "retry", "-", step,
                        time.monotonic(), time.monotonic(),
                    )
                ),
            )
            deadline = Deadline(policy.deadline_s)
            stats["policy"] = {"retries": 0, "timeouts": 0}

        def place(loc: str, value: Any) -> Any:
            if not _is_array(value):
                return value
            stats["device_puts"] += 1
            stats["bytes_moved"] += int(getattr(value, "nbytes", 0))
            dev = device_of[loc]
            if isinstance(value, np.ndarray):
                # A copy, as jax.device_put makes: the store never aliases
                # the caller's array.
                return torch.as_tensor(value).to(dev, copy=True)
            return value.to(dev)

        payloads: dict[PayloadKey, Any] = {}
        for (loc, d), v in (initial_payloads or {}).items():
            payloads[(loc, d)] = place(loc, v)
        if recorder is not None:
            # The first span must not absorb work queued before the run.
            _settle(*set(device_of.values()))

        cursors = {
            lp.location: Cursor(lp) for lp in self.program.programs
        }
        data = {lp.location: set(lp.data) for lp in self.program.programs}
        order = sorted(cursors)

        def fire_one_comm() -> bool:
            hit = first_enabled_comm(cursors, data, order)
            if hit is None:
                return False
            op, src, i, j = hit
            cursors[src].complete(i)
            cursors[op.dst].complete(j)
            data[op.dst].add(op.data)
            payload = payloads[(op.src, op.data)]
            if recorder is not None:
                t0 = time.monotonic()
            payloads[(op.dst, op.data)] = place(op.dst, payload)
            if recorder is not None:
                if device_of[op.src] != device_of[op.dst]:
                    # Only a move between devices queues device work.
                    _settle(device_of[op.src], device_of[op.dst])
                record_comm_fire(
                    recorder, op, t0, time.monotonic(), payload
                )
            stats["comms"] += 1
            return True

        # Fused location programs: straight-line EXEC runs become single
        # calls (segmented at COMM boundaries).  A fault policy guard wraps
        # individual step fires, which a fused call cannot honour, so
        # fusion is skipped when a guard is active.
        fuse = bool(self.options.get("fuse")) and guard is None
        if fuse:
            with self._fuse_lock:
                if not hasattr(self, "_segments"):
                    # Planned once per compiled program; captured graphs
                    # live across run() calls, so repeat runs replay them
                    # (and warm-call bandwidth is what roofline reports).
                    self._segments = _plan_segments(self.program)
                    self._seg_cache: dict[int, Any] = {}
        segments = self._segments if fuse else {}
        seg_cache = self._seg_cache if fuse else {}
        if fuse:
            stats["fused"] = {
                "segments_planned": len(segments),
                "fused_calls": 0,
                "fused_execs": 0,
                "fallbacks": 0,
                "locations": {},
            }
        exec_count = 0

        def run_segment(start: int) -> bool:
            """Fire a whole planned segment as one call.

            Returns False (after caching the verdict) when the segment
            must stay interpreted — non-array inputs, or step bodies that
            cannot be captured; the caller then falls through to the
            op-by-op path for every op in the run.
            """
            acts = segments[start]
            dev = None
            with self._fuse_lock:
                seg = seg_cache.get(start)
                if seg == "eager":
                    return False
                if seg is None:
                    seg = _FusedSegment(acts, self.steps)
                    seg_cache[start] = seg
                env = {d: payloads[(seg.leader, d)] for d in seg.ext}
                if not all(_is_array(v) for v in env.values()):
                    seg_cache[start] = "eager"
                    stats["fused"]["fallbacks"] += 1
                    return False
                dev = device_of[seg.leader]
                if recorder is not None:
                    s0 = time.monotonic()  # the span's clock
                t0 = time.perf_counter()  # the roofline's clock
                out, cold = seg(env, dev)
                if out is None:
                    seg_cache[start] = "eager"
                    stats["fused"]["fallbacks"] += 1
                    return False
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                if recorder is not None:
                    s1 = time.monotonic()
                seg.calls += 1
            moved = sum(
                int(getattr(v, "nbytes", 0)) for v in env.values()
            ) + sum(int(getattr(v, "nbytes", 0)) for v in out.values())
            loc_stats = stats["fused"]["locations"].setdefault(
                seg.leader,
                {"calls": 0, "execs": 0, "bytes": 0, "seconds": 0.0},
            )
            loc_stats["calls"] += 1
            loc_stats["execs"] += len(acts)
            if not cold:
                # A cold call pays warm-up and capture (on the CPU, the
                # first call); only warm calls count toward achieved
                # bandwidth.
                loc_stats["bytes"] += moved
                loc_stats["seconds"] += dt
            stats["fused"]["fused_calls"] += 1
            stats["fused"]["fused_execs"] += len(acts)
            # Replay the run's cursor/data effects from the recorded plan —
            # the values came from the fused call, the bookkeeping (and the
            # replication of Out^D(s) onto every D_i) is unchanged.
            # Outputs already live on the leader's device, so placement only
            # pays for genuinely remote locations.
            for op, picks in acts:
                if recorder is not None:
                    # Every exec of the segment gets the segment's interval,
                    # stamped outside the captured region.
                    record_exec_fire(recorder, op, s0, s1)
                missing = set(op.outputs) - set(out)
                if missing:
                    raise RuntimeError(
                        f"step {op.step!r} did not produce "
                        f"{sorted(missing)}"
                    )
                for loc, i in picks:
                    cursors[loc].complete(i)
                    data[loc].update(op.outputs)
                    for d in op.outputs:
                        payloads[(loc, d)] = (
                            out[d]
                            if device_of[loc] == dev
                            else place(loc, out[d])
                        )
                stats["execs"] += 1
            return True

        max_rounds = int(self.options.get("max_rounds", 1_000_000))
        for _ in range(max_rounds):
            deadline.check()
            progressed = False
            # Drain communications first (they are τ — silent, confluent).
            while fire_one_comm():
                progressed = True
            if fuse and exec_count in segments:
                if run_segment(exec_count):
                    exec_count += len(segments[exec_count])
                    progressed = True
                    continue
            # Deterministic firing order: lowest step name first.
            execs = sorted(
                enabled_exec_picks(cursors, data, order),
                key=lambda pair: pair[0].step,
            )
            if execs:
                op, picks = execs[0]
                leader = min(op.locations)
                inputs = {d: payloads[(leader, d)] for d in op.inputs}
                fn = self.steps[op.step].fn
                if recorder is not None:
                    t0 = time.monotonic()
                if guard is not None:
                    out = guard.fire(op.step, lambda: fn(inputs))
                else:
                    out = fn(inputs)
                if recorder is not None:
                    _settle(device_of[leader])
                    record_exec_fire(recorder, op, t0, time.monotonic())
                missing = set(op.outputs) - set(out)
                if missing:
                    raise RuntimeError(
                        f"step {op.step!r} did not produce {sorted(missing)}"
                    )
                for loc, i in picks:
                    cursors[loc].complete(i)
                    data[loc].update(op.outputs)
                    for d in op.outputs:
                        payloads[(loc, d)] = place(loc, out[d])
                stats["execs"] += 1
                exec_count += 1
                progressed = True
            if not progressed:
                break

        if fuse:
            roofline = {}
            for loc, ls in stats["fused"]["locations"].items():
                achieved = (
                    ls["bytes"] / ls["seconds"] if ls["seconds"] > 0 else 0.0
                )
                peak = hbm_peak(device_of[loc])
                roofline[loc] = {
                    "achieved_bytes_per_s": achieved,
                    "theoretical_bytes_per_s": peak,
                    "fraction_of_roof": achieved / peak if peak else None,
                }
            stats["fused"]["roofline"] = roofline
        if guard is not None:
            stats["policy"] = guard.counts()
        if not all(c.finished() for c in cursors.values()):
            remaining = self.program.remaining_system(
                {l: c.done_flags() for l, c in cursors.items()},
                {l: frozenset(d) for l, d in data.items()},
            )
            raise RuntimeError(
                "torch backend: workflow did not terminate; remaining:\n"
                + remaining.pretty()
            )
        result: dict[str, dict[str, Any]] = {
            loc: {} for loc in self.program.locations()
        }
        for (loc, d), v in payloads.items():
            result.setdefault(loc, {})[d] = v
        profile = None
        if recorder is not None:
            from repro_torch.obs.profile import RunProfile

            profile = RunProfile.from_recorder("torch", recorder)
        return ExecutionResult(
            backend="torch", data=result, stats=stats, profile=profile
        )


class TorchBackend(Backend):
    name = "torch"
    capabilities = frozenset({"mesh", "device-placement"})

    def known_options(self) -> frozenset[str]:
        return super().known_options() | frozenset(
            {"devices", "platform", "max_rounds", "fuse"}
        )

    def compile(
        self,
        program: ExecProgram | WorkflowSystem,
        steps: Mapping[str, StepMeta],
        options: Mapping[str, Any],
    ) -> TorchDeviceProgram:
        return TorchDeviceProgram(
            program=self.lower(program, options),
            steps=dict(steps),
            options=dict(options),
        )


def factory() -> Backend:
    return TorchBackend()
