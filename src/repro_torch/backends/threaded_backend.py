"""``threaded`` backend — decentralised per-location threads over channels.

A copy of ``repro/backends/threaded_backend.py``.  Like the reference's it
places and moves no payload: arrays reach the card through the caller's
steps and initial payloads (``torch.Tensor`` on ``cuda``), and every
location's store holds the very objects its steps returned.

This is the execution model of the paper's generated TCP programs: every
location interprets only its own per-location program
(:class:`~repro_torch.exec.program.LocationProgram` op arrays — no central
orchestrator, no trace trees).  Channel fault injection (drops / delays,
seeded per endpoint) threads through the ``Lowered`` options, which is how
the fault-tolerance experiments select their failure model.

``run_many`` shares **one** transport across the whole batch: each
instance's channel endpoints are namespaced by an instance tag, so many
workflow instances stream through the same wire concurrently while the
compiled program is reused untouched.  Tags carry a process-unique batch
prefix (``b3.17`` = instance 17 of batch 3), so *whole batches* may also
overlap: a compiled ``ThreadedProgram`` builds no mutable program-level
state per run — every run gets its own transport (unless the caller passed
a shared one) and its own runtimes — which is why it advertises
``concurrent_batches`` and one Executable can serve many concurrent
batches (the serving gateway's cache-hit hot path).
"""

from __future__ import annotations

import itertools
from typing import Any, Mapping, Sequence

from repro_torch.core.compile import StepMeta
from repro_torch.core.syntax import WorkflowSystem
from repro_torch.exec.program import ExecProgram

from .base import (
    DEFAULT_MAX_CONCURRENT,
    Backend,
    BackendProgram,
    ExecutionResult,
    PayloadKey,
)


#: Process-unique batch sequence: prefixes every batch's instance tags so
#: concurrent run_many batches can never collide on channel endpoints,
#: even when the caller shares one transport across batches.
_BATCH_SEQ = itertools.count()


class ThreadedProgram(BackendProgram):
    def concurrent_batches(self) -> bool:
        # Runs are isolated by construction (fresh transport per run,
        # batch-unique endpoint tags) — except when the caller supplied a
        # shared transport/registry, where a concurrent *untagged* run()
        # could collide with another run's endpoints.
        return "transport" not in self.options and "channels" not in self.options

    def _make_transport(self, opts: dict[str, Any]):
        from repro_torch.workflow.channels import ChannelRegistry
        from repro_torch.workflow.transport import InMemoryTransport, Transport

        transport = opts.pop("transport", None)
        registry = opts.pop("channels", None)
        channel_kwargs = {
            k: opts.pop(k)
            for k in ("drop_prob", "delay_s", "seed")
            if k in opts
        }
        if transport is not None:
            if not isinstance(transport, Transport):
                raise TypeError(
                    "transport= must be a repro_torch.workflow.Transport instance "
                    f"(got {type(transport).__name__}); named transports "
                    "need per-run addresses — construct one explicitly"
                )
            if registry is not None or channel_kwargs:
                raise TypeError(
                    "pass either transport= or channel options "
                    "(channels=/drop_prob/delay_s/seed), not both"
                )
        else:
            if registry is None:
                registry = ChannelRegistry(**channel_kwargs)
            elif channel_kwargs:
                raise TypeError(
                    "pass either channels= or per-channel options "
                    f"({sorted(channel_kwargs)}), not both"
                )
            transport = InMemoryTransport(registry)
        return transport

    def _local_steps(self) -> dict[str, dict[str, StepMeta]]:
        return {
            lp.location: {
                s: self.steps[s] for s in lp.exec_step_names()
            }
            for lp in self.program.programs
        }

    @staticmethod
    def _make_recorder(opts: dict[str, Any]):
        if not opts.pop("trace", False):
            return None
        from repro_torch.obs.events import TraceRecorder

        return TraceRecorder()

    @staticmethod
    def _profile(recorder):
        if recorder is None:
            return None
        from repro_torch.obs.profile import RunProfile

        # Lazy: detaches the raw buffers; spans materialise on first
        # access, not per instance on the run_many hot path.
        return RunProfile.from_recorder("threaded", recorder)

    def run(
        self, initial_payloads: Mapping[PayloadKey, Any] | None = None
    ) -> ExecutionResult:
        from repro_torch.workflow.threaded import ThreadedProgramRuntime

        opts = dict(self.options)
        opts.pop("schedule", None)  # placement already baked into the IR
        timeout_s = float(opts.pop("timeout_s", 60.0))
        policy = opts.pop("policy", None)
        recorder = self._make_recorder(opts)
        transport = self._make_transport(opts)
        rt = ThreadedProgramRuntime(
            self.program.by_location,
            self._local_steps(),
            initial_payloads=initial_payloads,
            transport=transport,
            timeout_s=timeout_s,
            recorder=recorder,
            policy=policy,
        )
        data = rt.run()
        stats = transport.stats()
        if policy is not None:
            stats["policy"] = rt._guard.counts() if rt._guard else {}
            stats["recoveries"] = list(rt.recoveries)
        return ExecutionResult(
            backend="threaded",
            data={loc: dict(d) for loc, d in data.items()},
            stats=stats,
            profile=self._profile(recorder),
        )

    def run_many(
        self,
        inputs: Sequence[Mapping[PayloadKey, Any] | None],
        *,
        max_concurrent: int = DEFAULT_MAX_CONCURRENT,
    ) -> list[ExecutionResult]:
        """Pipelined batch execution over one shared transport.

        Instead of spawning fresh location threads per instance (the
        dominant cost at serving scale), the batch runs on a **persistent
        serving pool**: ``lanes × |locations|`` long-lived threads, each
        streaming its lane's instances through one location's op array,
        plus one shared branch pool for parallel trace branches.  Channel
        endpoints are namespaced per instance, so up to ``max_concurrent``
        instances are in flight on the same transport concurrently.
        """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.workflow.threaded import (
            ThreadedProgramRuntime,
            total_par_branches,
        )

        inputs = list(inputs)
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}"
            )
        if not inputs:
            return []
        opts = dict(self.options)
        opts.pop("schedule", None)
        timeout_s = float(opts.pop("timeout_s", 60.0))
        tracing = bool(opts.pop("trace", False))
        policy = opts.pop("policy", None)
        transport = self._make_transport(opts)
        batch_tag = f"b{next(_BATCH_SEQ)}"
        programs = self.program.by_location
        local_steps = self._local_steps()
        lanes = min(max_concurrent, len(inputs))
        n_branches = total_par_branches(programs)
        branch_pool = (
            ThreadPoolExecutor(
                max_workers=lanes * n_branches,
                thread_name_prefix="swirl-serve-branch",
            )
            if n_branches
            else None
        )
        # One pre-built runtime per instance: cheap (dict setup only —
        # programs, step registries and control specs are shared), and the
        # per-instance endpoint tag keeps the shared transport partitioned.
        recorders = [None] * len(inputs)
        if tracing:
            from repro_torch.obs.events import TraceRecorder

            recorders = [TraceRecorder() for _ in inputs]
        runtimes = [
            ThreadedProgramRuntime(
                programs,
                local_steps,
                initial_payloads=payloads,
                transport=transport,
                timeout_s=timeout_s,
                instance_tag=f"{batch_tag}.{i}",
                branch_pool=branch_pool,
                validate=False,  # compile() already checked coverage
                recorder=recorders[i],
                policy=policy,
            )
            for i, payloads in enumerate(inputs)
        ]

        def lane_worker(lane: int, loc: str) -> None:
            for idx in range(lane, len(runtimes), lanes):
                runtimes[idx]._run_location(loc)

        threads = [
            threading.Thread(
                target=lane_worker,
                args=(lane, loc),
                name=f"swirl-serve-{lane}-{loc}",
                daemon=True,
            )
            for lane in range(lanes)
            for loc in sorted(programs)
        ]
        try:
            for th in threads:
                th.start()
            per_lane = -(-len(runtimes) // lanes)  # ceil
            deadline_join = timeout_s * per_lane
            for th in threads:
                th.join(deadline_join)
                if th.is_alive():
                    for rt in runtimes:
                        rt._raise_first_error()
                    raise TimeoutError(
                        "a serving lane did not finish its instances"
                    )
        finally:
            if branch_pool is not None:
                branch_pool.shutdown(wait=False, cancel_futures=True)
        # Transport stats are whole-batch aggregates (one shared wire);
        # each result gets its own copy, marked as such, so per-run
        # consumers can tell batch totals from single-run counts and a
        # mutation through one result never aliases the others.
        stats = transport.stats()
        results = []
        for rt, recorder in zip(runtimes, recorders):
            rt._raise_first_error()
            extra: dict[str, Any] = {}
            if policy is not None:
                extra = {
                    "policy": rt._guard.counts() if rt._guard else {},
                    "recoveries": list(rt.recoveries),
                }
            results.append(
                ExecutionResult(
                    backend="threaded",
                    data={loc: dict(d) for loc, d in rt.data.items()},
                    stats=dict(stats, batch_instances=len(runtimes), **extra),
                    profile=self._profile(recorder),
                )
            )
        return results


class ThreadedBackend(Backend):
    name = "threaded"
    capabilities = frozenset({"decentralised", "fault-injection", "serve"})

    def known_options(self) -> frozenset[str]:
        return super().known_options() | frozenset(
            {
                "channels",
                "transport",
                "drop_prob",
                "delay_s",
                "seed",
                "timeout_s",
            }
        )

    def compile(
        self,
        program: ExecProgram | WorkflowSystem,
        steps: Mapping[str, StepMeta],
        options: Mapping[str, Any],
    ) -> ThreadedProgram:
        return ThreadedProgram(
            program=self.lower(program, options),
            steps=dict(steps),
            options=dict(options),
        )


def factory() -> Backend:
    return ThreadedBackend()
