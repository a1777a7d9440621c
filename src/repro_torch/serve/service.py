"""The backend-agnostic service core behind the HTTP gateway.

A copy of ``repro/serve/service.py``, over the port's staged API and
backends (``threaded`` by default; ``multiprocess`` runs the steps one OS
process per location, and needs ``start_method="spawn"`` for steps on the
card).

:class:`WorkflowService` owns the four serving concerns and exposes them as
plain methods the gateway (or tests, or an embedding application) calls:

* **submit** — decode a DAG-JSON / ``.swirl`` body
  (:mod:`repro_torch.serve.submission`), compile it through the staged pipeline
  ``trace → optimize → [schedule] → lower → compile`` against the
  service's step registry (the schedule stage runs when the operator
  deploys with a ``network`` cost model — submissions then get
  auto-placement instead of their author's static mapping), and store
  the artifact in the content-addressed cache
  (:mod:`repro_torch.serve.cache`).  Returns the plan fingerprint — the handle
  every later request uses.
* **run / run_many** — execute instances against a cached artifact under
  admission control (:mod:`repro_torch.serve.admission`).  On backends that
  advertise concurrent batches (``threaded``, the default) many requests
  share one compiled Executable; batches stream through the backend's
  persistent ``run_many`` lanes.
* **describe / stats** — :meth:`Plan.explain` output for one fingerprint;
  cache + derive-cache + admission + throughput counters for operators.

Step bodies cannot travel over HTTP: the operator deploys the service with
a **step registry** (name → callable / :class:`StepMeta`), and submissions
may only reference registered steps — an unknown step is a 400-class
:class:`SubmissionError`, caught at submit time, never at run time.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from typing import Any, Mapping, Sequence

from repro_torch import api
from repro_torch.core.compile import StepFn, StepMeta
from repro_torch.serve.admission import (
    AdmissionController,
    TenantConfig,
)
from repro_torch.serve.cache import CacheEntry, PlanCache
from repro_torch.serve.submission import (
    SubmissionError,
    compile_submission,
    parse_payload_keys,
)

__all__ = [
    "DeadlineExceeded",
    "ServiceDraining",
    "WorkflowService",
    "UnknownWorkflowError",
]

logger = logging.getLogger("repro_torch.serve.service")


def _trace_tag() -> str:
    """The request's trace id (bound by the gateway), or ``"-"``."""
    from repro_torch.obs.events import current_trace_id

    return current_trace_id.get() or "-"


def _recoveries_of(result: Any) -> int:
    """Elastic recoveries a backend reported for one instance (0 if none)."""
    stats = getattr(result, "stats", None)
    if isinstance(stats, Mapping):
        return len(stats.get("recoveries") or ())
    return 0

#: The open single-tenant default: embedding apps and quickstarts that do
#: not care about multi-tenancy authenticate with an empty API key.
DEFAULT_TENANTS = (
    TenantConfig("anonymous", api_key="", max_concurrent=32, max_queue=128),
)


class UnknownWorkflowError(KeyError):
    """No cached workflow under the requested fingerprint (HTTP 404)."""

    def __init__(self, fingerprint: str):
        super().__init__(fingerprint)
        self.fingerprint = fingerprint


class ServiceDraining(RuntimeError):
    """The service is shutting down and admits no new work (HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline_s`` elapsed before its run finished (HTTP 504).

    The service **abandons** the run: the worker thread executing it is a
    daemon and its eventual result is never read — sound because SWIRL
    steps are pure, so an orphaned run has no observable effect beyond its
    own (discarded) store.  The admission slot is released immediately, so
    a deadline abort can never leak an in-flight quota unit.
    """

    def __init__(self, deadline_s: float, *, fingerprint: str = ""):
        tag = f" of workflow {fingerprint[:12]}" if fingerprint else ""
        super().__init__(
            f"run{tag} abandoned after its {deadline_s}s deadline"
        )
        self.deadline_s = deadline_s
        self.fingerprint = fingerprint

    def to_json(self) -> dict[str, Any]:
        return {
            "type": "DeadlineExceeded",
            "message": str(self),
            "deadline_s": self.deadline_s,
            "fingerprint": self.fingerprint,
        }


def _recoverable(exc: BaseException) -> bool:
    """Is this failure worth a server-side re-run (tenant ``max_retries``)?

    Worker-process deaths and transient step failures are recoverable —
    the run may succeed on a fresh attempt.  Everything else (permanent
    step errors, submission bugs, deadlocks) is deterministic and retrying
    would only burn the tenant's slot.
    """
    from repro_torch.backends.multiprocess import WorkerFailedError
    from repro_torch.workflow.fault import TransientError

    seen: set[int] = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, (WorkerFailedError, TransientError)):
            return True
        # Backends wrap the failing step's error (e.g. the threaded
        # runtime's "location X failed: ..." RuntimeError) — walk the
        # cause chain to the root.
        cur = cur.__cause__ or cur.__context__
    return False


def _source_digest(body: Any) -> str:
    """Canonical digest of a submission body (dict key order insensitive)."""
    canon = json.dumps(
        body, sort_keys=True, separators=(",", ":"), default=repr
    )
    return hashlib.sha256(canon.encode()).hexdigest()


class WorkflowService:
    """Compile-once/run-many workflow serving (see module docstring).

    ``steps`` is the server-side step registry; ``backend`` defaults to
    ``threaded`` (the one backend whose compiled programs serve concurrent
    batches); ``network`` (a :class:`repro_torch.sched.NetworkModel`) enables the
    optional schedule stage — every compiled submission is auto-placed
    against the cost model via :meth:`Plan.schedule` before lowering;
    ``lower_options`` are passed to :meth:`Plan.lower` verbatim
    (e.g. ``{"timeout_s": 30}``).  ``batch_max_concurrent`` caps the
    *internal* parallelism of any one ``run_many`` batch, independently of
    the per-tenant admission quota (which counts whole requests).
    """

    def __init__(
        self,
        steps: Mapping[str, StepFn | StepMeta],
        *,
        backend: str = "threaded",
        rules: Sequence[str] = ("R1R2",),
        network: Any | None = None,
        tenants: Sequence[TenantConfig] | None = None,
        cache_capacity: int = 128,
        batch_max_concurrent: int = 8,
        admission_timeout_s: float = 120.0,
        lower_options: Mapping[str, Any] | None = None,
    ):
        self.steps = dict(steps)
        self.backend = backend
        self.default_rules = tuple(rules)
        self.network = network
        self.cache = PlanCache(cache_capacity)
        self.admission = AdmissionController(
            tuple(tenants) if tenants is not None else DEFAULT_TENANTS
        )
        self.batch_max_concurrent = batch_max_concurrent
        self.admission_timeout_s = admission_timeout_s
        self.lower_options = dict(lower_options or {})
        self.started_unix = time.time()
        self._counters_lock = threading.Lock()
        self._counters = {
            "submissions": 0,
            "compiles": 0,
            "runs": 0,
            "batches": 0,
            "instances_completed": 0,
            "instances_failed": 0,
            "rejected": 0,
            "recoveries": 0,
            "run_retries": 0,
            "deadline_aborts": 0,
        }

    def _count(self, **deltas: int) -> None:
        with self._counters_lock:
            for key, d in deltas.items():
                self._counters[key] += d

    # -- submit ---------------------------------------------------------------
    def submit(self, body: Any) -> dict[str, Any]:
        """Compile one submission (or hit the cache) → receipt with fingerprint.

        The receipt carries ``cached`` (no compile happened), the plan's
        compile ``timings`` (from :attr:`Plan.timings`, milliseconds) and
        enough metadata for the client to build run payloads.
        """
        self._count(submissions=1)
        if self.admission.draining:
            raise ServiceDraining("service is draining; not accepting work")
        digest = _source_digest(body)
        entry = self.cache.lookup_source(digest)
        if entry is not None:
            return self._receipt(entry, cached=True)
        t0 = time.perf_counter()
        if isinstance(body, Mapping) and "rules" not in body:
            body = dict(body, rules=list(self.default_rules))
        plan, meta = compile_submission(body)
        missing = sorted(set(plan.steps()) - set(self.steps))
        if missing:
            raise SubmissionError(
                f"workflow references steps with no registered body: "
                f"{missing}; registered: {sorted(self.steps)}",
                kind="steps",
            )
        if self.network is not None:
            # Operator-configured auto-placement: re-map steps against the
            # deployment's cost model, then fingerprint the *scheduled*
            # plan so placement-equivalent submissions share one artifact.
            plan = plan.schedule(self.network, steps=self.steps)
        fingerprint = plan.fingerprint()
        existing = self.cache.peek(fingerprint)
        if existing is not None:
            # Same artifact reached from different source text: alias the
            # digest onto it, skip the lower/compile.
            entry = self.cache.put(existing, source_digest=digest)
            return self._receipt(entry, cached=True)
        executable = (
            plan.lower(self.backend, **self.lower_options).compile(self.steps)
        )
        entry = CacheEntry(
            fingerprint=fingerprint,
            plan=plan,
            executable=executable,
            meta=meta,
            compile_seconds=time.perf_counter() - t0,
        )
        entry = self.cache.put(entry, source_digest=digest)
        self._count(compiles=1)
        logger.info(
            "compiled %s in %.1fms [trace_id=%s]",
            fingerprint[:12],
            entry.compile_seconds * 1e3,
            _trace_tag(),
        )
        return self._receipt(entry, cached=False)

    def _receipt(self, entry: CacheEntry, *, cached: bool) -> dict[str, Any]:
        return {
            **entry.summary(),
            "cached": cached,
            "backend": self.backend,
            "timings_ms": {
                label: round(seconds * 1e3, 3)
                for label, seconds in entry.plan.timings
            },
        }

    # -- execute --------------------------------------------------------------
    def _entry(self, fingerprint: str) -> CacheEntry:
        entry = self.cache.get(fingerprint)
        if entry is None:
            raise UnknownWorkflowError(fingerprint)
        return entry

    def _tenant_name(self, tenant: TenantConfig | str | None) -> str:
        name = tenant.name if isinstance(tenant, TenantConfig) else tenant
        if name is None:
            name = self.admission.tenant_names()[0]
        return name

    def _admitted(self, tenant: TenantConfig | str | None):
        return self.admission.admit(
            self._tenant_name(tenant), timeout_s=self.admission_timeout_s
        )

    @staticmethod
    def _check_deadline_s(deadline_s: float | None) -> float | None:
        if deadline_s is None:
            return None
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            raise SubmissionError(
                f"deadline_s must be a positive number, "
                f"got {deadline_s!r}",
                kind="deadline",
            ) from None
        if not deadline_s > 0:
            raise SubmissionError(
                f"deadline_s must be a positive number, got {deadline_s!r}",
                kind="deadline",
            )
        return deadline_s

    def run(
        self,
        fingerprint: str,
        inputs: Any = None,
        *,
        tenant: TenantConfig | str | None = None,
        deadline_s: float | None = None,
    ) -> dict[str, Any]:
        """Execute one instance of a cached workflow; returns its data.

        ``deadline_s`` bounds the request end-to-end (all server-side
        retry attempts included): on overrun the run is abandoned and
        :class:`DeadlineExceeded` raised — the gateway's 504.
        """
        entry = self._entry(fingerprint)
        deadline_s = self._check_deadline_s(deadline_s)
        payloads = parse_payload_keys(
            inputs, entry.plan.system.locations()
        )
        self._count(runs=1)
        with self._admitted(tenant):
            try:
                result = self._run_guarded(
                    entry,
                    lambda exe: exe.run(initial_payloads=payloads),
                    tenant=tenant,
                    deadline_s=deadline_s,
                )
            except Exception as e:
                self._count(instances_failed=1)
                logger.warning(
                    "run %s failed: %s [trace_id=%s]",
                    fingerprint[:12],
                    e,
                    _trace_tag(),
                )
                raise
        self._count(
            instances_completed=1, recoveries=_recoveries_of(result)
        )
        return {"fingerprint": fingerprint, "data": result.data}

    def run_many(
        self,
        fingerprint: str,
        inputs: Sequence[Any],
        *,
        tenant: TenantConfig | str | None = None,
        max_concurrent: int | None = None,
        deadline_s: float | None = None,
    ) -> dict[str, Any]:
        """Execute a batch through the backend's persistent run_many lanes.

        One admission slot covers the whole batch (a tenant cannot inflate
        its quota by batching); internal parallelism is capped by the
        service's ``batch_max_concurrent``.  ``deadline_s`` bounds the
        whole batch, like :meth:`run`.
        """
        entry = self._entry(fingerprint)
        deadline_s = self._check_deadline_s(deadline_s)
        if not isinstance(inputs, Sequence) or isinstance(inputs, (str, bytes)):
            raise SubmissionError(
                "'inputs' must be a list (one object per instance)",
                kind="inputs",
            )
        locations = entry.plan.system.locations()
        payloads = [parse_payload_keys(item, locations) for item in inputs]
        lanes = min(
            self.batch_max_concurrent,
            max_concurrent or self.batch_max_concurrent,
        )
        self._count(batches=1)
        with self._admitted(tenant):
            try:
                results = self._run_guarded(
                    entry,
                    lambda exe: exe.run_many(payloads, max_concurrent=lanes),
                    tenant=tenant,
                    deadline_s=deadline_s,
                )
            except Exception:
                self._count(instances_failed=len(payloads))
                raise
        self._count(
            instances_completed=len(results),
            recoveries=sum(_recoveries_of(r) for r in results),
        )
        return {
            "fingerprint": fingerprint,
            "results": [{"data": r.data} for r in results],
        }

    def _run_guarded(
        self,
        entry: CacheEntry,
        op,
        *,
        tenant: TenantConfig | str | None = None,
        deadline_s: float | None = None,
    ):
        """Run ``op(executable)``, serialising when the backend needs it.

        Backends advertising concurrent batches take no lock — that is the
        cache-hit hot path.  The others (``inprocess``/``multiprocess``/
        ``torch``) are serialised per entry so a burst of requests queues
        instead of tripping :class:`repro_torch.api.ConcurrentRunError`.

        Two per-request fault policies layer on top:

        * the tenant's ``max_retries`` re-runs **recoverable** failures
          (worker death, exhausted transient budget) inside the same
          admission slot, and
        * ``deadline_s`` bounds the request wall-clock; on overrun the
          attempt thread is abandoned (steps are pure — see
          :class:`DeadlineExceeded`) and the slot released at once.  An
          abandoned attempt on a serialised backend may hold the entry's
          run lock until it peters out; only same-fingerprint requests
          queue behind it, never the admission quota.
        """
        exe = entry.executable
        max_retries = self.admission.tenant_config(
            self._tenant_name(tenant)
        ).max_retries

        def locked_op():
            if exe.concurrent_runs:
                return op(exe)
            with entry.run_lock:
                return op(exe)

        def attempt_all(abandoned: threading.Event | None):
            for attempt in range(max_retries + 1):
                try:
                    return locked_op()
                except Exception as e:  # noqa: BLE001 — filtered below
                    last_attempt = attempt == max_retries
                    gone = abandoned is not None and abandoned.is_set()
                    if last_attempt or gone or not _recoverable(e):
                        raise
                    self._count(run_retries=1)
                    logger.warning(
                        "retrying %s after recoverable %s "
                        "(attempt %d/%d) [trace_id=%s]",
                        entry.fingerprint[:12],
                        type(e).__name__,
                        attempt + 1,
                        max_retries,
                        _trace_tag(),
                    )

        if deadline_s is None:
            return attempt_all(None)

        abandoned = threading.Event()
        box: list[tuple[str, Any]] = []
        done = threading.Event()

        def target() -> None:
            try:
                box.append(("ok", attempt_all(abandoned)))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box.append(("err", e))
            finally:
                done.set()

        worker = threading.Thread(
            target=target,
            daemon=True,
            name=f"svc-run-{entry.fingerprint[:12]}",
        )
        worker.start()
        if not done.wait(deadline_s):
            abandoned.set()  # stop any further server-side retries
            self._count(deadline_aborts=1)
            raise DeadlineExceeded(
                deadline_s, fingerprint=entry.fingerprint
            )
        kind, value = box[0]
        if kind == "err":
            raise value
        return value

    # -- introspection ---------------------------------------------------------
    def describe(self, fingerprint: str) -> dict[str, Any]:
        entry = self.cache.peek(fingerprint)
        if entry is None:
            raise UnknownWorkflowError(fingerprint)
        return {
            **entry.summary(),
            "backend": self.backend,
            "placement": {
                s: list(ls) for s, ls in entry.plan.placement().items()
            },
            "explain": entry.plan.explain(),
        }

    def stats(self) -> dict[str, Any]:
        with self._counters_lock:
            counters = dict(self._counters)
        return {
            "uptime_s": round(time.time() - self.started_unix, 3),
            "backend": self.backend,
            "counters": counters,
            "cache": self.cache.stats(),
            "derive_cache": api.compile_cache_stats(),
            "admission": self.admission.stats(),
        }

    def record_rejection(self) -> None:
        """Gateway hook: count a 429 in the service-level counters."""
        self._count(rejected=1)

    # -- shutdown --------------------------------------------------------------
    def drain(self, *, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: reject new work, wait for admitted work."""
        return self.admission.drain(timeout_s=timeout_s)
