"""Multi-tenant admission control: quotas, FIFO queues, backpressure.

A copy of ``repro/serve/admission.py``.

Every execution request enters through :meth:`AdmissionController.admit`:

* each tenant (authenticated by API key) holds at most ``max_concurrent``
  runs *in flight*;
* up to ``max_queue`` further requests wait in a strict **per-tenant FIFO**
  (a waiter is only granted a slot when every earlier waiter of the same
  tenant has been granted one);
* beyond that the request is rejected immediately with
  :class:`AdmissionRejected` — the gateway maps it to ``429`` with a
  ``Retry-After`` computed from the tenant's recent run durations and
  current backlog;
* :meth:`AdmissionController.drain` flips the controller into draining
  mode (new requests rejected, mapped to ``503``) and waits for every
  admitted run — active *and* already queued — to finish, which is what
  makes gateway shutdown graceful: accepted work is never dropped.

Pure :mod:`threading`; no HTTP concepts leak in (the gateway owns status
codes and headers).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator
from contextlib import contextmanager

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "TenantConfig",
    "UnknownTenantError",
]


class UnknownTenantError(KeyError):
    """No tenant is registered under the presented API key / name."""


class AdmissionRejected(RuntimeError):
    """The tenant's quota and queue are exhausted (or the service drains).

    ``retry_after`` is the suggested client back-off in whole seconds;
    ``reason`` is ``"quota"`` (queue full), ``"timeout"`` (queued longer
    than the caller's patience) or ``"draining"``.
    """

    def __init__(self, tenant: str, *, retry_after: int, reason: str):
        super().__init__(
            f"tenant {tenant!r} admission rejected ({reason}); "
            f"retry after {retry_after}s"
        )
        self.tenant = tenant
        self.retry_after = retry_after
        self.reason = reason


@dataclass(frozen=True)
class TenantConfig:
    """One tenant's identity and quotas.

    ``max_concurrent`` bounds in-flight runs; ``max_queue`` bounds the
    backlog waiting for a slot (0 = reject as soon as the quota is full).
    A :meth:`run_many` batch counts as **one** admission — its internal
    instance parallelism is bounded separately by the service's batch
    concurrency, so a tenant cannot multiply its quota by batching.

    ``max_retries`` is the tenant's *server-side* fault policy: the service
    transparently re-runs a request that failed with a **recoverable**
    backend error (a worker crash or a ``TransientError`` that exhausted
    the backend's own budget) up to this many extra times, all inside the
    tenant's single admission slot.  0 (the default) means failures
    surface to the client immediately.
    """

    name: str
    api_key: str
    max_concurrent: int = 8
    max_queue: int = 16
    max_retries: int = 0

    def __post_init__(self) -> None:
        if self.max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {self.max_concurrent}"
            )
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )


class _Ticket:
    __slots__ = ("event", "granted")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.granted = False


@dataclass
class _TenantState:
    cfg: TenantConfig
    lock: threading.Lock = field(default_factory=threading.Lock)
    active: int = 0
    queue: "deque[_Ticket]" = field(default_factory=deque)
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    queued_peak: int = 0
    #: EWMA of recent run durations — the Retry-After estimator.
    run_seconds_avg: float = 0.0

    def snapshot(self) -> dict[str, Any]:
        with self.lock:
            return {
                "active": self.active,
                "queued": len(self.queue),
                "queued_peak": self.queued_peak,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "max_concurrent": self.cfg.max_concurrent,
                "max_queue": self.cfg.max_queue,
                "run_seconds_avg": round(self.run_seconds_avg, 6),
            }


class AdmissionController:
    """Admission across a fixed tenant set (see module docstring)."""

    def __init__(self, tenants: Iterable[TenantConfig]):
        self._tenants: dict[str, _TenantState] = {}
        self._by_key: dict[str, TenantConfig] = {}
        for cfg in tenants:
            if cfg.name in self._tenants:
                raise ValueError(f"duplicate tenant name {cfg.name!r}")
            if cfg.api_key in self._by_key:
                raise ValueError(
                    f"tenants {self._by_key[cfg.api_key].name!r} and "
                    f"{cfg.name!r} share an API key"
                )
            self._tenants[cfg.name] = _TenantState(cfg)
            self._by_key[cfg.api_key] = cfg
        if not self._tenants:
            raise ValueError("admission needs at least one tenant")
        self._draining = False
        self._drain_lock = threading.Lock()
        #: Signalled whenever admitted work shrinks (a slot released or a
        #: queued ticket abandoned) — what :meth:`drain` sleeps on.  Never
        #: held together with a tenant lock from the notifying side; the
        #: waiting side acquires tenant locks only *inside* it, so the lock
        #: order is always ``_idle`` → ``st.lock``.
        self._idle = threading.Condition()

    # -- identity ------------------------------------------------------------
    def authenticate(self, api_key: str) -> TenantConfig:
        cfg = self._by_key.get(api_key)
        if cfg is None:
            raise UnknownTenantError("unknown API key")
        return cfg

    def tenant_names(self) -> list[str]:
        return list(self._tenants)

    def tenant_config(self, name: str) -> TenantConfig:
        """The registered :class:`TenantConfig` for ``name``."""
        st = self._tenants.get(name)
        if st is None:
            raise UnknownTenantError(name)
        return st.cfg

    @property
    def draining(self) -> bool:
        return self._draining

    # -- admission -----------------------------------------------------------
    def _retry_after(self, st: _TenantState) -> int:
        """Estimated seconds until a queue slot frees (clamped 1..60).

        Backlog ahead of a new arrival is ``active + queued`` runs over
        ``max_concurrent`` servers; each takes ~the tenant's EWMA run
        duration (1s floor when nothing has completed yet).
        """
        per_run = st.run_seconds_avg or 1.0
        backlog = st.active + len(st.queue)
        return max(
            1, min(60, math.ceil(per_run * backlog / st.cfg.max_concurrent))
        )

    def acquire(self, tenant: str, *, timeout_s: float = 120.0) -> None:
        """Take one run slot for ``tenant``, waiting in FIFO if saturated."""
        st = self._tenants[tenant]
        with st.lock:
            if self._draining:
                raise AdmissionRejected(
                    tenant, retry_after=1, reason="draining"
                )
            # A free slot is only taken directly when nobody is queued —
            # otherwise a late arrival would overtake the FIFO.
            if st.active < st.cfg.max_concurrent and not st.queue:
                st.active += 1
                st.admitted += 1
                return
            if len(st.queue) >= st.cfg.max_queue:
                st.rejected += 1
                raise AdmissionRejected(
                    tenant,
                    retry_after=self._retry_after(st),
                    reason="quota",
                )
            ticket = _Ticket()
            st.queue.append(ticket)
            st.queued_peak = max(st.queued_peak, len(st.queue))
        if ticket.event.wait(timeout_s):
            return
        with st.lock:
            if ticket.granted:
                # Granted in the race between timeout and re-lock: keep it.
                return
            st.queue.remove(ticket)
            st.rejected += 1
            rejection = AdmissionRejected(
                tenant, retry_after=self._retry_after(st), reason="timeout"
            )
        with self._idle:
            self._idle.notify_all()  # the abandoned ticket shrank the queue
        raise rejection

    def release(self, tenant: str, *, run_seconds: float = 0.0) -> None:
        """Return a slot; the longest-waiting queued request gets it."""
        st = self._tenants[tenant]
        with st.lock:
            st.active -= 1
            st.completed += 1
            if run_seconds > 0:
                st.run_seconds_avg = (
                    run_seconds
                    if st.run_seconds_avg == 0.0
                    else 0.8 * st.run_seconds_avg + 0.2 * run_seconds
                )
            if st.queue and st.active < st.cfg.max_concurrent:
                ticket = st.queue.popleft()
                ticket.granted = True
                st.active += 1
                st.admitted += 1
                ticket.event.set()
        with self._idle:
            self._idle.notify_all()  # admitted work shrank (or handed over)

    @contextmanager
    def admit(
        self, tenant: str, *, timeout_s: float = 120.0
    ) -> Iterator[None]:
        """``with admission.admit(name): run(...)`` — acquire + timed release."""
        self.acquire(tenant, timeout_s=timeout_s)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.release(tenant, run_seconds=time.perf_counter() - t0)

    # -- shutdown ------------------------------------------------------------
    def drain(self, *, timeout_s: float = 30.0) -> bool:
        """Reject new work, wait for admitted work (active + queued) to end.

        Returns ``True`` when everything finished within ``timeout_s``.
        Idempotent; there is deliberately no un-drain — a drained
        controller belongs to a gateway that is shutting down.
        """
        with self._drain_lock:
            self._draining = True
        deadline = time.monotonic() + timeout_s
        # Event-driven rather than a 10ms busy-poll: `release`/the queue-
        # timeout path notify `_idle` whenever admitted work shrinks, and
        # every tenant read below happens under that tenant's lock (the
        # same discipline as `queue_depths`).  Holding `_idle` across the
        # predicate check closes the check-then-wait race: a notify cannot
        # slip between seeing work outstanding and going to sleep.
        with self._idle:
            while not self._all_idle():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._all_idle()
                self._idle.wait(remaining)
        return True

    def _all_idle(self) -> bool:
        """Locked read: no tenant has active or queued admitted work."""
        for st in self._tenants.values():
            with st.lock:
                if st.active or st.queue:
                    return False
        return True

    # -- introspection ---------------------------------------------------------
    def queue_depths(self) -> dict[str, dict[str, int]]:
        """Per-tenant ``{queued, active}`` — the drain-aware routing view.

        A strict subset of :meth:`stats`, cheap enough for load balancers
        to poll through the unauthenticated health endpoint.
        """
        depths: dict[str, dict[str, int]] = {}
        for name, st in self._tenants.items():
            with st.lock:
                depths[name] = {"queued": len(st.queue), "active": st.active}
        return depths

    def stats(self) -> dict[str, Any]:
        return {
            "draining": self._draining,
            "tenants": {
                name: st.snapshot() for name, st in self._tenants.items()
            },
        }
