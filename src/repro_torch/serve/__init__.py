"""``repro_torch.serve`` — the workflow-as-a-service gateway.

A copy of ``repro/serve``: the same routes, status codes, admission
arithmetic and cache, over the port's staged API and backends.

The HTTP front door to the staged pipeline: accept DAG-JSON and ``.swirl``
submissions, compile them through ``trace → optimize → lower → compile``
once, and serve execution requests against a **content-addressed plan
cache** keyed by :meth:`repro_torch.api.Plan.fingerprint`.  Stdlib-only — the
server is a :class:`http.server.ThreadingHTTPServer`, the client keeps one
``http.client`` connection alive — so serving needs no dependencies the
toolchain does not already have.

Layering (each importable and testable without HTTP):

====================  ======================================================
:mod:`.submission`    DAG-JSON / ``.swirl`` bodies → :class:`repro_torch.api.Plan`
                      with typed :class:`SubmissionError`\\ s (never a raw
                      traceback past the gateway)
:mod:`.cache`         fingerprint → compiled-Executable LRU with
                      hit/miss/eviction stats (the service-level extension
                      of the :mod:`repro_torch.api` derive cache)
:mod:`.admission`     API-key → tenant map, per-tenant concurrency quotas,
                      bounded FIFO queues with backpressure, graceful drain
:mod:`.service`       the backend-agnostic core: submit / run / run_many /
                      stats against the cache under admission control
:mod:`.gateway`       the HTTP surface (``POST /v1/workflows``, ``…/run``,
                      ``…/run_many``, ``GET /v1/workflows/{fp}``,
                      ``GET /v1/stats``)
:mod:`.client`        keep-alive :class:`GatewayClient` for examples,
                      benchmarks and tests
====================  ======================================================

Quickstart::

    from repro_torch.serve import Gateway, TenantConfig, WorkflowService

    service = WorkflowService(
        steps={"ingest": ingest_fn, "merge": merge_fn},
        tenants=[TenantConfig("team-a", api_key="ka", max_concurrent=8)],
    )
    with Gateway(service) as gw:
        print(gw.url)          # e.g. http://127.0.0.1:43117
        gw.serve_forever()     # or use GatewayClient against gw.url
"""

from .admission import (  # noqa: F401
    AdmissionController,
    AdmissionRejected,
    TenantConfig,
    UnknownTenantError,
)
from .cache import CacheEntry, PlanCache  # noqa: F401
from .client import GatewayClient, GatewayError  # noqa: F401
from .gateway import Gateway  # noqa: F401
from .service import (  # noqa: F401
    DeadlineExceeded,
    ServiceDraining,
    WorkflowService,
)
from .submission import SubmissionError, compile_submission  # noqa: F401

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "CacheEntry",
    "DeadlineExceeded",
    "Gateway",
    "GatewayClient",
    "GatewayError",
    "PlanCache",
    "ServiceDraining",
    "SubmissionError",
    "TenantConfig",
    "UnknownTenantError",
    "WorkflowService",
    "compile_submission",
]
