"""The HTTP front door — stdlib ``ThreadingHTTPServer`` over the service.

A copy of ``repro/serve/gateway.py``.  Payload values go to JSON as in
the reference (:func:`_jsonable`: numpy first, then ``str``), so a
``torch.Tensor`` in a response turns into its ``str``, as a ``jax.Array``
does there; steps that answer over HTTP return numbers or numpy arrays.

Endpoints (all JSON; auth via the ``X-API-Key`` header, resolved to a
tenant by the admission controller):

=========================================  =================================
``POST /v1/workflows``                     submit DAG-JSON / ``.swirl`` →
                                           ``{fingerprint, cached,
                                           timings_ms, ...}``
``GET  /v1/workflows/{fp}``                plan metadata + ``explain()``
``POST /v1/workflows/{fp}/run``            one instance: ``{"inputs":
                                           {"loc:datum": v}}`` → ``{data}``
``POST /v1/workflows/{fp}/run_many``       batch: ``{"inputs": [...]}`` →
                                           ``{results: [...]}`` through the
                                           backend's run_many lanes
``GET  /v1/stats``                         cache / admission / throughput
``GET  /v1/healthz``                       liveness + drain state +
                                           per-tenant queue depths (no auth)
``GET  /v1/metrics``                       Prometheus text exposition
                                           (no auth)
=========================================  =================================

Observability: every request carries a **trace id** — the caller's
``X-Trace-Id`` header when present, otherwise a generated one — echoed in
the response's ``X-Trace-Id`` header, embedded in every error body, bound
to :data:`repro_torch.obs.events.current_trace_id` for the request's duration,
and attached to the ``repro_torch.serve.gateway`` log records.  Request counts
and latency histograms accumulate in the gateway's
:class:`~repro_torch.obs.metrics.MetricsRegistry`; ``GET /v1/metrics`` merges
them with a scrape-time snapshot of ``WorkflowService.stats()``
(plan-cache hit rate, per-tenant queue depth and rejection counts).

Error contract: every failure is a JSON body ``{"error": {...}}`` — never
a traceback.  ``400`` malformed submission (typed, with line/column for
``.swirl`` syntax errors), ``401`` unknown API key, ``404`` unknown
fingerprint, ``413`` request body over the gateway's ``max_body_bytes``
(typed ``BodyTooLarge`` with the limit and the declared length; the body
is rejected *unread*, so the response also closes the connection), ``429``
quota exhausted (with ``Retry-After``), ``503`` draining, ``504`` run
deadline exceeded (typed ``DeadlineExceeded``; the run is abandoned and
its admission slot released — set a deadline per request with
``"deadline_s"`` in the run/run_many body or the ``X-Deadline-S``
header, body winning when both are present).  HTTP/1.1 with
correct ``Content-Length``, so client connections stay alive across
requests (which is what makes cache-hit serving fast enough to
benchmark).

The server itself is deliberately boring: one thread per connection
(``ThreadingHTTPServer``), all real behaviour lives in
:class:`~repro_torch.serve.service.WorkflowService`.  Shutdown is graceful —
:meth:`Gateway.close` flips the service into draining mode (new work →
``503``/``429``), waits for admitted work to finish, then stops the
accept loop.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from repro_torch.obs.events import current_trace_id
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.admission import AdmissionRejected, UnknownTenantError
from repro_torch.serve.service import (
    DeadlineExceeded,
    ServiceDraining,
    UnknownWorkflowError,
    WorkflowService,
)
from repro_torch.serve.submission import SubmissionError

__all__ = ["BodyTooLarge", "DEFAULT_MAX_BODY_BYTES", "Gateway"]

logger = logging.getLogger("repro_torch.serve.gateway")

#: Default request-body cap.  Submissions and payloads whose declared
#: ``Content-Length`` exceeds the gateway's ``max_body_bytes`` are
#: rejected with a 413 *before a single body byte is read* — the cap runs
#: ahead of auth and admission, so an oversized request can never buffer
#: unbounded memory.  Per-gateway override via ``Gateway(max_body_bytes=…)``.
DEFAULT_MAX_BODY_BYTES = 8 * 1024 * 1024


class BodyTooLarge(ValueError):
    """A request body over the gateway's cap — mapped to HTTP 413."""

    def __init__(self, content_length: int, limit: int):
        super().__init__(
            f"request body of {content_length} bytes exceeds the gateway's "
            f"{limit}-byte limit"
        )
        self.content_length = content_length
        self.limit = limit

    def to_json(self) -> dict[str, Any]:
        return {
            "type": "BodyTooLarge",
            "message": str(self),
            "limit_bytes": self.limit,
            "content_length": self.content_length,
        }

_ROUTES = {
    ("POST", re.compile(r"/v1/workflows\Z")): "submit",
    ("GET", re.compile(r"/v1/workflows/(?P<fp>[0-9a-f]{64})\Z")): "describe",
    ("POST", re.compile(r"/v1/workflows/(?P<fp>[0-9a-f]{64})/run\Z")): "run",
    (
        "POST",
        re.compile(r"/v1/workflows/(?P<fp>[0-9a-f]{64})/run_many\Z"),
    ): "run_many",
    ("GET", re.compile(r"/v1/stats\Z")): "stats",
    ("GET", re.compile(r"/v1/healthz\Z")): "healthz",
    ("GET", re.compile(r"/v1/metrics\Z")): "metrics",
}


def _jsonable(obj: Any) -> Any:
    """JSON fallback for payload values (numpy first, then ``str``)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    return str(obj)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "swirl-gateway/0.1"

    # -- plumbing -------------------------------------------------------------
    #: Set per request by ``_dispatch``; read back for metrics / logging.
    _trace_id = ""
    _last_status = 0

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # request logging goes through the module logger instead

    @property
    def gateway(self) -> "Gateway":
        return self.server.gateway  # type: ignore[attr-defined]

    def _send_payload(
        self,
        status: int,
        payload: bytes,
        *,
        content_type: str,
        headers: dict[str, str] | None = None,
    ) -> None:
        self._last_status = status
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        if self._trace_id:
            self.send_header("X-Trace-Id", self._trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _reply(
        self,
        status: int,
        body: dict[str, Any],
        *,
        headers: dict[str, str] | None = None,
    ) -> None:
        payload = json.dumps(body, default=_jsonable).encode()
        self._send_payload(
            status, payload, content_type="application/json", headers=headers
        )

    def _reply_text(
        self,
        status: int,
        text: str,
        *,
        content_type: str = "text/plain; charset=utf-8",
        headers: dict[str, str] | None = None,
    ) -> None:
        self._send_payload(
            status, text.encode(), content_type=content_type, headers=headers
        )

    def _error(
        self,
        status: int,
        error: dict[str, Any],
        *,
        headers: dict[str, str] | None = None,
    ) -> None:
        if self._trace_id:
            error = {**error, "trace_id": self._trace_id}
        self._reply(status, {"error": error}, headers=headers)

    def _deadline_of(self, body: dict[str, Any]) -> Any:
        """The request's deadline: body ``deadline_s``, else the
        ``X-Deadline-S`` header (body wins).  Returned raw — the service
        validates and maps garbage to a typed 400."""
        if "deadline_s" in body:
            return body["deadline_s"]
        header = (self.headers.get("X-Deadline-S") or "").strip()
        return header or None

    def _read_body(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        limit = self.gateway.max_body_bytes
        if length > limit:
            raise BodyTooLarge(length, limit)
        raw = self.rfile.read(length) if length else b""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype in ("text/plain", "application/x-swirl"):
            return raw.decode("utf-8", errors="replace")
        if not raw:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise SubmissionError(
                f"request body is not valid JSON: {e}",
                kind="json",
                line=e.lineno,
                column=e.colno,
            ) from e

    # -- dispatch -------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def _dispatch(self, method: str) -> None:
        path = self.path.split("?", 1)[0]
        self._trace_id = (
            (self.headers.get("X-Trace-Id") or "").strip()
            or uuid.uuid4().hex[:16]
        )
        self._last_status = 0
        token = current_trace_id.set(self._trace_id)
        route = "unmatched"
        t0 = time.perf_counter()
        try:
            for (m, pattern), name in _ROUTES.items():
                if m != method:
                    continue
                match = pattern.match(path)
                if match:
                    route = name
                    self._handle(name, match.groupdict())
                    return
            self._error(
                404,
                {
                    "type": "NotFound",
                    "message": f"no route {method} {path}",
                    "routes": sorted(
                        f"{m} {p.pattern}" for (m, p) in _ROUTES
                    ),
                },
            )
        finally:
            current_trace_id.reset(token)
            elapsed = time.perf_counter() - t0
            self.gateway.observe_request(
                route, method, self._last_status, elapsed
            )
            logger.info(
                "%s %s -> %d in %.3fms [trace_id=%s]",
                method,
                path,
                self._last_status,
                elapsed * 1e3,
                self._trace_id,
            )

    def _handle(self, name: str, params: dict[str, str]) -> None:
        service = self.gateway.service
        if name == "healthz":
            # Unauthenticated on purpose: load balancers poll this to
            # drain-aware route, so it must never require a tenant key.
            draining = service.admission.draining
            self._reply(
                200,
                {
                    "status": "draining" if draining else "ok",
                    "draining": draining,
                    "tenants": service.admission.queue_depths(),
                },
            )
            return
        if name == "metrics":
            # Also unauthenticated — the Prometheus scrape convention.
            self._reply_text(
                200,
                self.gateway.render_metrics(),
                content_type=MetricsRegistry.CONTENT_TYPE,
            )
            return
        try:
            tenant = service.admission.authenticate(
                self.headers.get("X-API-Key", "")
            )
        except UnknownTenantError:
            self._error(
                401,
                {
                    "type": "Unauthorized",
                    "message": "unknown API key (set the X-API-Key header)",
                },
            )
            return
        try:
            if name == "submit":
                self._reply(200, service.submit(self._read_body()))
            elif name == "describe":
                self._reply(200, service.describe(params["fp"]))
            elif name == "run":
                body = self._read_body() or {}
                if not isinstance(body, dict):
                    raise SubmissionError(
                        "run body must be a JSON object", kind="inputs"
                    )
                self._reply(
                    200,
                    service.run(
                        params["fp"],
                        body.get("inputs"),
                        tenant=tenant,
                        deadline_s=self._deadline_of(body),
                    ),
                )
            elif name == "run_many":
                body = self._read_body() or {}
                if not isinstance(body, dict) or "inputs" not in body:
                    raise SubmissionError(
                        "run_many body must be a JSON object with 'inputs' "
                        "(a list, one entry per instance)",
                        kind="inputs",
                    )
                self._reply(
                    200,
                    service.run_many(
                        params["fp"],
                        body["inputs"],
                        tenant=tenant,
                        max_concurrent=body.get("max_concurrent"),
                        deadline_s=self._deadline_of(body),
                    ),
                )
            elif name == "stats":
                self._reply(200, service.stats())
        except BodyTooLarge as e:
            # The oversized body was never read off the socket, so the
            # connection cannot be reused for a next request — close it.
            self.close_connection = True
            self._error(413, e.to_json(), headers={"Connection": "close"})
        except SubmissionError as e:
            self._error(400, e.to_json())
        except UnknownWorkflowError as e:
            self._error(
                404,
                {
                    "type": "UnknownWorkflow",
                    "message": (
                        f"no cached workflow {e.fingerprint!r}; submit it "
                        "first (POST /v1/workflows)"
                    ),
                },
            )
        except AdmissionRejected as e:
            if e.reason == "draining":
                self._error(
                    503,
                    {"type": "Draining", "message": str(e)},
                    headers={"Retry-After": str(e.retry_after)},
                )
            else:
                service.record_rejection()
                self._error(
                    429,
                    {
                        "type": "AdmissionRejected",
                        "message": str(e),
                        "tenant": e.tenant,
                        "reason": e.reason,
                        "retry_after": e.retry_after,
                    },
                    headers={"Retry-After": str(e.retry_after)},
                )
        except ServiceDraining as e:
            self._error(
                503,
                {"type": "Draining", "message": str(e)},
                headers={"Retry-After": "1"},
            )
        except DeadlineExceeded as e:
            self._error(504, e.to_json())
        except BrokenPipeError:
            raise  # client went away mid-reply; nothing to report to it
        except Exception as e:  # noqa: BLE001 — the no-traceback contract
            logger.exception(
                "unhandled %s in %s [trace_id=%s]",
                type(e).__name__,
                name,
                self._trace_id,
            )
            self._error(
                500,
                {"type": type(e).__name__, "message": str(e)},
            )


class Gateway:
    """Own one HTTP server around a :class:`WorkflowService`.

    ``port=0`` (the default) binds an ephemeral port — read
    :attr:`Gateway.url` after construction.  Use as a context manager or
    call :meth:`start` / :meth:`close` explicitly; :meth:`close` drains
    admitted work before stopping the accept loop, so in-flight
    executions are never dropped.
    """

    def __init__(
        self,
        service: WorkflowService,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
    ):
        if max_body_bytes < 1:
            raise ValueError(
                f"max_body_bytes must be >= 1, got {max_body_bytes}"
            )
        self.max_body_bytes = max_body_bytes
        self.service = service
        self.metrics = MetricsRegistry()
        self._requests = self.metrics.counter(
            "gateway_requests_total",
            "HTTP requests handled, by route / method / status.",
        )
        self._latency = self.metrics.histogram(
            "gateway_request_seconds",
            "Wall-clock request latency in seconds, by route.",
        )
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.gateway = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    # -- addresses ------------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    # -- observability ---------------------------------------------------------
    def observe_request(
        self, route: str, method: str, status: int, seconds: float
    ) -> None:
        """Handler hook: record one finished request in the registry."""
        self._requests.inc(route=route, method=method, status=str(status))
        self._latency.observe(seconds, route=route)

    def render_metrics(self) -> str:
        """Prometheus text page: request metrics + a service snapshot.

        Snapshot-sourced families (cache, admission, counters) are set
        absolutely at scrape time from :meth:`WorkflowService.stats`, so
        the service keeps its single source of truth and the exposition
        never drifts from ``GET /v1/stats``.
        """
        stats = self.service.stats()
        m = self.metrics
        m.gauge(
            "gateway_uptime_seconds", "Seconds since the service started."
        ).set(stats["uptime_s"])
        counters = m.counter(
            "service_operations_total",
            "Service-level operation counters, by kind.",
        )
        for kind, value in stats["counters"].items():
            counters.set(value, kind=kind)
        cache = stats["cache"]
        for key in ("hits", "misses", "evictions"):
            m.counter(
                f"plan_cache_{key}_total", f"Plan-cache {key}."
            ).set(cache.get(key, 0))
        m.gauge(
            "plan_cache_hit_rate", "Plan-cache hit rate over its lifetime."
        ).set(cache.get("hit_rate", 0.0))
        m.gauge("plan_cache_entries", "Compiled plans resident.").set(
            cache.get("entries", 0)
        )
        m.gauge(
            "plan_cache_compile_seconds_saved",
            "Compile time avoided by cache hits.",
        ).set(cache.get("compile_seconds_saved", 0.0))
        admission = stats["admission"]
        m.gauge(
            "gateway_draining", "1 while the gateway drains, else 0."
        ).set(1.0 if admission["draining"] else 0.0)
        queued = m.gauge(
            "tenant_queue_depth", "Requests waiting for a slot, per tenant."
        )
        active = m.gauge(
            "tenant_active_runs", "Admitted in-flight runs, per tenant."
        )
        rejected = m.counter(
            "tenant_rejected_total",
            "Admission rejections (HTTP 429), per tenant.",
        )
        for tenant, snap in admission["tenants"].items():
            queued.set(snap["queued"], tenant=tenant)
            active.set(snap["active"], tenant=tenant)
            rejected.set(snap["rejected"], tenant=tenant)
        return m.render()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "Gateway":
        """Serve on a daemon thread; returns immediately."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="swirl-gateway",
                daemon=True,
            )
            self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (blocks until :meth:`close`)."""
        self._httpd.serve_forever()

    def close(self, *, drain_timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: drain admitted work, then stop accepting.

        Returns ``True`` when every admitted run finished inside the
        timeout (the in-flight guarantee the overload benchmark asserts).
        """
        drained = self.service.drain(timeout_s=drain_timeout_s)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None
        return drained

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
