"""A small keep-alive client for the gateway (stdlib :mod:`http.client`).

A copy of ``repro/serve/client.py``.

Used by the benchmark harness, the CI smoke example and tests; also the
reference for writing clients in other languages.  One
:class:`GatewayClient` holds one persistent HTTP/1.1 connection — reuse
it from a single thread (create one per worker thread for load
generation); it reconnects transparently when the server closes the
connection between requests.

Non-2xx responses raise :class:`GatewayError` carrying the decoded JSON
error body and, for 429/503, the server's ``Retry-After``.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Any, Mapping, Sequence

__all__ = ["GatewayClient", "GatewayError"]


class GatewayError(RuntimeError):
    """A non-2xx gateway response, with the decoded JSON error body."""

    def __init__(self, status: int, payload: Any, *, retry_after: int = 0):
        error = (
            payload.get("error", payload) if isinstance(payload, dict)
            else payload
        )
        message = (
            error.get("message", str(error)) if isinstance(error, dict)
            else str(error)
        )
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.payload = payload
        self.error = error if isinstance(error, dict) else {}
        #: Server-suggested back-off in seconds (0 when absent).
        self.retry_after = retry_after


class GatewayClient:
    """One keep-alive connection to a gateway at ``http://host:port``."""

    def __init__(
        self,
        url: str,
        *,
        api_key: str = "",
        timeout_s: float = 60.0,
    ):
        if url.startswith("http://"):
            url = url[len("http://"):]
        elif url.startswith("https://"):
            raise ValueError("the gateway speaks plain HTTP")
        self._netloc = url.rstrip("/")
        self.api_key = api_key
        self.timeout_s = timeout_s
        self._conn: http.client.HTTPConnection | None = None

    # -- transport ------------------------------------------------------------
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self._netloc, timeout=self.timeout_s
            )
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _request(
        self,
        method: str,
        path: str,
        body: Any = None,
        *,
        content_type: str = "application/json",
        raw: bool = False,
    ) -> Any:
        if isinstance(body, (str, bytes)):
            payload = body.encode() if isinstance(body, str) else body
        elif body is not None:
            payload = json.dumps(body).encode()
        else:
            payload = None
        headers = {"X-API-Key": self.api_key}
        if payload is not None:
            headers["Content-Type"] = content_type
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                break
            except (
                http.client.RemoteDisconnected,
                BrokenPipeError,
                ConnectionResetError,
            ):
                # Stale keep-alive connection: reconnect once.
                self.close()
                if attempt:
                    raise
        data = resp.read()
        if resp.status >= 400:
            try:
                decoded = json.loads(data) if data else None
            except json.JSONDecodeError:
                decoded = data.decode("utf-8", errors="replace")
            retry_after = int(resp.getheader("Retry-After") or 0)
            raise GatewayError(resp.status, decoded, retry_after=retry_after)
        if raw:
            return data.decode("utf-8", errors="replace")
        return json.loads(data) if data else None

    # -- API ------------------------------------------------------------------
    def submit(self, body: Any) -> dict[str, Any]:
        """POST a workflow (DAG-JSON object or raw ``.swirl`` text)."""
        if isinstance(body, str):
            return self._request(
                "POST", "/v1/workflows", body, content_type="text/plain"
            )
        return self._request("POST", "/v1/workflows", body)

    def describe(self, fingerprint: str) -> dict[str, Any]:
        return self._request("GET", f"/v1/workflows/{fingerprint}")

    def run(
        self,
        fingerprint: str,
        inputs: Mapping[str, Any] | None = None,
        *,
        deadline_s: float | None = None,
    ) -> dict[str, Any]:
        """One instance.  ``deadline_s`` caps the server-side run — on
        overrun the gateway answers a typed 504 (:class:`GatewayError`
        with ``status == 504``)."""
        body: dict[str, Any] = {"inputs": dict(inputs or {})}
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        return self._request(
            "POST", f"/v1/workflows/{fingerprint}/run", body
        )

    def run_many(
        self,
        fingerprint: str,
        inputs: Sequence[Mapping[str, Any]],
        *,
        max_concurrent: int | None = None,
        deadline_s: float | None = None,
    ) -> dict[str, Any]:
        body: dict[str, Any] = {"inputs": [dict(i) for i in inputs]}
        if max_concurrent is not None:
            body["max_concurrent"] = max_concurrent
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        return self._request(
            "POST", f"/v1/workflows/{fingerprint}/run_many", body
        )

    def run_with_backoff(
        self,
        fingerprint: str,
        inputs: Mapping[str, Any] | None = None,
        *,
        max_attempts: int = 5,
        max_sleep_s: float = 5.0,
    ) -> dict[str, Any]:
        """Like :meth:`run`, but honours ``Retry-After`` on 429 responses."""
        for attempt in range(max_attempts):
            try:
                return self.run(fingerprint, inputs)
            except GatewayError as e:
                if e.status != 429 or attempt == max_attempts - 1:
                    raise
                time.sleep(min(max_sleep_s, e.retry_after or 1))
        raise AssertionError("unreachable")

    def stats(self) -> dict[str, Any]:
        return self._request("GET", "/v1/stats")

    def healthz(self) -> dict[str, Any]:
        return self._request("GET", "/v1/healthz")

    def metrics(self) -> str:
        """The Prometheus text exposition page, verbatim."""
        return self._request("GET", "/v1/metrics", raw=True)
