"""The port's serving gateway (``repro_torch.serve``) against the reference's.

``repro_torch.serve`` is a copy of ``repro.serve``.  The reference's
``tests/test_gateway.py`` cases run here on the port: submission decoding
with typed errors, content addressing and the LRU, execution over HTTP,
admission control (quotas, FIFO queues, ``429`` with ``Retry-After``,
``401``/``404``, graceful drain) and observability.  Then one differential
test sends the same requests to both packages' gateways and holds their
status codes and JSON bodies equal, with request ids and timings removed.
"""

from __future__ import annotations

import json
import re
import threading
import time

import pytest
import torch

from repro_torch import swirl
from repro_torch.core.parser import dumps
from repro_torch.serve import (
    AdmissionController,
    AdmissionRejected,
    Gateway,
    GatewayClient,
    GatewayError,
    PlanCache,
    SubmissionError,
    TenantConfig,
    UnknownTenantError,
    WorkflowService,
)
from repro_torch.serve.cache import CacheEntry
from repro_torch.serve.submission import compile_submission


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGES = {"prep": ["work"], "work": ["sink"], "sink": []}
MAPPING = {"prep": ["l1"], "work": ["l2"], "sink": ["l1"]}
DAG_BODY = {"dag": {"edges": EDGES, "mapping": MAPPING}}


def step_registry(sleep_s: float = 0.0):
    def prep(inp):
        if sleep_s:
            time.sleep(sleep_s)
        return {"d^prep": [1]}

    return {
        "prep": prep,
        "work": lambda inp: {"d^work": inp["d^prep"] + [2]},
        "sink": lambda inp: {},
    }


@pytest.fixture
def service():
    return WorkflowService(step_registry())


@pytest.fixture
def gateway(service):
    with Gateway(service) as gw:
        yield gw


@pytest.fixture
def client(gateway):
    with GatewayClient(gateway.url) as c:
        yield c


# ---------------------------------------------------------------------------
# Submission decoding
# ---------------------------------------------------------------------------


class TestSubmission:
    def test_dag_body_compiles(self):
        plan, meta = compile_submission(dict(DAG_BODY, rules=["R1R2"]))
        assert set(plan.steps()) == {"prep", "work", "sink"}
        assert meta == {"format": "dag", "rules": ["R1R2"]}

    def test_swirl_body_compiles(self):
        text = dumps(compile_submission(dict(DAG_BODY, rules=[]))[0].system)
        plan, meta = compile_submission({"swirl": text})
        assert set(plan.steps()) == {"prep", "work", "sink"}
        assert meta["format"] == "swirl"

    def test_raw_string_is_swirl(self):
        text = dumps(compile_submission(dict(DAG_BODY, rules=[]))[0].system)
        plan, _ = compile_submission(text)
        assert set(plan.steps()) == {"prep", "work", "sink"}

    @pytest.mark.parametrize(
        "body, kind",
        [
            (42, "schema"),
            ({"dag": DAG_BODY["dag"], "swirl": "x"}, "schema"),
            ({"frobnicate": 1}, "schema"),
            ({"swirl": ""}, "schema"),
            ({"swirl": "<l,{},bogus(s)>"}, "swirl-syntax"),
            ({"dag": {"edges": {}}}, "dag"),
            ({"dag": {"edges": EDGES}}, "dag"),
            (
                {"dag": {"edges": EDGES, "mapping": {"prep": ["l1"]}}},
                "dag",
            ),
            (
                {
                    "dag": {
                        "edges": {"a.b": ["c"], "c": []},
                        "mapping": {"a.b": ["l"], "c": ["l"]},
                    }
                },
                "dag",
            ),
            (
                {
                    "dag": dict(
                        DAG_BODY["dag"], initial_data={"l1": ["nope"]}
                    )
                },
                "dag",
            ),
            (dict(DAG_BODY, rules=["R99"]), "rules"),
            (dict(DAG_BODY, rules="R1R2"), "rules"),
        ],
    )
    def test_malformed_bodies_are_typed_errors(self, body, kind):
        with pytest.raises(SubmissionError) as exc:
            compile_submission(body)
        assert exc.value.kind == kind
        assert exc.value.to_json()["type"] == "SubmissionError"

    def test_swirl_syntax_error_carries_position(self):
        with pytest.raises(SubmissionError) as exc:
            compile_submission({"swirl": "<l, {d1},\n  bogus(s)>"})
        e = exc.value
        assert e.kind == "swirl-syntax"
        assert e.line == 2 and e.column == 3
        body = e.to_json()
        assert body["line"] == 2 and body["column"] == 3

    def test_network_enables_schedule_stage(self):
        # An operator-configured cost model inserts Plan.schedule between
        # optimize and lower: the author's static mapping is replaced by
        # auto-placement, and the served instance still runs correctly.
        from repro_torch.sched import NetworkModel

        svc = WorkflowService(step_registry(), network=NetworkModel())
        receipt = svc.submit(DAG_BODY)
        entry = svc.cache.peek(receipt["fingerprint"])
        assert entry is not None
        assert any(
            label.startswith("schedule") for label, _ in entry.plan.timings
        ), [label for label, _ in entry.plan.timings]
        result = svc.run(receipt["fingerprint"])
        produced = {
            d: v
            for loc in result["data"].values()
            for d, v in loc.items()
        }
        assert produced["d^work"] == [1, 2]
        # Placement-equivalent resubmission of the same source is a hit.
        assert svc.submit(DAG_BODY)["cached"] is True


# ---------------------------------------------------------------------------
# The content-addressed plan cache
# ---------------------------------------------------------------------------


def _entry(tag: str) -> CacheEntry:
    plan = swirl.trace(EDGES, mapping=MAPPING).optimize()
    exe = plan.lower("threaded").compile(step_registry())
    return CacheEntry(
        fingerprint=tag * 64, plan=plan, executable=exe, compile_seconds=0.5
    )


class TestPlanCache:
    def test_hit_miss_stats(self):
        cache = PlanCache(4)
        e = cache.put(_entry("a"), source_digest="src1")
        assert cache.get("a" * 64) is e
        assert cache.get("b" * 64) is None
        assert cache.lookup_source("src1") is e
        s = cache.stats()
        assert s["hits"] == 2 and s["misses"] == 1
        assert s["hit_rate"] == pytest.approx(2 / 3, abs=1e-3)
        assert s["compile_seconds_saved"] == pytest.approx(1.0)

    def test_same_fingerprint_aliases_not_duplicates(self):
        cache = PlanCache(4)
        first = cache.put(_entry("a"), source_digest="src1")
        second = cache.put(_entry("a"), source_digest="src2")
        assert second is first  # the existing artifact wins
        assert len(cache) == 1
        assert cache.lookup_source("src2") is first

    def test_lru_eviction_takes_aliases(self):
        cache = PlanCache(2)
        cache.put(_entry("a"), source_digest="src-a")
        cache.put(_entry("b"))
        cache.get("a" * 64)  # refresh a → b is now LRU... then evict a? no:
        cache.put(_entry("c"))  # evicts b (least recently used)
        assert cache.peek("b" * 64) is None
        assert cache.peek("a" * 64) is not None
        cache.put(_entry("d"))  # evicts a and its source alias
        assert cache.peek("a" * 64) is None
        assert cache.lookup_source("src-a") is None
        assert cache.stats()["evictions"] == 2


# ---------------------------------------------------------------------------
# Admission control (unit level — deterministic FIFO)
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_unknown_key(self):
        ctl = AdmissionController([TenantConfig("t", api_key="k")])
        assert ctl.authenticate("k").name == "t"
        with pytest.raises(UnknownTenantError):
            ctl.authenticate("wrong")

    def test_quota_then_queue_then_reject(self):
        ctl = AdmissionController(
            [TenantConfig("t", api_key="k", max_concurrent=1, max_queue=1)]
        )
        ctl.acquire("t")
        granted = threading.Event()

        def queued():
            ctl.acquire("t", timeout_s=10)
            granted.set()

        w = threading.Thread(target=queued, daemon=True)
        w.start()
        deadline = time.monotonic() + 5
        while (
            ctl.stats()["tenants"]["t"]["queued"] < 1
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        with pytest.raises(AdmissionRejected) as exc:
            ctl.acquire("t")
        assert exc.value.reason == "quota"
        assert 1 <= exc.value.retry_after <= 60
        ctl.release("t", run_seconds=0.01)
        assert granted.wait(5)
        ctl.release("t", run_seconds=0.01)

    def test_fifo_grant_order(self):
        """Queued waiters are granted strictly in arrival order."""
        ctl = AdmissionController(
            [TenantConfig("t", api_key="k", max_concurrent=1, max_queue=8)]
        )
        ctl.acquire("t")  # saturate
        order: list[int] = []
        lock = threading.Lock()
        threads = []
        for i in range(5):
            def waiter(i=i):
                ctl.acquire("t", timeout_s=30)
                with lock:
                    order.append(i)
                ctl.release("t")

            t = threading.Thread(target=waiter, daemon=True)
            threads.append(t)
            t.start()
            # Wait until this waiter is visibly enqueued so arrival order
            # is deterministic.
            deadline = time.monotonic() + 5
            while (
                ctl.stats()["tenants"]["t"]["queued"] < i + 1
                and time.monotonic() < deadline
            ):
                time.sleep(0.002)
        ctl.release("t")  # each release grants the head; chain drains FIFO
        for t in threads:
            t.join(10)
        assert order == [0, 1, 2, 3, 4]

    def test_queue_timeout(self):
        ctl = AdmissionController(
            [TenantConfig("t", api_key="k", max_concurrent=1, max_queue=4)]
        )
        ctl.acquire("t")
        with pytest.raises(AdmissionRejected) as exc:
            ctl.acquire("t", timeout_s=0.05)
        assert exc.value.reason == "timeout"
        st = ctl.stats()["tenants"]["t"]
        assert st["queued"] == 0  # the timed-out ticket left the queue

    def test_tenants_isolated(self):
        ctl = AdmissionController(
            [
                TenantConfig("a", api_key="ka", max_concurrent=1, max_queue=0),
                TenantConfig("b", api_key="kb", max_concurrent=1, max_queue=0),
            ]
        )
        ctl.acquire("a")
        with pytest.raises(AdmissionRejected):
            ctl.acquire("a")
        ctl.acquire("b")  # a's saturation never affects b
        ctl.release("a")
        ctl.release("b")

    def test_drain_rejects_and_waits(self):
        ctl = AdmissionController([TenantConfig("t", api_key="k")])
        ctl.acquire("t")
        done = threading.Event()

        def finish():
            time.sleep(0.05)
            ctl.release("t")
            done.set()

        threading.Thread(target=finish, daemon=True).start()
        assert ctl.drain(timeout_s=5)
        assert done.is_set()
        with pytest.raises(AdmissionRejected) as exc:
            ctl.acquire("t")
        assert exc.value.reason == "draining"


# ---------------------------------------------------------------------------
# HTTP end to end
# ---------------------------------------------------------------------------


class TestGatewayHTTP:
    def test_submit_run_describe_stats(self, client):
        receipt = client.submit(DAG_BODY)
        fp = receipt["fingerprint"]
        assert len(fp) == 64 and receipt["cached"] is False
        assert receipt["backend"] == "threaded"
        assert "encode" in receipt["timings_ms"]

        again = client.submit(DAG_BODY)
        assert again["fingerprint"] == fp and again["cached"] is True

        out = client.run(fp)
        assert out["data"]["l2"]["d^work"] == [1, 2]

        batch = client.run_many(fp, [{}] * 5, max_concurrent=4)
        assert [r["data"]["l2"]["d^work"] for r in batch["results"]] == [
            [1, 2]
        ] * 5

        desc = client.describe(fp)
        assert desc["fingerprint"] == fp
        assert "exec" in desc["explain"]
        assert desc["placement"]["work"] == ["l2"]

        stats = client.stats()
        assert stats["counters"]["compiles"] == 1
        assert stats["counters"]["instances_completed"] == 6
        assert stats["cache"]["entries"] == 1
        assert stats["cache"]["hits"] >= 3  # resubmit + run + batch + desc
        assert "derive_cache" in stats and "admission" in stats

    def test_swirl_text_submission_aliases_dag(self, client):
        """A ``.swirl`` rendering of the same workflow converges on the
        same fingerprint — one compiled artifact serves both sources."""
        fp = client.submit(DAG_BODY)["fingerprint"]
        text = dumps(
            compile_submission(dict(DAG_BODY, rules=[]))[0].system
        )
        receipt = client.submit(text)  # Content-Type: text/plain
        assert receipt["fingerprint"] == fp
        assert receipt["cached"] is True  # aliased, not recompiled
        stats = client.stats()
        assert stats["counters"]["compiles"] == 1

    def test_malformed_submissions_are_400_json(self, client):
        cases = [
            ("{not json", "json"),
            (json.dumps({"frobnicate": 1}), "schema"),
            (json.dumps({"swirl": "<l,{},bogus(s)>"}), "swirl-syntax"),
            (json.dumps({"dag": {"edges": {"a": ["b"]}}}), "dag"),
            (json.dumps(dict(DAG_BODY, rules=["R99"])), "rules"),
        ]
        for raw, kind in cases:
            with pytest.raises(GatewayError) as exc:
                client._request(
                    "POST", "/v1/workflows", raw.encode()
                )
            e = exc.value
            assert e.status == 400, (raw, e.payload)
            assert e.error["type"] == "SubmissionError"
            assert e.error["kind"] == kind
            # The body is structured JSON, never a traceback.
            assert "Traceback" not in json.dumps(e.payload)

    def test_swirl_error_line_column_over_http(self, client):
        with pytest.raises(GatewayError) as exc:
            client.submit({"swirl": "<l, {d1},\n  bogus(s)>"})
        e = exc.value
        assert e.status == 400
        assert e.error["kind"] == "swirl-syntax"
        assert e.error["line"] == 2 and e.error["column"] == 3

    def test_unregistered_step_is_400(self, client):
        body = {
            "dag": {
                "edges": {"mystery": ["sink"], "sink": []},
                "mapping": {"mystery": ["l1"], "sink": ["l1"]},
            }
        }
        with pytest.raises(GatewayError) as exc:
            client.submit(body)
        assert exc.value.status == 400
        assert exc.value.error["kind"] == "steps"
        assert "mystery" in exc.value.error["message"]

    def test_unknown_fingerprint_404(self, client):
        with pytest.raises(GatewayError) as exc:
            client.run("0" * 64)
        assert exc.value.status == 404
        with pytest.raises(GatewayError) as exc:
            client.describe("f" * 64)
        assert exc.value.status == 404

    def test_unknown_route_404(self, client):
        with pytest.raises(GatewayError) as exc:
            client._request("GET", "/v2/nope")
        assert exc.value.status == 404
        assert "routes" in exc.value.error

    def test_unknown_api_key_401(self, gateway):
        with GatewayClient(gateway.url, api_key="wrong") as c:
            with pytest.raises(GatewayError) as exc:
                c.stats()
            assert exc.value.status == 401

    def test_bad_inputs_are_400(self, client):
        fp = client.submit(DAG_BODY)["fingerprint"]
        with pytest.raises(GatewayError) as exc:
            client.run(fp, {"no-colon": 1})
        assert exc.value.status == 400
        assert exc.value.error["kind"] == "inputs"
        with pytest.raises(GatewayError) as exc:
            client.run(fp, {"l9:d": 1})
        assert exc.value.status == 400
        with pytest.raises(GatewayError) as exc:
            client._request(
                "POST", f"/v1/workflows/{fp}/run_many", {"inputs": "nope"}
            )
        assert exc.value.status == 400

    def test_oversized_body_is_typed_413(self, service):
        # Regression: the cap used to be an unconfigurable 64 MB module
        # constant surfaced as a 400 "json" SubmissionError.  It is now a
        # per-gateway option with its own typed error and status.
        with Gateway(service, max_body_bytes=1024) as gw:
            big = json.dumps({"swirl": "x" * 4096}).encode()
            with GatewayClient(gw.url) as c:
                with pytest.raises(GatewayError) as exc:
                    c._request("POST", "/v1/workflows", big)
                e = exc.value
                assert e.status == 413
                assert e.error["type"] == "BodyTooLarge"
                assert e.error["limit_bytes"] == 1024
                assert e.error["content_length"] == len(big)
                assert "Traceback" not in json.dumps(e.payload)
            # The oversized request was rejected unread and its connection
            # closed; the gateway keeps serving fresh connections.
            with GatewayClient(gw.url) as c2:
                assert len(c2.submit(DAG_BODY)["fingerprint"]) == 64

    def test_body_cap_defaults_to_a_few_mb(self, service):
        from repro_torch.serve.gateway import DEFAULT_MAX_BODY_BYTES

        with Gateway(service) as gw:
            assert gw.max_body_bytes == DEFAULT_MAX_BODY_BYTES
            assert 1024 * 1024 <= DEFAULT_MAX_BODY_BYTES <= 64 * 1024 * 1024

    def test_healthz_unauthenticated(self, gateway):
        with GatewayClient(gateway.url, api_key="not-a-key") as c:
            health = c.healthz()
            assert health["status"] == "ok"
            assert health["draining"] is False
            assert health["tenants"] == {
                "anonymous": {"queued": 0, "active": 0}
            }

    def test_concurrent_client_batches_isolated(self, gateway):
        """Several HTTP clients share one cached Executable; every batch
        observes exactly its own inputs."""
        from repro_torch.core.graph import (
            DistributedWorkflowInstance,
            make_workflow,
        )

        svc = gateway.service
        svc.steps["ingest"] = lambda inp: {"d_ingest": inp["d_seed"]}
        svc.steps["transform"] = lambda inp: {}
        # A workflow whose source step consumes per-instance seed data
        # (the seed port has no producer step, so it is fed purely from
        # run-time initial payloads) — submitted as .swirl text.
        wf = make_workflow(
            ["ingest", "transform"],
            ["p_seed", "p_ingest"],
            [
                ("p_seed", "ingest"),
                ("ingest", "p_ingest"),
                ("p_ingest", "transform"),
            ],
        )
        inst = DistributedWorkflowInstance(
            workflow=wf,
            locations=frozenset({"l0", "l1"}),
            mapping={"ingest": ("l0",), "transform": ("l1",)},
            data=frozenset({"d_seed", "d_ingest"}),
            placement={"d_seed": "p_seed", "d_ingest": "p_ingest"},
            initial_data={"l0": frozenset({"d_seed"})},
        )
        text = dumps(swirl.trace(inst).system)
        with GatewayClient(gateway.url) as c0:
            fp = c0.submit({"swirl": text})["fingerprint"]
        out: dict[int, list] = {}
        errors: list[Exception] = []

        def worker(b):
            try:
                with GatewayClient(gateway.url) as c:
                    r = c.run_many(
                        fp,
                        [{"l0:d_seed": f"b{b}i{i}"} for i in range(4)],
                        max_concurrent=4,
                    )
                out[b] = [x["data"]["l1"]["d_ingest"] for x in r["results"]]
            except Exception as e:
                errors.append(e)

        threads = [
            threading.Thread(target=worker, args=(b,)) for b in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors
        for b in range(4):
            assert out[b] == [f"b{b}i{i}" for i in range(4)]


# ---------------------------------------------------------------------------
# Overload and graceful shutdown over HTTP
# ---------------------------------------------------------------------------


class TestOverloadAndDrain:
    def _gateway(self, *, sleep_s, tenants):
        svc = WorkflowService(step_registry(sleep_s), tenants=tenants)
        return Gateway(svc).start()

    def test_429_with_retry_after(self):
        # Deterministic overload: ``prep`` blocks on an event, so the 2
        # in-flight + 2 queued runs cannot drain a slot early — the other
        # 6 must hit queue-full no matter how the threads are scheduled.
        release = threading.Event()
        steps = step_registry()
        sleepy_prep = steps["prep"]
        steps["prep"] = lambda inp: (release.wait(30), sleepy_prep(inp))[1]
        svc = WorkflowService(
            steps,
            tenants=[
                TenantConfig(
                    "t1", api_key="k1", max_concurrent=2, max_queue=2
                )
            ],
        )
        gw = Gateway(svc).start()
        try:
            with GatewayClient(gw.url, api_key="k1") as c0:
                fp = c0.submit(DAG_BODY)["fingerprint"]
            outcomes = {"ok": 0, "429": 0}
            lock = threading.Lock()

            def worker():
                with GatewayClient(gw.url, api_key="k1") as c:
                    try:
                        c.run(fp)
                        with lock:
                            outcomes["ok"] += 1
                    except GatewayError as e:
                        assert e.status == 429
                        assert e.retry_after >= 1
                        assert e.error["reason"] == "quota"
                        with lock:
                            outcomes["429"] += 1

            threads = [
                threading.Thread(target=worker) for _ in range(10)
            ]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                with lock:
                    if outcomes["429"] == 6:
                        break
                time.sleep(0.01)
            release.set()
            for t in threads:
                t.join(30)
            # 2 in flight + 2 queued succeed; the rest are shed — and
            # every admitted run completed (nothing dropped).
            assert outcomes == {"ok": 4, "429": 6}
            with GatewayClient(gw.url, api_key="k1") as c0:
                s = c0.stats()
            assert s["counters"]["rejected"] == 6
            assert s["counters"]["instances_completed"] == 4
            assert s["counters"]["instances_failed"] == 0
            assert s["admission"]["tenants"]["t1"]["rejected"] == 6
        finally:
            gw.close(drain_timeout_s=5)

    def test_per_tenant_isolation_over_http(self):
        gw = self._gateway(
            sleep_s=0.1,
            tenants=[
                TenantConfig(
                    "busy", api_key="kb", max_concurrent=1, max_queue=0
                ),
                TenantConfig(
                    "idle", api_key="ki", max_concurrent=2, max_queue=2
                ),
            ],
        )
        try:
            with GatewayClient(gw.url, api_key="kb") as c:
                fp = c.submit(DAG_BODY)["fingerprint"]
            hold = threading.Thread(
                target=lambda: GatewayClient(gw.url, api_key="kb").run(fp)
            )
            hold.start()
            time.sleep(0.03)  # let the busy tenant saturate its 1 slot
            with GatewayClient(gw.url, api_key="kb") as c:
                with pytest.raises(GatewayError) as exc:
                    c.run(fp)
                assert exc.value.status == 429
            # The other tenant is untouched by busy's saturation.
            with GatewayClient(gw.url, api_key="ki") as c:
                assert c.run(fp)["data"]["l2"]["d^work"] == [1, 2]
            hold.join(30)
        finally:
            gw.close(drain_timeout_s=5)

    def test_graceful_drain_finishes_inflight(self):
        gw = self._gateway(sleep_s=0.2, tenants=None)
        with GatewayClient(gw.url) as c:
            fp = c.submit(DAG_BODY)["fingerprint"]
        done: list[dict] = []

        def inflight():
            with GatewayClient(gw.url) as c:
                done.append(c.run(fp))

        t = threading.Thread(target=inflight)
        t.start()
        time.sleep(0.05)  # the run is admitted and sleeping in its step
        assert gw.close(drain_timeout_s=10)  # True ⇒ nothing dropped
        t.join(10)
        assert done and done[0]["data"]["l2"]["d^work"] == [1, 2]

    def test_draining_rejects_new_work_with_503(self):
        gw = self._gateway(sleep_s=0.0, tenants=None)
        svc = gw.service
        with GatewayClient(gw.url) as c:
            fp = c.submit(DAG_BODY)["fingerprint"]
            svc.drain(timeout_s=5)
            health = c.healthz()
            assert health["status"] == "draining"
            assert health["draining"] is True
            with pytest.raises(GatewayError) as exc:
                c.submit(DAG_BODY)
            assert exc.value.status == 503
            with pytest.raises(GatewayError) as exc:
                c.run(fp)
            assert exc.value.status == 503
        gw.close(drain_timeout_s=1)


# ---------------------------------------------------------------------------
# Observability: /v1/metrics, trace ids, drain-aware healthz
# ---------------------------------------------------------------------------


class TestObservability:
    def test_metrics_unauthenticated_prometheus_text(self, gateway):
        import http.client

        with GatewayClient(gateway.url, api_key="not-a-key") as c:
            fp_err = None
            try:
                c.describe("0" * 64)
            except GatewayError as e:
                fp_err = e
            assert fp_err is not None and fp_err.status == 401
            text = c.metrics()
        assert text.endswith("\n")
        # Exposition-format shape: every sample line's metric appears
        # under a matching # TYPE header.
        typed = {}
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split(" ")
                typed[name] = kind
        assert typed["gateway_requests_total"] == "counter"
        assert typed["gateway_request_seconds"] == "histogram"
        assert typed["tenant_queue_depth"] == "gauge"
        assert typed["plan_cache_hit_rate"] == "gauge"
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            name = line.split("{")[0].split(" ")[0]
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in typed:
                    base = name[: -len(suffix)]
            assert base in typed, f"untyped sample {name!r}"
        # Content type is the Prometheus text exposition format.
        host, port = gateway.address
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("GET", "/v1/metrics")
        resp = conn.getresponse()
        resp.read()
        assert resp.getheader("Content-Type").startswith(
            "text/plain; version=0.0.4"
        )
        conn.close()

    def test_metrics_track_requests_and_cache(self, gateway):
        with GatewayClient(gateway.url) as c:
            fp = c.submit(DAG_BODY)["fingerprint"]
            c.submit(DAG_BODY)  # cache hit
            c.run(fp)
            text = c.metrics()
        samples = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                samples[key] = float(value)
        assert (
            samples[
                'gateway_requests_total{method="POST",route="submit",'
                'status="200"}'
            ]
            == 2
        )
        assert (
            samples[
                'gateway_requests_total{method="POST",route="run",'
                'status="200"}'
            ]
            == 1
        )
        assert samples["plan_cache_hits_total"] >= 1
        assert samples['service_operations_total{kind="submissions"}'] == 2
        assert samples['service_operations_total{kind="runs"}'] == 1
        assert samples['gateway_request_seconds_count{route="submit"}'] == 2

    def test_metrics_count_429_per_tenant(self):
        tenants = [
            TenantConfig("tiny", api_key="kt", max_concurrent=1, max_queue=0)
        ]
        svc = WorkflowService(step_registry(sleep_s=0.4), tenants=tenants)
        with Gateway(svc) as gw:
            with GatewayClient(gw.url, api_key="kt") as c:
                fp = c.submit(DAG_BODY)["fingerprint"]
                hold = threading.Thread(target=lambda: c2.run(fp))
                with GatewayClient(gw.url, api_key="kt") as c2:
                    hold.start()
                    time.sleep(0.1)  # c2 occupies tiny's only slot
                    with pytest.raises(GatewayError) as exc:
                        c.run(fp)
                    assert exc.value.status == 429
                    text = c.metrics()
                    hold.join(30)
        assert 'tenant_rejected_total{tenant="tiny"} 1' in text
        assert 'tenant_active_runs{tenant="tiny"} 1' in text

    def test_trace_id_generated_and_echoed(self, gateway):
        import http.client

        host, port = gateway.address
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("GET", "/v1/healthz")
        resp = conn.getresponse()
        resp.read()
        generated = resp.getheader("X-Trace-Id")
        assert generated and len(generated) == 16
        conn.request(
            "GET", "/v1/healthz", headers={"X-Trace-Id": "req-12345"}
        )
        resp = conn.getresponse()
        resp.read()
        assert resp.getheader("X-Trace-Id") == "req-12345"
        conn.close()

    def test_trace_id_in_error_bodies(self, client):
        with pytest.raises(GatewayError) as exc:
            client.describe("0" * 64)
        trace_id = exc.value.error["trace_id"]
        assert trace_id and isinstance(trace_id, str)
        with pytest.raises(GatewayError) as exc:
            client._request("POST", "/v1/workflows", {"bad": True})
        assert exc.value.error["trace_id"]

    def test_healthz_reports_queue_depths_per_tenant(self):
        tenants = [
            TenantConfig("busy", api_key="kb", max_concurrent=1, max_queue=4),
            TenantConfig("idle", api_key="ki"),
        ]
        svc = WorkflowService(step_registry(sleep_s=0.4), tenants=tenants)
        with Gateway(svc) as gw:
            with GatewayClient(gw.url, api_key="kb") as c:
                fp = c.submit(DAG_BODY)["fingerprint"]

            def run_one():
                with GatewayClient(gw.url, api_key="kb") as c2:
                    c2.run(fp)

            threads = [
                threading.Thread(target=run_one) for _ in range(3)
            ]
            for t in threads:
                t.start()
            time.sleep(0.15)  # 1 active + 2 queued on "busy"
            with GatewayClient(gw.url) as anon:
                health = anon.healthz()
            for t in threads:
                t.join(30)
        assert health["draining"] is False
        busy = health["tenants"]["busy"]
        assert busy["active"] == 1
        assert busy["queued"] == 2
        assert health["tenants"]["idle"] == {"queued": 0, "active": 0}


# ---------------------------------------------------------------------------
# The same requests to both packages' gateways
# ---------------------------------------------------------------------------

# Keys whose values are timings, per-request ids or the process-wide derive
# cache's counters (which earlier tests in the same process move); everything
# else must be equal once parsed.
_VOLATILE = {"trace_id", "compile_seconds", "timings_ms", "uptime_s", "compile_seconds_saved",
             "run_seconds_avg", "derive_cache"}
_TIMING_LINE = re.compile(r"^\s+\S+\s+[0-9.]+ ms$", re.M)


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        return _TIMING_LINE.sub("", obj)
    return obj


def _drive(gw, fp_hint: str) -> list:
    """A fixed script of requests over one keep-alive connection: every
    route, the error paths, and the cache and counters they leave."""
    import http.client

    host, port = gw.address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    out = []

    def req(method, path, body=None, key="k1"):
        headers = {"Content-Type": "application/json"}
        if key is not None:
            headers["X-API-Key"] = key
        conn.request(method, path, body=None if body is None else json.dumps(body), headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        if resp.getheader("Content-Type", "").startswith("application/json"):
            parsed = _scrub(json.loads(raw))
        else:
            parsed = sorted(line for line in raw.decode().splitlines() if line.startswith("# TYPE"))
        out.append((method, path, resp.status, resp.getheader("Retry-After"), parsed))
        return parsed

    fp = req("POST", "/v1/workflows", DAG_BODY)["fingerprint"]
    assert fp == fp_hint
    req("POST", "/v1/workflows", DAG_BODY)
    req("POST", "/v1/workflows", {"swirl": dumps(swirl.trace(EDGES, mapping=MAPPING).optimize().system)})
    req("POST", "/v1/workflows", {"dag": 3})
    req("POST", "/v1/workflows", {"swirl": "<l, {d},\n  frobnicate(s)>"})
    req("POST", "/v1/workflows", {"dag": {"edges": {"mystery": []}, "mapping": {"mystery": ["l1"]}}})
    req("POST", "/v1/workflows", "not json at all")
    req("GET", f"/v1/workflows/{fp}")
    req("POST", f"/v1/workflows/{fp}/run", {"inputs": {}})
    req("POST", f"/v1/workflows/{fp}/run", {"inputs": {"l1:seed": [5, 6]}})
    req("POST", f"/v1/workflows/{fp}/run", {"inputs": {"nowhere:d": 1}})
    req("POST", f"/v1/workflows/{fp}/run", {"inputs": 3})
    req("POST", f"/v1/workflows/{fp}/run_many", {"inputs": [{}, {"l2:x": 1}], "max_concurrent": 2})
    req("POST", f"/v1/workflows/{fp}/run_many", {"inputs": "nope"})
    req("GET", "/v1/workflows/" + "0" * 64)
    req("POST", "/v1/workflows/" + "0" * 64 + "/run", {"inputs": {}})
    req("GET", "/v1/nowhere")
    req("DELETE", f"/v1/workflows/{fp}")
    req("GET", "/v1/stats", key="wrong")
    req("GET", "/v1/stats")
    req("GET", "/v1/healthz", key=None)
    req("GET", "/v1/metrics", key=None)
    conn.close()
    return out


def test_both_gateways_answer_the_same_requests_alike():
    from repro import serve as jserve
    from repro import swirl as jswirl

    jsvc = jserve.WorkflowService(step_registry(), tenants=[
        jserve.TenantConfig("t1", api_key="k1", max_concurrent=4, max_queue=4)])
    tsvc = WorkflowService(step_registry(), tenants=[
        TenantConfig("t1", api_key="k1", max_concurrent=4, max_queue=4)])
    fp = jswirl.trace(EDGES, mapping=MAPPING).optimize().fingerprint()
    assert swirl.trace(EDGES, mapping=MAPPING).optimize().fingerprint() == fp
    with jserve.Gateway(jsvc) as jgw:
        want = _drive(jgw, fp)
    with Gateway(tsvc) as tgw:
        got = _drive(tgw, fp)
    assert [r[:4] for r in got] == [r[:4] for r in want]
    for g, w in zip(got, want):
        assert g == w, g[:3]
    assert {r[2] for r in got} >= {200, 400, 401, 404}


# ---------------------------------------------------------------------------
# Phase 18 of chip_smoke.py, rehearsed
# ---------------------------------------------------------------------------


def test_phase_18_rehearsed_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_gateway`` on the CPU at a small shape, its one
    multiprocess request forked (so that the workers inherit the forced
    switch), the switch forced to the kernel path, so that the plain
    rmsnorm counts as the card's launch.  The phase's own checks run: every answer over HTTP equal to
    the same request in process, 2 launches a request, 429 with
    ``Retry-After`` for a tenant over its quota, ``/v1/healthz`` and
    ``/v1/metrics``, and the multiprocess service's same number."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import ops as kops

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_gateway_tests", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "GW_SHAPE", (4, 32))
    monkeypatch.setattr(cs, "GW_REQUESTS", 40)
    monkeypatch.setattr(kops, "use_kernel", lambda x: True)
    out = cs.phase_gateway(torch, "cpu rehearsal", "H100 SXM", device="cpu", start_method="fork")
    assert out["launches"] == {"rmsnorm": 2 * 40}
    assert out["over_quota"]["status"] == 429 and out["over_quota"]["retry_after"] >= 1
    assert out["counters"]["rejected"] == 1 and out["counters"]["instances_failed"] == 0
    assert out["requests_per_s"] > 0 and out["p50_ms"] <= out["p99_ms"]
    assert isinstance(out["multiprocess"]["answer"], float)
