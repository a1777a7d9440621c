"""The port's transports against the reference's contract.

``repro_torch.workflow.transport`` is a copy of ``repro.workflow.transport``.
The reference's conformance suite (``tests/test_transport.py``: per-endpoint
FIFO order, exactly-once effect under lossy wires and lost acks, close while
blocked, no leakage across endpoints, batched sends) runs here as cases of
one parametrised test over the port's own registry (``memory``, ``socket``,
``shm``) and the ``hybrid`` composite; then the socket,
shared-memory, hybrid and pickle-5 specifics, and the names and addresses
that must equal the reference's for the same inputs.

Payloads as in the reference: an ``np.ndarray`` is framed into shared
memory; anything else spills to pickle, a ``torch.Tensor`` included.

Every shared-memory transport built here gets a fleet key of its own test
(never the default ``b"swirl-transport"`` or ``b"crash-teardown-test"``), so
its segments never land in the namespaces the reference's tests list under
``/dev/shm`` on another worker.
"""

from __future__ import annotations

import gc
import glob
import multiprocessing
import os
import pickle
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from repro.workflow import transport as jtransport
from repro_torch.workflow import AckTimeout
from repro_torch.workflow.transport import (
    TRANSPORTS,
    ChannelClosed,
    HybridTransport,
    InMemoryTransport,
    SharedMemoryTransport,
    SocketTransport,
    Transport,
    get_transport,
    register_transport,
    shm_namespace,
    socket_addresses,
)

LOCATIONS = ("alpha", "beta")
EP = ("alpha", "beta", "port0")
RECV_S = 10.0


@pytest.fixture(autouse=True)
def own_fleet_key(monkeypatch):
    """A shared-memory fleet key for this test alone (see the module doc)."""
    key = f"torch-transport-{os.getpid()}-{uuid.uuid4().hex}".encode()
    monkeypatch.setitem(SharedMemoryTransport.__init__.__kwdefaults__, "authkey", key)
    return key


def _hybrid_conformance(tmp_path, locations, *, loss=0.0, ack_loss=0.0, seed=0):
    """The composite with the suite's locations in one process, so that its
    endpoints take the faulty local queues, beside a socket wire to a third
    location (the remote route has its own tests below)."""
    remote = SocketTransport.conformance(tmp_path, tuple(locations) + ("gamma",))
    local = InMemoryTransport.conformance(tmp_path, locations, loss=loss, ack_loss=ack_loss, seed=seed)
    return HybridTransport(remote, locations, local=local)


CONFORMANCE = {name: TRANSPORTS[name].conformance for name in sorted(TRANSPORTS)} | {
    "hybrid": _hybrid_conformance,
}


@pytest.fixture(params=sorted(CONFORMANCE))
def make(request, tmp_path):
    """Factory building (and tracking for teardown) conformance instances."""
    built: list[Transport] = []

    def factory(locations=LOCATIONS, **faults) -> Transport:
        t = CONFORMANCE[request.param](str(tmp_path / f"t{len(built)}"), locations, **faults)
        built.append(t)
        return t

    yield factory
    for t in built:
        t.close()


def _send_recv_fifo(t):
    for i in range(64):
        t.send(EP, f"d{i}", i)
    assert [t.recv(EP, timeout=RECV_S).payload for _ in range(64)] == list(range(64))


def _no_cross_endpoint_leakage(t):
    eps = [("alpha", "beta", "p0"), ("alpha", "beta", "p1"), ("beta", "alpha", "p0")]
    for i in range(8):
        for j, ep in enumerate(eps):
            t.send(ep, f"d{j}", (j, i))
    for j, ep in enumerate(eps):
        assert [t.recv(ep, timeout=RECV_S).payload for _ in range(8)] == [(j, i) for i in range(8)]


def _exactly_once(t, n=32):
    for i in range(n):
        t.send(EP, f"d{i}", i)
    assert [t.recv(EP, timeout=RECV_S).payload for _ in range(n)] == list(range(n))
    with pytest.raises(TimeoutError):
        t.recv(EP, timeout=0.05)  # no duplicate ever surfaces


def _recv_timeout(t):
    with pytest.raises(TimeoutError):
        t.recv(EP, timeout=0.05)


def _close_while_blocked(t):
    caught: list[BaseException] = []
    blocked = threading.Event()

    def receiver():
        blocked.set()
        try:
            t.recv(EP, timeout=30.0)
        except ChannelClosed as e:
            caught.append(e)

    th = threading.Thread(target=receiver, daemon=True)
    th.start()
    assert blocked.wait(5.0)
    time.sleep(0.1)  # let the receiver actually block
    t.close()
    th.join(5.0)
    assert not th.is_alive(), "close() did not unblock the receiver"
    assert caught and isinstance(caught[0], ChannelClosed)


def _send_after_close(t):
    t.close()
    with pytest.raises(ChannelClosed):
        t.send(EP, "d", 1)


def _drain_before_closed(t):
    for i in range(3):
        t.send(EP, f"d{i}", i)
    t.close()
    assert [t.recv(EP, timeout=RECV_S).payload for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ChannelClosed):
        t.recv(EP, timeout=5.0)


def _close_idempotent(t):
    t.close()
    t.close()


def _concurrent_senders(t):
    eps = [("alpha", "beta", f"p{i}") for i in range(4)]
    errs: list[BaseException] = []

    def sender(ep):
        try:
            for i in range(16):
                t.send(ep, f"d{i}", i)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=sender, args=(ep,), daemon=True) for ep in eps]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30.0)
    assert not errs
    for ep in eps:
        assert [t.recv(ep, timeout=RECV_S).payload for _ in range(16)] == list(range(16))


def _send_many_fifo(t):
    t.send_many(EP, [(f"d{i}", i) for i in range(48)])
    assert [t.recv(EP, timeout=RECV_S).payload for _ in range(48)] == list(range(48))


def _send_many_empty_and_single(t):
    t.send_many(EP, [])
    t.send_many(EP, [("only", "x")])
    assert t.recv(EP, timeout=RECV_S).payload == "x"
    with pytest.raises(TimeoutError):
        t.recv(EP, timeout=0.05)


def _send_many_exactly_once(t):
    for base in range(0, 32, 8):
        t.send_many(EP, [(f"d{i}", base + i) for i in range(8)])
    assert [t.recv(EP, timeout=RECV_S).payload for _ in range(32)] == list(range(32))
    with pytest.raises(TimeoutError):
        t.recv(EP, timeout=0.05)


def _scatter_fifo(t):
    eps = [("alpha", "beta", f"p{i}") for i in range(3)]
    t.scatter((ep, [(f"d{i}", (k, i)) for i in range(8)]) for k, ep in enumerate(eps))
    for k, ep in enumerate(eps):
        assert [t.recv(ep, timeout=RECV_S).payload for _ in range(8)] == [(k, i) for i in range(8)]


def _scatter_under_loss(t):
    eps = [("alpha", "beta", f"p{i}") for i in range(2)]
    for rank in range(4):
        t.scatter([(ep, [(f"r{rank}d{i}", (rank, i)) for i in range(4)]) for ep in eps])
    for ep in eps:
        got = [t.recv(ep, timeout=RECV_S).payload for _ in range(16)]
        assert got == [(r, i) for r in range(4) for i in range(4)]
    with pytest.raises(TimeoutError):
        t.recv(EP, timeout=0.05)


# The reference's conformance cases (tests/test_transport.py, TestTransportConformance
# and TestBatchedSends): (the case, the faults its transport is built with).
CASES = {
    "per_endpoint_fifo_ordering": (_send_recv_fifo, {}),
    "no_cross_endpoint_leakage": (_no_cross_endpoint_leakage, {}),
    "lossy_wire_delivers_exactly_once_in_order": (_exactly_once, {"loss": 0.5, "seed": 7}),
    "lost_acks_do_not_duplicate": (_exactly_once, {"ack_loss": 0.5, "seed": 11}),
    "recv_timeout_raises_timeout_error": (_recv_timeout, {}),
    "close_while_blocked_raises_channel_closed": (_close_while_blocked, {}),
    "send_after_close_raises_channel_closed": (_send_after_close, {}),
    "pending_messages_drain_before_closed_raises": (_drain_before_closed, {}),
    "close_is_idempotent": (_close_idempotent, {}),
    "concurrent_senders_on_distinct_endpoints": (_concurrent_senders, {}),
    "send_many_preserves_fifo": (_send_many_fifo, {}),
    "send_many_empty_and_single": (_send_many_empty_and_single, {}),
    "send_many_lossy_wire_exactly_once": (_send_many_exactly_once, {"loss": 0.5, "seed": 3}),
    "send_many_lost_acks_do_not_duplicate": (_send_many_exactly_once, {"ack_loss": 0.5, "seed": 5}),
    "scatter_fans_out_per_endpoint_fifo": (_scatter_fifo, {}),
    "scatter_under_loss": (_scatter_under_loss, {"loss": 0.4, "ack_loss": 0.3, "seed": 9}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conformance(make, case):
    fn, faults = CASES[case]
    fn(make(**faults))


# -- registry -------------------------------------------------------------------------


def test_builtins_registered_in_the_ports_own_registry():
    assert sorted(TRANSPORTS) == ["memory", "shm", "socket"]
    assert get_transport("memory") is InMemoryTransport
    assert get_transport("socket") is SocketTransport
    assert get_transport("shm") is SharedMemoryTransport
    assert InMemoryTransport.crosses_processes is False
    assert SocketTransport.crosses_processes and SharedMemoryTransport.crosses_processes
    # The two registries share nothing.
    assert sorted(jtransport.TRANSPORTS) == sorted(TRANSPORTS)
    assert not set(map(id, TRANSPORTS.values())) & set(map(id, jtransport.TRANSPORTS.values()))


def test_unknown_and_duplicate_names_are_refused():
    with pytest.raises(KeyError, match="unknown transport"):
        get_transport("carrier-pigeon")
    with pytest.raises(ValueError, match="already registered"):
        register_transport("memory", InMemoryTransport)


def test_names_and_addresses_equal_the_references(tmp_path):
    for key in (b"swirl-transport", b"crash-teardown-test", b"k", os.urandom(16)):
        assert shm_namespace(key) == jtransport.shm_namespace(key)
    for locs in (["x", "y", "z"], ["l^d", "l^IM", "l^s0"], ["only"]):
        assert socket_addresses(locs, base_dir=tmp_path) == jtransport.socket_addresses(locs, base_dir=tmp_path)
        assert socket_addresses(locs[::-1], base_dir=tmp_path) == socket_addresses(locs, base_dir=tmp_path)


def test_shm_instances_here_use_their_own_fleet_key(tmp_path, own_fleet_key):
    t = SharedMemoryTransport.conformance(str(tmp_path / "s"), LOCATIONS)
    try:
        assert t.namespace == shm_namespace(own_fleet_key)
        assert t.namespace not in {shm_namespace(b"swirl-transport"), shm_namespace(b"crash-teardown-test")}
    finally:
        t.close()


# -- socket specifics ------------------------------------------------------------------


def test_socket_serve_requires_address(tmp_path):
    addrs = socket_addresses(["x"], base_dir=tmp_path)
    with pytest.raises(KeyError, match="serve locations"):
        SocketTransport(addrs, serve=("ghost",))


def test_socket_resend_stats_recorded_under_loss(tmp_path):
    t = SocketTransport.conformance(str(tmp_path), LOCATIONS, loss=0.5, seed=3)
    try:
        for i in range(16):
            t.send(EP, f"d{i}", i)
        for _ in range(16):
            t.recv(EP, timeout=RECV_S)
        stats = t.stats()
        assert stats["dropped"] > 0
        assert stats["resends"] >= stats["dropped"]
        assert stats["delivered"] == 16
    finally:
        t.close()


def test_socket_unreachable_destination_raises(tmp_path):
    addrs = socket_addresses(LOCATIONS, base_dir=tmp_path)
    t = SocketTransport(addrs, serve=("alpha",), connect_timeout=0.3)
    try:
        with pytest.raises(ChannelClosed, match="cannot connect"):
            t.send(("alpha", "beta", "p"), "d", 1)
    finally:
        t.close()


def test_socket_exhausted_resends_raise_typed(tmp_path):
    t = SocketTransport(socket_addresses(["a", "b"], base_dir=tmp_path), serve=["a", "b"], ack_timeout=0.05,
                        max_sends=3, connect_timeout=5.0, drop_prob=1.0, seed=1)
    try:
        with pytest.raises(AckTimeout) as ei:
            t.send(("a", "b", "p"), "d", 1)
        err = ei.value
        assert (err.endpoint, err.attempts, err.seq) == (("a", "b", "p"), 3, 1)
        assert isinstance(err, ChannelClosed)
        assert t.stats()["resends"] == 2 and t.stats()["delivered"] == 0
    finally:
        t.close()


# -- hybrid ------------------------------------------------------------------------------


@pytest.fixture
def hybrid(tmp_path):
    remote = SocketTransport.conformance(str(tmp_path), ("alpha", "beta", "gamma"))
    t = HybridTransport(remote, ("alpha", "beta"))
    yield t
    t.close()


def test_hybrid_local_endpoints_never_touch_the_wire(hybrid):
    hybrid.send(("alpha", "beta", "p"), "d", 42)
    assert hybrid.recv(("alpha", "beta", "p"), timeout=5.0).payload == 42
    assert hybrid.stats()["remote"]["sent"] == 0
    assert hybrid.stats()["local"]["sent"] == 1


def test_hybrid_cross_endpoints_use_the_remote_wire(hybrid):
    hybrid.send(("alpha", "gamma", "p"), "d", 7)
    assert hybrid.recv(("alpha", "gamma", "p"), timeout=5.0).payload == 7
    assert hybrid.stats()["remote"]["sent"] == 1


def test_hybrid_close_closes_both_sides(hybrid):
    hybrid.close()
    with pytest.raises(ChannelClosed):
        hybrid.send(("alpha", "beta", "p"), "d", 1)
    with pytest.raises(ChannelClosed):
        hybrid.send(("alpha", "gamma", "p"), "d", 1)


# -- shared-memory specifics: the zero-copy contract ---------------------------------------


def _shm(tmp_path, name="s", **kw):
    return SharedMemoryTransport.conformance(str(tmp_path / name), LOCATIONS, **kw)


def test_shm_array_payloads_are_mapped_not_pickled(tmp_path):
    t = _shm(tmp_path)
    try:
        a = np.arange(4096, dtype=np.float64)
        t.send(EP, "a", a)
        assert np.array_equal(t.recv(EP, timeout=RECV_S).payload, a)
        st = t.stats()
        assert st["segments_created"] >= 1 and st["mapped_recvs"] == 1 and st["spilled_sends"] == 0
    finally:
        t.close()


def test_shm_segment_reclaimed_after_consumer_drops_view(tmp_path):
    t = _shm(tmp_path)
    try:
        t.send(EP, "a", np.arange(2048, dtype=np.float64))
        view = t.recv(EP, timeout=RECV_S).payload
        del view
        gc.collect()  # finalizer queues the release...
        t.send(EP, "b", {"not": "an array"})  # ...this ack carries it
        t.recv(EP, timeout=RECV_S)
        assert t.stats()["segments_released"] >= 1
    finally:
        t.close()


def test_shm_arena_reuse_over_many_sends(tmp_path):
    t = _shm(tmp_path)
    try:
        for i in range(32):
            t.send(EP, f"d{i}", np.full(1024, float(i)))
            got = t.recv(EP, timeout=RECV_S).payload
            assert got[0] == float(i)
            del got
            gc.collect()
        assert t.stats()["segments_created"] <= 4
    finally:
        t.close()


def test_shm_non_array_payloads_spill_to_pickle(tmp_path):
    t = _shm(tmp_path)
    try:
        cases = [{"k": [1, 2]}, "plain string", np.array([1], dtype=np.float64)[:0],
                 np.array([object()], dtype=object)]
        for i, v in enumerate(cases):
            t.send(EP, f"d{i}", v)
        got = [t.recv(EP, timeout=RECV_S).payload for _ in cases]
        assert got[0] == cases[0] and got[1] == cases[1]
        assert t.stats()["spilled_sends"] == len(cases) and t.stats()["mapped_recvs"] == 0
    finally:
        t.close()


def test_shm_broadcast_dedup_writes_one_segment(tmp_path):
    t = _shm(tmp_path)
    try:
        a = np.arange(8192, dtype=np.float64)
        ep2 = ("alpha", "beta", "port1")
        t.send(EP, "a", a)
        t.send(ep2, "a", a)
        g1, g2 = t.recv(EP, timeout=RECV_S).payload, t.recv(ep2, timeout=RECV_S).payload
        assert np.array_equal(g1, a) and np.array_equal(g2, a)
        st = t.stats()
        assert st["dedup_sends"] >= 1 and st["segments_created"] == 1
    finally:
        t.close()


def test_shm_cross_endpoint_isolation_of_mapped_views(tmp_path):
    t = _shm(tmp_path)
    try:
        eps = [("alpha", "beta", f"p{i}") for i in range(3)]
        for i in range(12):
            t.send(eps[i % 3], f"d{i}", np.full(512, float(i)))
        for k, ep in enumerate(eps):
            for i in range(k, 12, 3):
                got = t.recv(ep, timeout=RECV_S).payload
                assert got.shape == (512,) and np.all(got == float(i))
    finally:
        t.close()


def test_shm_no_leaked_segments_after_close(tmp_path):
    t = _shm(tmp_path)
    ns = t.namespace
    for i in range(4):
        t.send(EP, f"d{i}", np.arange(4096, dtype=np.float64))
    t.recv(EP, timeout=RECV_S)  # at least one consumer-side mapping too
    t.close()
    assert glob.glob(f"/dev/shm/{ns}-*") == []


def test_shm_sweep_cleans_up_after_a_crashed_process(tmp_path, own_fleet_key):
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm on this platform")
    ns = shm_namespace(own_fleet_key)
    addrs = socket_addresses(LOCATIONS, base_dir=str(tmp_path / "c"))
    ctx = multiprocessing.get_context("fork")

    def crash():
        t = SharedMemoryTransport(addrs, serve=LOCATIONS, authkey=own_fleet_key, ack_timeout=2.0,
                                  connect_timeout=10.0, min_frame_bytes=64)
        t.send(EP, "a", np.arange(4096, dtype=np.float64))
        t.recv(EP, timeout=RECV_S)
        os._exit(9)  # die without close(): segments stay behind

    p = ctx.Process(target=crash, daemon=True)
    p.start()
    p.join(30.0)
    assert p.exitcode == 9
    assert glob.glob(f"/dev/shm/{ns}-*"), "crash left no segments?"
    assert SharedMemoryTransport.sweep(own_fleet_key) >= 1
    assert glob.glob(f"/dev/shm/{ns}-*") == []


# -- a torch.Tensor is not an np.ndarray: it spills to pickle --------------------------


def test_tensor_payloads_spill_to_pickle_on_shm_and_socket(tmp_path):
    x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    for name in ("shm", "socket"):
        t = TRANSPORTS[name].conformance(str(tmp_path / name), LOCATIONS)
        try:
            t.send(EP, "x", x)
            got = t.recv(EP, timeout=RECV_S).payload
            assert isinstance(got, torch.Tensor) and got is not x and torch.equal(got, x)
            assert got.dtype == x.dtype and got.device == x.device
            if name == "shm":
                st = t.stats()
                assert st["spilled_sends"] == 1 and st["mapped_recvs"] == 0 and st["segments_created"] == 0
        finally:
            t.close()


@pytest.mark.parametrize("name", ["socket", "shm"])
def test_long_frames_and_buffers_go_in_parts(tmp_path, monkeypatch, name):
    """A frame or out-of-band buffer longer than ``WIRE_PART`` crosses the
    socket wire as parts of at most that size, and arrives whole: an array
    (out of band), a tensor (in the pickle), an empty array and a frame
    just at the limit."""
    from repro_torch.workflow import transport as ttransport

    from multiprocessing.connection import Connection

    monkeypatch.setattr(ttransport, "WIRE_PART", 1000)
    sizes = []
    real = Connection.send_bytes

    def counting(self, buf):
        sizes.append(memoryview(buf).nbytes)
        return real(self, buf)

    monkeypatch.setattr(Connection, "send_bytes", counting)
    payloads = [np.arange(3000, dtype=np.float64), torch.arange(2500, dtype=torch.float32).reshape(50, 50),
                np.zeros(0), b"x" * 900]
    t = TRANSPORTS[name].conformance(str(tmp_path / name), LOCATIONS)
    try:
        for i, x in enumerate(payloads):
            t.send(EP, f"x{i}", x)
            got = t.recv(EP, timeout=RECV_S).payload
            if isinstance(x, torch.Tensor):
                assert torch.equal(got, x)
            elif isinstance(x, np.ndarray):
                assert np.array_equal(got, x) and got.dtype == x.dtype
            else:
                assert got == x
    finally:
        t.close()
    assert sizes and max(sizes) <= 1000


def test_long_control_messages_of_the_multiprocess_backend_go_in_parts(monkeypatch):
    from repro_torch.backends import multiprocess as tmp
    from repro_torch.workflow import transport as ttransport

    monkeypatch.setattr(ttransport, "WIRE_PART", 512)
    a, b = multiprocessing.Pipe()
    msg = ("done", 0, {"l0": {"d": torch.arange(4096, dtype=torch.float32)}})
    done = threading.Thread(target=tmp._send_msg, args=(a, msg))
    done.start()  # a long message blocks until it is read
    got = tmp._recv_msg(b)
    done.join(RECV_S)
    assert got[:2] == ("done", 0) and torch.equal(got[2]["l0"]["d"], msg[2]["l0"]["d"])
    tmp._send_msg(a, ("ready", 1, 2, 3.0))
    assert tmp._recv_msg(b) == ("ready", 1, 2, 3.0)
    a.close()
    b.close()


def test_the_in_memory_wire_hands_over_the_very_object():
    t = InMemoryTransport()
    x = torch.ones(3)
    t.send(EP, "x", x)
    assert t.recv(EP, timeout=RECV_S).payload is x


# -- socket pickle-5 framing: out-of-band buffers, one fewer copy ---------------------------


def test_pickle5_frame_header_is_tiny_for_array_payloads():
    arr = np.arange(1 << 16, dtype=np.float64)
    buffers: list = []
    meta = pickle.dumps(("msg", EP, 1, "d", arr), protocol=pickle.HIGHEST_PROTOCOL,
                        buffer_callback=buffers.append)
    assert sys.getsizeof(meta) < 4096
    assert sum(b.raw().nbytes for b in buffers) == arr.nbytes


def test_pickle5_frame_roundtrip_peak_stays_bounded(tmp_path):
    import tracemalloc

    t = SocketTransport.conformance(str(tmp_path / "p5"), LOCATIONS)
    try:
        arr = np.zeros(1 << 20)
        reader, writer = multiprocessing.Pipe(duplex=False)
        frames = []
        th = threading.Thread(target=lambda: frames.append(t._recv_frame(reader)), daemon=True)
        th.start()
        tracemalloc.start()
        try:
            t._send_frame(writer, ("msg", EP, 1, "d", arr))
            th.join(10.0)
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert peak < 2.5 * arr.nbytes
        (frame,) = frames
        assert frame[0] == "msg" and np.array_equal(frame[4], arr)
    finally:
        t.close()


def test_pickle5_roundtrip_delivers_writable_equal_array(tmp_path):
    t = SocketTransport.conformance(str(tmp_path / "rt"), LOCATIONS)
    try:
        arr = np.arange(65536, dtype=np.float64)
        t.send(EP, "a", arr)
        got = t.recv(EP, timeout=RECV_S).payload
        assert np.array_equal(got, arr)
        got[0] = -1.0  # delivered views are private and writable
        assert arr[0] == 0.0
    finally:
        t.close()
