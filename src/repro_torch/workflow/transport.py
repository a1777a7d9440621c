"""Pluggable COMM transports — the wire under every decentralised backend.

A copy of ``repro/workflow/transport.py``, with the port's own registry
(:func:`register_transport` / :func:`get_transport`), which never holds the
reference's classes, and one change to the socket wire: a frame or an
out-of-band buffer longer than :data:`WIRE_PART` goes as parts of at most
that size (:func:`send_pickled`, :func:`recv_pickled`).

A :class:`Transport` carries SWIRL COMM messages between locations, one
logically independent FIFO per ``(src, dst, port)`` endpoint.  The threaded
backend and the multiprocess backend both speak this interface; the only
difference between "threads over queues" and "processes over sockets" is
which transport the runtime is handed.

Contract (enforced by ``tests/test_torch_transport.py`` against every
registered implementation, as ``tests/test_transport.py`` does the
reference's):

* :meth:`Transport.send` blocks until the transport has durably accepted the
  message and returns exactly once per logical message.  Unreliable wires
  retransmit (at-least-once) and the receiving side deduplicates by sequence
  number, so the *effect* is exactly-once — sound because SWIRL data
  elements are immutable and COMM copies rather than consumes.
* Messages on one endpoint are delivered in send order; distinct endpoints
  never leak into each other.
* :meth:`Transport.recv` with a timeout raises :class:`TimeoutError`; a
  blocked ``recv`` (and any later one) raises :class:`ChannelClosed` once
  the transport is closed, after draining already-delivered messages.
* :meth:`Transport.close` is idempotent and unblocks every waiter.

Three implementations ship in-tree:

==========  ==============================================================
``memory``  :class:`InMemoryTransport` — the historical in-process queues
            (:class:`~repro_torch.workflow.channels.ChannelRegistry`) behind the
            interface; what the ``threaded`` backend uses.
``socket``  :class:`SocketTransport` — ``multiprocessing.connection``
            sockets (AF_UNIX, TCP fallback) with pickle-5 out-of-band
            payload framing, per-message acks, and resend on ack timeout;
            what the ``multiprocess`` backend uses across OS processes.
``shm``     :class:`SharedMemoryTransport` — the socket control/ack plane
            with array payloads framed through POSIX shared memory
            segments: receivers map buffers instead of deserialising
            bytes (zero-copy), non-array payloads spill to the pickle
            path.
==========  ==============================================================

Payloads, as in the reference: an ``np.ndarray`` is framed into shared
memory; anything else spills to the pickle path, a ``torch.Tensor`` included
(as a ``jax.Array`` does there).  Torch pickles a CUDA tensor through the
host and rebuilds it on its device at the receiver.  The in-memory transport
moves no payload at all: the receiver gets the very object that was sent.

Third-party transports join through :func:`register_transport` and get the
conformance suite for free by implementing :meth:`Transport.conformance`.
"""

from __future__ import annotations

import glob
import hashlib
import itertools
import os
import pickle
import socket as _socket
import tempfile
import threading
import time
import weakref
from abc import ABC, abstractmethod
from collections import deque
from typing import Any, Iterable, Mapping

import numpy as np

from .channels import (
    Channel,
    ChannelClosed,
    ChannelRegistry,
    Endpoint,
    Message,
    endpoint_rng,
)

__all__ = [
    "AckTimeout",
    "Transport",
    "InMemoryTransport",
    "SocketTransport",
    "SharedMemoryTransport",
    "HybridTransport",
    "ChannelClosed",
    "Message",
    "TRANSPORTS",
    "register_transport",
    "get_transport",
    "socket_addresses",
    "shm_namespace",
]

#: Poll interval for interruptible blocking waits.
_POLL_S = 0.05

#: AF_UNIX socket paths are limited to ~108 bytes; stay well under it.
_MAX_UNIX_PATH = 90

#: The longest message the socket wire writes.  ``Connection.recv_bytes``
#: reads a message into a fresh buffer of all that is left of it on every
#: read, and on a host whose kernel pays for a large allocation by its size
#: (the H100 machines' sandboxed kernel) a long message then moves at a few
#: MB/s: 600 MB took 157 s there.  Longer frames and buffers go as parts.
WIRE_PART = 1 << 20


def _send_parts(conn, buf) -> None:
    """Write ``buf`` as messages of at most :data:`WIRE_PART` bytes (none
    for an empty buffer)."""
    view = memoryview(buf).cast("B")
    for i in range(0, view.nbytes, WIRE_PART):
        conn.send_bytes(view[i:i + WIRE_PART])


def _recv_parts(conn, n: int) -> bytearray:
    """Read the ``n`` bytes that :func:`_send_parts` wrote."""
    buf = bytearray(n)
    view, pos = memoryview(buf), 0
    while pos < n:
        pos += conn.recv_bytes_into(view, pos)
    return buf


def send_pickled(conn, data: bytes) -> None:
    """Write one pickled frame: one message, or a ``("parts", n)`` header
    and its parts when it is longer than :data:`WIRE_PART`."""
    if len(data) <= WIRE_PART:
        conn.send_bytes(data)
        return
    conn.send_bytes(pickle.dumps(("parts", len(data)), pickle.HIGHEST_PROTOCOL))
    _send_parts(conn, data)


def recv_pickled(conn) -> Any:
    """Read and unpickle one frame written by :func:`send_pickled`."""
    obj = pickle.loads(conn.recv_bytes())
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "parts":
        obj = pickle.loads(_recv_parts(conn, obj[1]))
    return obj


class AckTimeout(ChannelClosed):
    """A send exhausted its resend budget without ever seeing an ack.

    Distinct from a peer-initiated close (a bare :class:`ChannelClosed`):
    the peer may still be alive but silent — callers deciding between
    "peer is gone" and "peer is straggling" branch on this type.  Carries
    the failing ``endpoint``, the message ``seq`` and how many ``attempts``
    were made (each attempt = one send + one ack wait).
    """

    def __init__(self, endpoint: Endpoint, *, seq: int, attempts: int):
        super().__init__(
            f"no ack after {attempts} sends on {tuple(endpoint)} "
            f"(seq {seq})"
        )
        self.endpoint = tuple(endpoint)
        self.seq = seq
        self.attempts = attempts


class Transport(ABC):
    """One reliable, per-endpoint-ordered message fabric."""

    #: Registry name (set on subclasses).
    name: str = "abstract"
    #: Whether endpoints of this transport can span OS processes.  The
    #: multiprocess backend refuses transports that cannot.
    crosses_processes: bool = False

    def open(self, endpoint: Endpoint) -> None:
        """Declare an endpoint before use (optional; default no-op)."""

    @abstractmethod
    def send(self, endpoint: Endpoint, data_name: str, payload: Any) -> None:
        """Deliver one message; blocks until accepted, exactly once."""

    def send_many(
        self, endpoint: Endpoint, items: "Iterable[tuple[str, Any]]"
    ) -> None:
        """Deliver a burst of messages on one endpoint, in order.

        Same delivery contract as per-message :meth:`send` (exactly-once
        effect, FIFO).  The default just loops; wire transports override
        it to amortise framing and the ack round trip over the burst —
        the receiver still sees ``len(items)`` ordinary messages.
        """
        for data_name, payload in items:
            self.send(endpoint, data_name, payload)

    def scatter(
        self,
        sends: "Iterable[tuple[Endpoint, Iterable[tuple[str, Any]]]]",
    ) -> None:
        """Deliver bursts to several endpoints as one fan-out exchange.

        Same delivery contract as calling :meth:`send_many` per endpoint.
        The default does exactly that; wire transports override it to
        put every destination's frame on the wire before waiting for any
        acknowledgement, so the receivers' decode work overlaps instead
        of serialising behind one ack round trip at a time.
        """
        for endpoint, items in sends:
            self.send_many(endpoint, items)

    @abstractmethod
    def recv(
        self, endpoint: Endpoint, timeout: float | None = None
    ) -> Message:
        """Next message on ``endpoint`` (FIFO); TimeoutError on timeout."""

    def close(self) -> None:
        """Tear down; idempotent, wakes blocked receivers (ChannelClosed)."""

    def stats(self) -> dict[str, Any]:
        return {}

    @classmethod
    def conformance(
        cls,
        tmp_path: str,
        locations: Iterable[str],
        *,
        loss: float = 0.0,
        ack_loss: float = 0.0,
        seed: int = 0,
    ) -> "Transport":
        """Build an instance for the conformance suite.

        Must return a transport able to both send and receive between the
        given ``locations`` within one process, with ``loss``/``ack_loss``
        injected unreliability (ignore what does not apply).  Implementing
        this is what opts a registered transport into
        ``tests/test_torch_transport.py``.
        """
        raise NotImplementedError


# ---------------------------------------------------------------------------
# In-memory transport — the refactored historical queues
# ---------------------------------------------------------------------------


class InMemoryTransport(Transport):
    """The in-process channel queues behind the :class:`Transport` API.

    Wraps a :class:`~repro_torch.workflow.channels.ChannelRegistry`; behaviour is
    exactly the pre-transport ``threaded`` backend's (including per-endpoint
    fault injection via the registry's ``drop_prob``/``delay_s``/``seed``).
    """

    name = "memory"
    crosses_processes = False

    def __init__(
        self, registry: ChannelRegistry | None = None, **channel_kwargs: Any
    ):
        if registry is not None and channel_kwargs:
            raise TypeError(
                "pass either registry= or per-channel options "
                f"({sorted(channel_kwargs)}), not both"
            )
        self.registry = registry or ChannelRegistry(**channel_kwargs)

    def open(self, endpoint: Endpoint) -> None:
        self.registry.channel(*endpoint)

    def send(self, endpoint: Endpoint, data_name: str, payload: Any) -> None:
        self.registry.channel(*endpoint).put_reliable(data_name, payload)

    def recv(
        self, endpoint: Endpoint, timeout: float | None = None
    ) -> Message:
        return self.registry.channel(*endpoint).get(timeout)

    def close(self) -> None:
        self.registry.close()

    def stats(self) -> dict[str, Any]:
        return self.registry.stats()

    @classmethod
    def conformance(
        cls,
        tmp_path: str,
        locations: Iterable[str],
        *,
        loss: float = 0.0,
        ack_loss: float = 0.0,
        seed: int = 0,
    ) -> "InMemoryTransport":
        # The queue transport has no separate ack channel: a lost ack and a
        # lost message are both "the transport did not accept it", retried
        # by put_reliable.
        return cls(drop_prob=max(loss, ack_loss), seed=seed)


# ---------------------------------------------------------------------------
# Socket transport — multiprocessing.connection with acks + resend
# ---------------------------------------------------------------------------


class _Inbox:
    """Per-endpoint delivery queue with close-aware blocking get."""

    __slots__ = ("_items", "_cond", "_closed")

    def __init__(self) -> None:
        self._items: deque[Message] = deque()
        self._cond = threading.Condition()
        self._closed = False

    def put(self, msg: Message) -> None:
        with self._cond:
            self._items.append(msg)
            self._cond.notify()

    def get(self, timeout: float | None, endpoint: Endpoint) -> Message:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._items or self._closed, timeout
            )
            if self._items:
                return self._items.popleft()
            if self._closed:
                raise ChannelClosed(
                    f"transport closed while receiving on {endpoint}"
                )
            assert not ok
            raise TimeoutError(f"recv timed out on {endpoint}")

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def socket_addresses(
    locations: Iterable[str],
    *,
    base_dir: str | os.PathLike | None = None,
    family: str | None = None,
) -> dict[str, Any]:
    """Assign one listener address per location, upfront.

    AF_UNIX paths under ``base_dir`` (or a fresh temp dir) where available —
    no port collisions, cleaned up with the directory; ``127.0.0.1``
    ephemeral ports otherwise.  Addresses are allocated *before* any worker
    starts so every process gets the same address book.
    """
    locs = sorted(set(locations))
    if family is None:
        family = "AF_UNIX" if hasattr(_socket, "AF_UNIX") else "AF_INET"
    if family == "AF_UNIX":
        if base_dir is not None:
            base = os.fspath(base_dir)
            os.makedirs(base, exist_ok=True)
        else:
            base = tempfile.mkdtemp(prefix="swirl-net-")
        paths = {
            loc: os.path.join(base, f"{i}.sock") for i, loc in enumerate(locs)
        }
        if all(len(p) <= _MAX_UNIX_PATH for p in paths.values()):
            return paths
        family = "AF_INET"  # path too long for sockaddr_un — fall back
    addrs: dict[str, Any] = {}
    for loc in locs:
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        addrs[loc] = ("127.0.0.1", s.getsockname()[1])
        s.close()
    return addrs


class SocketTransport(Transport):
    """COMM over ``multiprocessing.connection`` sockets, ack + resend.

    Every location in ``serve`` gets a listener at ``addresses[location]``;
    inbound frames are demultiplexed into per-endpoint inboxes by reader
    threads.  ``send`` opens (and caches) one client connection per endpoint,
    writes a ``("msg", endpoint, seq, name, payload)`` frame, and blocks
    until the matching ``("ack", endpoint, seq)`` arrives — resending after
    ``ack_timeout``, up to ``max_sends`` times (at-least-once).  The
    receiving side acks every copy but delivers each sequence number once
    (idempotent receive), so a lost ack never duplicates a message.

    Frames are serialised with ``pickle.HIGHEST_PROTOCOL`` and protocol-5
    out-of-band buffers: large buffer-backed payloads (numpy arrays,
    ``bytes``) travel as raw multipart segments after a small header
    instead of being copied into the pickle stream — one fewer full copy
    per side.  The receive side reads each out-of-band segment straight
    into a fresh ``bytearray`` and reconstructs arrays viewing it, so
    payloads stay writable.

    ``drop_prob`` (sender swallows the frame) and ``drop_ack_prob``
    (receiver swallows the ack) inject wire faults for the conformance and
    fault-tolerance tests, seeded per endpoint like the channel registry.

    Subclass hooks: :meth:`_encode_payload` / :meth:`_decode_payload`
    rewrite a payload on its way onto / off the wire (the shared-memory
    transport swaps arrays for segment references there), and
    :meth:`_on_acked` fires once per logical message when its ack lands
    (where segment ownership is handed off).
    """

    name = "socket"
    crosses_processes = True

    def __init__(
        self,
        addresses: Mapping[str, Any],
        *,
        serve: Iterable[str] = (),
        authkey: bytes = b"swirl-transport",
        ack_timeout: float = 1.0,
        max_sends: int = 20,
        connect_timeout: float = 15.0,
        drop_prob: float = 0.0,
        drop_ack_prob: float = 0.0,
        seed: int = 0,
    ):
        from multiprocessing.connection import Listener

        self._addresses = dict(addresses)
        self._serve = tuple(sorted(set(serve)))
        unknown = [l for l in self._serve if l not in self._addresses]
        if unknown:
            raise KeyError(f"serve locations without addresses: {unknown}")
        self._authkey = bytes(authkey)
        self.ack_timeout = float(ack_timeout)
        self.max_sends = int(max_sends)
        self.connect_timeout = float(connect_timeout)
        self.drop_prob = float(drop_prob)
        self.drop_ack_prob = float(drop_ack_prob)
        self._seed = int(seed)

        self._closed = threading.Event()
        self._inboxes: dict[Endpoint, _Inbox] = {}
        self._inbox_lock = threading.Lock()
        self._delivered: dict[Endpoint, int] = {}
        self._deliver_lock = threading.Lock()
        self._conns: dict[Endpoint, Any] = {}
        self._send_locks: dict[Endpoint, threading.Lock] = {}
        self._seq: dict[Endpoint, int] = {}
        self._drop_rngs: dict[Endpoint, Any] = {}
        self._ack_rngs: dict[Endpoint, Any] = {}
        self._server_conns: list[Any] = []
        self._threads: list[threading.Thread] = []
        # Counters are bumped from reader threads and concurrent senders —
        # serialise the read-modify-write or increments get lost.
        self._stats_lock = threading.Lock()
        self._stats = {
            "sent": 0,
            "delivered": 0,
            "duplicates": 0,
            "resends": 0,
            "dropped": 0,
            "acks_dropped": 0,
            "decode_failures": 0,
        }
        self._listeners = {}
        for loc in self._serve:
            listener = Listener(self._addresses[loc], authkey=self._authkey)
            self._listeners[loc] = listener
            th = threading.Thread(
                target=self._accept_loop,
                args=(listener,),
                name=f"swirl-accept-{loc}",
                daemon=True,
            )
            th.start()
            self._threads.append(th)

    def _bump(self, key: str) -> None:
        with self._stats_lock:
            self._stats[key] = self._stats.get(key, 0) + 1

    # -- receive path --------------------------------------------------------

    def _inbox(self, endpoint: Endpoint) -> _Inbox:
        with self._inbox_lock:
            box = self._inboxes.get(endpoint)
            if box is None:
                box = self._inboxes[endpoint] = _Inbox()
                if self._closed.is_set():
                    box.close()
            return box

    def _accept_loop(self, listener) -> None:
        while not self._closed.is_set():
            try:
                conn = listener.accept()
            except Exception:  # closed listener or failed auth handshake
                if self._closed.is_set():
                    return
                continue
            self._server_conns.append(conn)
            th = threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            )
            th.start()
            self._threads.append(th)

    # -- wire framing --------------------------------------------------------

    def _send_frame(self, conn, frame: tuple) -> None:
        """Write one frame with protocol-5 out-of-band buffer segments.

        Buffer-backed payload leaves (contiguous arrays, ``bytes``) are
        extracted by ``buffer_callback`` and written raw after a small
        ``("oob", sizes, meta)`` header — the array body is never copied
        into the pickle stream.  Frames without extractable buffers go as
        one plain pickle (also what every ack uses).
        """
        buffers: list[pickle.PickleBuffer] = []
        meta = pickle.dumps(
            frame, protocol=pickle.HIGHEST_PROTOCOL,
            buffer_callback=buffers.append,
        )
        if not buffers:
            send_pickled(conn, meta)
            return
        try:
            raws = [b.raw() for b in buffers]
        except BufferError:  # non-contiguous exotic buffer — inline it
            send_pickled(conn, pickle.dumps(frame, pickle.HIGHEST_PROTOCOL))
            return
        header = ("oob", [r.nbytes for r in raws], meta)
        send_pickled(conn, pickle.dumps(header, pickle.HIGHEST_PROTOCOL))
        for r in raws:
            _send_parts(conn, r)  # nothing for an empty buffer: the reader skips it

    @staticmethod
    def _recv_frame(conn) -> Any:
        """Read one frame; reassemble out-of-band multipart segments.

        Each out-of-band segment lands in a fresh writable ``bytearray``
        via ``recv_bytes_into``, part by part, and the reconstructed arrays
        view those buffers directly — not pickle-decode plus array-build.
        """
        obj = recv_pickled(conn)
        if not (isinstance(obj, tuple) and obj and obj[0] == "oob"):
            return obj
        _, sizes, meta = obj
        return pickle.loads(meta, buffers=[_recv_parts(conn, n) for n in sizes])

    # -- payload hooks (overridden by SharedMemoryTransport) -----------------

    def _encode_payload(self, endpoint: Endpoint, seq: int, payload: Any):
        """Rewrite a payload before it is framed (once per logical send)."""
        return payload

    def _decode_payload(self, endpoint: Endpoint, payload: Any) -> Any:
        """Rewrite a payload after the frame is read, before delivery."""
        return payload

    def _on_acked(self, endpoint: Endpoint, seq: int) -> None:
        """The ack for ``(endpoint, seq)`` landed — the message arrived."""

    def _ack_frame(self, conn, endpoint: Endpoint, seq: int) -> tuple:
        """Build the ack for a delivered message (hook: shm piggybacks
        payload releases here so receivers never write control frames
        from consumer threads)."""
        return ("ack", endpoint, seq)

    def _reader(self, conn) -> None:
        while not self._closed.is_set():
            try:
                frame = self._recv_frame(conn)
            except (EOFError, OSError):
                break
            if not (isinstance(frame, tuple) and frame):
                continue
            if frame[0] == "msg":
                _, endpoint, seq, name, payload = frame
                first, batch = seq, [(name, payload)]
            elif frame[0] == "msgs":
                _, endpoint, first, batch = frame
            else:
                continue
            endpoint = tuple(endpoint)
            duplicates = delivered = 0
            with self._deliver_lock:
                hwm = self._delivered.get(endpoint, 0)
                fresh: list[tuple[str, Any, int]] = []
                decode_ok = True
                for i, (name, payload) in enumerate(batch):
                    seq_i = first + i
                    if seq_i <= hwm:
                        duplicates += 1  # resend of a delivered prefix
                        continue
                    try:
                        payload = self._decode_payload(endpoint, payload)
                    except Exception:
                        # A fresh payload we cannot decode (e.g. its
                        # segment vanished): stop here and ack only the
                        # progress made, so the sender's at-least-once
                        # resend retries the rest rather than losing it.
                        self._bump("decode_failures")
                        decode_ok = False
                        break
                    fresh.append((name, payload, seq_i))
                if not fresh and not decode_ok:
                    continue  # no progress at all: withhold the ack
                if fresh:
                    self._delivered[endpoint] = fresh[-1][2]
                ack_seq = fresh[-1][2] if fresh else first + len(batch) - 1
                # Ack BEFORE the messages become consumable: once they are
                # in the inbox the receiving worker may finish its program
                # and close this transport, and an ack queued after that
                # close is lost — the sender then dies awaiting it.  Socket
                # buffers survive close, so an ack already on the wire is
                # always readable by the sender.
                if (
                    self.drop_ack_prob
                    and self._rng(self._ack_rngs, endpoint, salt=1).random()
                    < self.drop_ack_prob
                ):
                    self._bump("acks_dropped")
                    acked = True  # simulated loss: keep serving
                else:
                    try:
                        conn.send(self._ack_frame(conn, endpoint, ack_seq))
                        acked = True
                    except (EOFError, OSError, BrokenPipeError):
                        acked = False  # sender gone; deliver, then stop
                # Deliver under the lock so two connections carrying the
                # same endpoint cannot reorder fresh sequence numbers.
                for name, payload, seq_i in fresh:
                    self._inbox(endpoint).put(Message(name, payload, seq_i))
                    delivered += 1
            with self._stats_lock:
                self._stats["duplicates"] += duplicates
                self._stats["delivered"] += delivered
            if not acked:
                break

    def recv(
        self, endpoint: Endpoint, timeout: float | None = None
    ) -> Message:
        return self._inbox(tuple(endpoint)).get(timeout, tuple(endpoint))

    # -- send path -----------------------------------------------------------

    def _rng(self, cache: dict, endpoint: Endpoint, *, salt: int = 0):
        rng = cache.get(endpoint)
        if rng is None:
            rng = cache[endpoint] = endpoint_rng(self._seed + salt, endpoint)
        return rng

    def _connect(self, endpoint: Endpoint):
        from multiprocessing.connection import Client

        conn = self._conns.get(endpoint)
        if conn is not None:
            return conn
        dst = endpoint[1]
        try:
            address = self._addresses[dst]
        except KeyError:
            raise KeyError(
                f"no address for destination {dst!r}; "
                f"known: {sorted(self._addresses)}"
            ) from None
        deadline = time.monotonic() + self.connect_timeout
        while True:
            if self._closed.is_set():
                raise ChannelClosed(f"transport closed; cannot reach {dst!r}")
            try:
                conn = Client(address, authkey=self._authkey)
                break
            except (OSError, EOFError) as e:
                # Peer's listener may not be bound yet — retry briefly.
                if time.monotonic() >= deadline:
                    raise ChannelClosed(
                        f"cannot connect to {dst!r} at {address!r}: {e}"
                    ) from e
                time.sleep(0.02)
        self._conns[endpoint] = conn
        return conn

    def send(self, endpoint: Endpoint, data_name: str, payload: Any) -> None:
        endpoint = tuple(endpoint)
        if self._closed.is_set():
            raise ChannelClosed(f"transport closed; cannot send on {endpoint}")
        lock = self._send_locks.setdefault(endpoint, threading.Lock())
        with lock:
            conn = self._connect(endpoint)
            self._seq[endpoint] = seq = self._seq.get(endpoint, 0) + 1
            self._bump("sent")
            # Encode once per logical message — resends reuse the frame
            # (and, for the shm transport, the already-written segment).
            payload = self._encode_payload(endpoint, seq, payload)
            frame = ("msg", endpoint, seq, data_name, payload)
            rng = self._rng(self._drop_rngs, endpoint)
            for attempt in range(self.max_sends):
                if self._closed.is_set():
                    raise ChannelClosed(
                        f"transport closed; cannot send on {endpoint}"
                    )
                if attempt:
                    self._bump("resends")
                if self.drop_prob and rng.random() < self.drop_prob:
                    self._bump("dropped")  # simulated wire loss
                else:
                    try:
                        self._send_frame(conn, frame)
                    except (OSError, BrokenPipeError, ValueError) as e:
                        raise ChannelClosed(
                            f"connection lost on {endpoint}: {e}"
                        ) from e
                if self._await_ack(conn, endpoint, seq):
                    self._on_acked(endpoint, seq)
                    return
            raise AckTimeout(endpoint, seq=seq, attempts=self.max_sends)

    def send_many(
        self, endpoint: Endpoint, items: "Iterable[tuple[str, Any]]"
    ) -> None:
        """Burst send: one wire frame and one ack round trip for the lot.

        The per-message protocol cost (framing, syscalls, the receiver
        wake-up and the ack wait) is paid once per burst instead of once
        per payload — on a busy fleet the round trip dominates small
        payload costs, so rank-synchronous exchanges batch naturally.
        Delivery semantics are exactly ``len(items)`` ordered sends: the
        receiver acks the highest consecutive sequence it has decoded,
        and a resend after partial progress skips the delivered prefix.
        """
        items = list(items)
        if not items:
            return
        if len(items) == 1:
            return self.send(endpoint, items[0][0], items[0][1])
        endpoint = tuple(endpoint)
        if self._closed.is_set():
            raise ChannelClosed(f"transport closed; cannot send on {endpoint}")
        lock = self._send_locks.setdefault(endpoint, threading.Lock())
        with lock:
            conn = self._connect(endpoint)
            first = self._seq.get(endpoint, 0) + 1
            last = first + len(items) - 1
            self._seq[endpoint] = last
            with self._stats_lock:
                self._stats["sent"] += len(items)
            encoded = [
                (name, self._encode_payload(endpoint, first + i, payload))
                for i, (name, payload) in enumerate(items)
            ]
            frame = ("msgs", endpoint, first, encoded)
            rng = self._rng(self._drop_rngs, endpoint)
            for attempt in range(self.max_sends):
                if self._closed.is_set():
                    raise ChannelClosed(
                        f"transport closed; cannot send on {endpoint}"
                    )
                if attempt:
                    self._bump("resends")
                if self.drop_prob and rng.random() < self.drop_prob:
                    self._bump("dropped")  # simulated wire loss
                else:
                    try:
                        self._send_frame(conn, frame)
                    except (OSError, BrokenPipeError, ValueError) as e:
                        raise ChannelClosed(
                            f"connection lost on {endpoint}: {e}"
                        ) from e
                if self._await_ack(conn, endpoint, last):
                    for i in range(len(items)):
                        self._on_acked(endpoint, first + i)
                    return
            raise AckTimeout(endpoint, seq=last, attempts=self.max_sends)

    def scatter(
        self,
        sends: "Iterable[tuple[Endpoint, Iterable[tuple[str, Any]]]]",
    ) -> None:
        """Pipelined fan-out: frames to every destination, then the acks.

        A serial ``send_many`` loop leaves every other receiver idle
        while the sender blocks on one ack; here all frames hit the wire
        first, so the receivers decode concurrently and the sender pays
        roughly one ack latency for the whole exchange instead of one
        per destination.  Endpoint locks are taken in sorted order so
        concurrent scatters over overlapping destinations cannot
        deadlock.
        """
        sends = [(tuple(ep), list(items)) for ep, items in sends]
        sends = [(ep, items) for ep, items in sends if items]
        if not sends:
            return
        if len(sends) == 1:
            return self.send_many(sends[0][0], sends[0][1])
        if self._closed.is_set():
            raise ChannelClosed("transport closed; cannot scatter")
        sends.sort(key=lambda s: s[0])
        acquired: list[threading.Lock] = []
        pending: list[tuple] = []
        try:
            for endpoint, items in sends:
                lock = self._send_locks.setdefault(endpoint, threading.Lock())
                lock.acquire()
                acquired.append(lock)
                conn = self._connect(endpoint)
                first = self._seq.get(endpoint, 0) + 1
                last = first + len(items) - 1
                self._seq[endpoint] = last
                with self._stats_lock:
                    self._stats["sent"] += len(items)
                encoded = [
                    (name, self._encode_payload(endpoint, first + i, payload))
                    for i, (name, payload) in enumerate(items)
                ]
                if len(encoded) == 1:
                    frame = ("msg", endpoint, first, encoded[0][0], encoded[0][1])
                else:
                    frame = ("msgs", endpoint, first, encoded)
                rng = self._rng(self._drop_rngs, endpoint)
                if self.drop_prob and rng.random() < self.drop_prob:
                    self._bump("dropped")  # simulated wire loss
                else:
                    try:
                        self._send_frame(conn, frame)
                    except (OSError, BrokenPipeError, ValueError) as e:
                        raise ChannelClosed(
                            f"connection lost on {endpoint}: {e}"
                        ) from e
                pending.append((endpoint, conn, frame, first, last, rng))
            for endpoint, conn, frame, first, last, rng in pending:
                for attempt in range(self.max_sends):
                    if self._await_ack(conn, endpoint, last):
                        for seq in range(first, last + 1):
                            self._on_acked(endpoint, seq)
                        break
                    if self._closed.is_set():
                        raise ChannelClosed(
                            f"transport closed; cannot send on {endpoint}"
                        )
                    self._bump("resends")
                    if self.drop_prob and rng.random() < self.drop_prob:
                        self._bump("dropped")  # simulated wire loss
                    else:
                        try:
                            self._send_frame(conn, frame)
                        except (OSError, BrokenPipeError, ValueError) as e:
                            raise ChannelClosed(
                                f"connection lost on {endpoint}: {e}"
                            ) from e
                else:
                    raise AckTimeout(
                        endpoint, seq=last, attempts=self.max_sends
                    )
        finally:
            for lock in acquired:
                lock.release()

    def _await_ack(self, conn, endpoint: Endpoint, seq: int) -> bool:
        deadline = time.monotonic() + self.ack_timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                if conn.poll(min(remaining, _POLL_S)):
                    frame = conn.recv()
                    if (
                        isinstance(frame, tuple)
                        and len(frame) == 3
                        and frame[0] == "ack"
                        and tuple(frame[1]) == endpoint
                        and frame[2] == seq
                    ):
                        return True
                    # Stale ack from an earlier resend — keep waiting.
            except (EOFError, OSError) as e:
                if self._closed.is_set():
                    raise ChannelClosed(
                        f"transport closed; cannot send on {endpoint}"
                    ) from e
                raise ChannelClosed(
                    f"connection lost awaiting ack on {endpoint}: {e}"
                ) from e

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for listener in self._listeners.values():
            try:
                listener.close()
            except OSError:
                pass
        for conn in list(self._conns.values()) + list(self._server_conns):
            try:
                conn.close()
            except OSError:
                pass
        with self._inbox_lock:
            for box in self._inboxes.values():
                box.close()
        for th in self._threads:
            th.join(0.2)

    def stats(self) -> dict[str, Any]:
        with self._stats_lock:
            return dict(self._stats, serving=list(self._serve))

    @classmethod
    def conformance(
        cls,
        tmp_path: str,
        locations: Iterable[str],
        *,
        loss: float = 0.0,
        ack_loss: float = 0.0,
        seed: int = 0,
    ) -> "SocketTransport":
        return cls(
            socket_addresses(locations, base_dir=tmp_path),
            serve=locations,
            ack_timeout=0.1,
            connect_timeout=5.0,
            drop_prob=loss,
            drop_ack_prob=ack_loss,
            seed=seed,
        )


# ---------------------------------------------------------------------------
# Shared-memory transport — zero-copy array payloads over the socket plane
# ---------------------------------------------------------------------------


def shm_namespace(authkey: bytes) -> str:
    """Segment-name prefix for one transport fleet.

    Derived from the fleet's ``authkey`` so every worker of one attempt —
    and the coordinator that tears the attempt down — agrees on the prefix
    without an extra configuration channel.  Crash cleanup is a glob over
    this prefix (:meth:`SharedMemoryTransport.sweep`).
    """
    return "swirl-" + hashlib.blake2s(bytes(authkey), digest_size=5).hexdigest()


def _untrack_segment(shm) -> None:
    """Withdraw a segment from ``multiprocessing.resource_tracker``.

    The stdlib registers every created *and* attached segment and its
    tracker both warns about and force-unlinks whatever is still
    registered at shutdown — unacceptable for segments whose ownership
    crosses processes (the sender creates, the receiver may outlive the
    name).  Unregistering immediately after the stdlib's register keeps
    the tracker's pipe balanced (adjacent add/remove pairs are safe
    whether the tracker is shared via fork or per-process via spawn) and
    leaves reclamation entirely to the transport protocol.
    """
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _unlink_segment_name(name: str) -> None:
    """Remove a segment's name (POSIX ``shm_unlink``); mappings survive."""
    try:
        import _posixshmem

        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass
    except ImportError:  # non-POSIX: fall back to the stdlib path
        from multiprocessing import shared_memory

        try:
            seg = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            return
        _untrack_segment(seg)
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:
            pass


def _close_mapping(shm) -> None:
    """Finalizer target: drop one received segment mapping."""
    try:
        shm.close()
    except BufferError:  # a stray export still alive — freed with process
        pass


class _SegmentRef:
    """Wire header standing in for an array payload: where + what shape.

    Pickles to a few dozen bytes regardless of payload size — the whole
    point: the receiver maps ``name`` (once per arena) and views the
    bytes at ``offset`` instead of deserialising the body.
    """

    __slots__ = ("name", "offset", "dtype", "shape", "nbytes")

    def __init__(
        self, name: str, offset: int, dtype: str, shape: tuple, nbytes: int
    ):
        self.name = name
        self.offset = offset
        self.dtype = dtype
        self.shape = shape
        self.nbytes = nbytes

    def __reduce__(self):
        return (
            _SegmentRef,
            (self.name, self.offset, self.dtype, self.shape, self.nbytes),
        )


class _Arena:
    """One sender-owned shared-memory slab, bump-allocated per payload."""

    __slots__ = ("seg", "offset", "live", "gen")

    def __init__(self, seg):
        self.seg = seg
        self.offset = 0
        self.live = 0  # payloads written here whose receiver view is alive
        self.gen = 0  # bumped on rewind: invalidates broadcast-dedup refs


class SharedMemoryTransport(SocketTransport):
    """Zero-copy IPC: socket control plane, shared-memory data plane.

    Array payloads of at least ``min_frame_bytes`` are written into a
    pooled POSIX shared-memory slab (``multiprocessing.shared_memory``);
    the wire then carries only a :class:`_SegmentRef` header (segment
    name, dtype, shape).  The receiver maps the segment — once per
    segment, cached — and delivers an ndarray *view* over the mapping: no
    pickle of the body, no receive-side copy, no per-message mmap.
    Everything else (acks, resend, dedup, fault injection) is inherited
    from :class:`SocketTransport`, so the reliability contract and the
    conformance suite carry over unchanged.

    The arena allocator with refcounted reclamation is what makes this
    fast: creating and mapping a fresh segment per message costs as much
    in page faults as pickling the payload would (~0.5 ms for 512 KiB).
    Instead:

    * payloads are bump-allocated at 64-byte-aligned offsets inside big
      (``arena_bytes``, default 8 MiB) segments, so segment creation and
      the receiver's ``mmap`` are paid once per *arena*, not per message
      — and a background thread pre-creates and pre-faults the next
      arena (``os.pwrite`` into the tmpfs backing file, GIL released)
      while the sender is blocked in ack waits, keeping cold page faults
      off the critical path entirely.
    * the receiver maps each arena on first sight and caches the
      mapping; the delivered view carries a ``weakref.finalize`` that
      fires when the last reference to the payload dies and sends a tiny
      ``("rel", name)`` frame back over the control plane — the refcount
      drop that lets the sender rewind the arena once every payload in
      it has been consumed.  A receiver that *retains* payloads (the
      normal case: data scopes hold them for the program's lifetime)
      simply keeps arenas pinned — the sender rolls on to fresh
      pre-faulted arenas at the same per-message cost.
    * the sender drains release frames while it waits for acks (and
      opportunistically before each send), recycling arenas without any
      extra round trip.
    * ``close`` unlinks every arena this transport created (current,
      spare, pinned, or free) and drops cached receive mappings;
      :meth:`sweep` lets a coordinator bulk-remove a crashed fleet's
      segments by namespace prefix.

    Non-array payloads (and tiny arrays, where the header round trip
    costs more than pickling) spill to the inherited pickle-5 path
    untouched.
    """

    name = "shm"
    crosses_processes = True

    def __init__(
        self,
        addresses: Mapping[str, Any],
        *,
        serve: Iterable[str] = (),
        authkey: bytes = b"swirl-transport",
        ack_timeout: float = 1.0,
        max_sends: int = 20,
        connect_timeout: float = 15.0,
        drop_prob: float = 0.0,
        drop_ack_prob: float = 0.0,
        seed: int = 0,
        min_frame_bytes: int = 1024,
        arena_bytes: int = 1 << 23,
        namespace: str | None = None,
    ):
        # Everything the reader threads touch must exist before
        # super().__init__ binds listeners (a peer can connect — and a
        # reader can start decoding — before this constructor returns).
        self.min_frame_bytes = int(min_frame_bytes)
        self.arena_bytes = int(arena_bytes)
        self.namespace = namespace or shm_namespace(authkey)
        self._segment_ids = itertools.count()
        self._seg_lock = threading.Lock()
        #: The arena currently being filled by sends.
        self._arena: _Arena | None = None
        #: Every arena this transport created: segment name -> _Arena.
        self._arenas: dict[str, _Arena] = {}
        #: Drained arenas (live == 0, rewound) ready for reuse.
        self._free_arenas: deque = deque()
        #: Pre-created, pre-faulted arenas maintained by the prefault
        #: thread.  Depth 2: one arena is consumed in ~the time one is
        #: prefaulted, so a single spare is chronically late.
        self._spare_arenas: deque = deque()
        self._spare_target = 2
        self._spare_evt = threading.Event()
        self._spare_thread: threading.Thread | None = None
        #: Broadcast dedup: id(array) -> (weakref, arena, gen, ref).  A
        #: fan-out resend of the *same array object* reuses the already
        #: written segment bytes — header-only repeat sends.
        self._payload_cache: dict[int, tuple] = {}
        #: Receiver-side mapping cache: segment name -> SharedMemory.
        self._attach_cache: dict[str, Any] = {}
        #: Consumed-payload names queued per connection, flushed onto the
        #: next outgoing ack (releases fire from whichever thread drops
        #: the last delivered view — they must not write to the socket).
        self._rel_lock = threading.Lock()
        self._pending_rels: dict[int, list[str]] = {}
        #: Per-reader-thread connection, so _decode_payload can route
        #: release frames back to the sender that owns the arena.
        self._reader_state = threading.local()
        super().__init__(
            addresses,
            serve=serve,
            authkey=authkey,
            ack_timeout=ack_timeout,
            max_sends=max_sends,
            connect_timeout=connect_timeout,
            drop_prob=drop_prob,
            drop_ack_prob=drop_ack_prob,
            seed=seed,
        )
        with self._stats_lock:
            self._stats.setdefault("segments_created", 0)
            self._stats.setdefault("segments_reused", 0)
            self._stats.setdefault("segments_released", 0)
            self._stats.setdefault("mapped_recvs", 0)
            self._stats.setdefault("spilled_sends", 0)
            self._stats.setdefault("dedup_sends", 0)

    # -- arena allocator -----------------------------------------------------

    def _create_arena(self, size: int, *, prefault: bool = False) -> _Arena:
        from multiprocessing import shared_memory

        name = f"{self.namespace}-{os.getpid()}-{next(self._segment_ids)}"
        seg = shared_memory.SharedMemory(name=name, create=True, size=size)
        _untrack_segment(seg)
        if prefault:
            self._prefault(seg)
        self._bump("segments_created")
        return _Arena(seg)

    @staticmethod
    def _prefault(seg) -> None:
        """Touch every page so first payload writes find them warm.

        One byte stored per page is enough: the fault allocates the page
        (the kernel zeroes it — no explicit memset needed) and installs
        the page-table entry in *this* mapping, which is what makes the
        later payload write ~7x faster.  Chunked with a yield between
        chunks because a CPython thread that never blocks only
        surrenders the GIL every switch interval (5 ms default), and a
        5 ms stall on a sender's ack path would dwarf the whole message
        cost.
        """
        page, chunk = 4096, 1 << 17
        try:
            mem = np.frombuffer(seg.buf, dtype=np.uint8)
        except (ValueError, TypeError):
            return  # exotic mapping; first writes fault instead
        for off in range(0, seg.size, chunk):
            mem[off : off + chunk : page] = 0
            time.sleep(0)
        del mem

    def _spawn_prefault(self) -> None:
        """Start the standing prefault thread (idempotent)."""
        if self._spare_thread is not None or self._closed.is_set():
            return
        with self._seg_lock:
            if self._spare_thread is not None:
                return
            th = self._spare_thread = threading.Thread(
                target=self._prefault_loop, name="swirl-shm-prefault",
                daemon=True,
            )
        self._spare_evt.set()
        th.start()

    def _prefault_loop(self) -> None:
        """Keep ``_spare_target`` pre-faulted arenas ready off the
        critical path; senders that outrun the recycle stream (receivers
        retaining payloads — the common case) roll onto these instead of
        paying ~0.9 ms of page faults inline per 512 KiB payload."""
        while not self._closed.is_set():
            with self._seg_lock:
                sated = (
                    len(self._spare_arenas) >= self._spare_target
                    or bool(self._free_arenas)
                )
            if sated:
                self._spare_evt.clear()
                self._spare_evt.wait(0.5)
                continue
            try:
                arena = self._create_arena(self.arena_bytes, prefault=True)
            except Exception:
                return  # /dev/shm exhausted or gone: senders fault inline
            with self._seg_lock:
                if self._closed.is_set():
                    stale = arena
                else:
                    self._arenas[arena.seg.name] = arena
                    self._spare_arenas.append(arena)
                    stale = None
            if stale is not None:
                _close_mapping(stale.seg)
                _unlink_segment_name(stale.seg.name)
                return

    def _take_arena(self, need: int) -> _Arena:
        """Current arena lacks ``need`` bytes — roll to the next one.

        Preference order: a drained recycled arena (its pages are warm
        from the last pass), then a pre-faulted spare, then (pool miss —
        pays the faults inline) a fresh one.  Oversize payloads get a
        dedicated arena of their own size.  Callers hold ``_seg_lock``.
        """
        if need > self.arena_bytes:
            arena = self._create_arena(need)
            self._arenas[arena.seg.name] = arena
            return arena
        if self._free_arenas:
            arena = self._free_arenas.popleft()
            self._bump("segments_reused")
            return arena
        if self._spare_arenas:
            arena = self._spare_arenas.popleft()
            self._spare_evt.set()
            return arena
        arena = self._create_arena(self.arena_bytes)
        self._arenas[arena.seg.name] = arena
        return arena

    def _release_payload(self, name: str) -> None:
        """A ``("rel", name)`` frame arrived: one delivered view into
        arena ``name`` died.  When the arena's last live payload goes,
        rewind it — every byte is reusable again."""
        recycled = False
        with self._seg_lock:
            arena = self._arenas.get(name)
            if arena is None:
                return  # already reclaimed by close()
            arena.live -= 1
            if arena.live <= 0:
                arena.live = 0
                arena.offset = 0
                arena.gen += 1  # stored bytes are no longer addressable
                if arena is not self._arena:
                    self._free_arenas.append(arena)
                recycled = True
        if recycled:
            self._bump("segments_released")

    def _handle_control(self, frame: Any) -> bool:
        """Process the release content of a control frame.

        Returns True for pure ``("rel", name)`` frames (fully consumed);
        releases piggybacked on a 4-tuple ack are processed here too, but
        the ack itself is left for the caller to match.
        """
        if isinstance(frame, tuple):
            if len(frame) == 2 and frame[0] == "rel":
                self._release_payload(frame[1])
                return True
            if len(frame) == 4 and frame[0] == "ack":
                for name in frame[3]:
                    self._release_payload(name)
        return False

    def _drain_control(self, conn) -> None:
        """Consume queued release/stale-ack frames outside an ack wait."""
        try:
            while conn.poll(0):
                self._handle_control(conn.recv())
        except (EOFError, OSError):
            pass

    # -- payload hooks -------------------------------------------------------

    def _encode_payload(self, endpoint: Endpoint, seq: int, payload: Any):
        if (
            not isinstance(payload, np.ndarray)
            or payload.nbytes < self.min_frame_bytes
            or payload.dtype.hasobject
        ):
            self._bump("spilled_sends")
            return payload
        self._drain_control(self._conns[endpoint])
        # Fan-out dedup: the same array object sent again (a broadcast to
        # another location) reuses its segment bytes — one copy total, a
        # header-only frame per extra destination.  Callers must treat
        # payloads as frozen once handed to the transport (the resend
        # loop already requires this); dedup extends that window until
        # the last recipient has consumed the payload.
        key = id(payload)
        with self._seg_lock:
            hit = self._payload_cache.get(key)
            if hit is not None:
                wref, arena, gen, ref = hit
                if (
                    wref() is payload
                    and self._arenas.get(ref.name) is arena
                    and arena.gen == gen
                ):
                    arena.live += 1
                    hit = ref
                else:
                    del self._payload_cache[key]
                    hit = None
        if hit is not None:
            self._bump("dedup_sends")
            return hit
        arr = np.ascontiguousarray(payload)
        need = max((arr.nbytes + 63) & ~63, 64)  # 64-byte aligned slots
        with self._seg_lock:
            arena = self._arena
            if arena is None or arena.offset + need > arena.seg.size:
                arena = self._arena = self._take_arena(need)
            off = arena.offset
            arena.offset += need
            arena.live += 1
            want_spare = (
                len(self._spare_arenas) < self._spare_target
                and not self._free_arenas
            )
        if want_spare:
            if self._spare_thread is None:
                self._spawn_prefault()
            else:
                self._spare_evt.set()
        dst = np.ndarray(
            arr.shape, dtype=arr.dtype, buffer=arena.seg.buf, offset=off
        )
        dst[...] = arr  # the one copy on the whole path
        del dst
        ref = _SegmentRef(
            arena.seg.name, off, arr.dtype.str, arr.shape, arr.nbytes
        )
        try:
            wref = weakref.ref(payload)
        except TypeError:
            return ref  # subclass without weakref support: no dedup
        with self._seg_lock:
            if len(self._payload_cache) > 512:
                for k in [
                    k
                    for k, (w, *_rest) in self._payload_cache.items()
                    if w() is None
                ]:
                    del self._payload_cache[k]
            self._payload_cache[key] = (wref, arena, arena.gen, ref)
        return ref

    def _queue_release(self, conn, name: str) -> None:
        """Finalizer target: mark one delivered payload as consumed.

        No socket I/O here — finalizers run on whichever thread drops the
        last view, and a per-message control write from the consumer
        thread stalls the reader (measured: it triples the ack round
        trip).  The name is queued and rides out on the next ack the
        reader sends over the same connection (:meth:`_ack_frame`).
        """
        if self._closed.is_set():
            return
        with self._rel_lock:
            self._pending_rels.setdefault(id(conn), []).append(name)

    def _ack_frame(self, conn, endpoint: Endpoint, seq: int) -> tuple:
        with self._rel_lock:
            rels = self._pending_rels.pop(id(conn), None)
        if rels:
            return ("ack", endpoint, seq, tuple(rels))
        return ("ack", endpoint, seq)

    def _decode_payload(self, endpoint: Endpoint, payload: Any) -> Any:
        if type(payload) is not _SegmentRef:
            return payload
        conn = self._reader_state.conn
        with self._seg_lock:
            seg = self._attach_cache.get(payload.name)
        if seg is None:
            from multiprocessing import shared_memory

            seg = shared_memory.SharedMemory(name=payload.name)
            _untrack_segment(seg)
            with self._seg_lock:
                seg = self._attach_cache.setdefault(payload.name, seg)
        arr = np.ndarray(
            payload.shape,
            dtype=np.dtype(payload.dtype),
            buffer=seg.buf,
            offset=payload.offset,
        )
        # Refcounted reclamation: when the last reference to the payload
        # (or any derived view) dies, tell the sender one more payload of
        # its arena has been consumed.
        weakref.finalize(arr, self._queue_release, conn, payload.name)
        self._bump("mapped_recvs")
        return arr

    # -- control-plane overrides ---------------------------------------------

    def _reader(self, conn) -> None:
        self._reader_state.conn = conn
        super()._reader(conn)

    def _await_ack(self, conn, endpoint: Endpoint, seq: int) -> bool:
        deadline = time.monotonic() + self.ack_timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                if conn.poll(min(remaining, _POLL_S)):
                    frame = conn.recv()
                    if self._handle_control(frame):
                        continue
                    if (
                        isinstance(frame, tuple)
                        and len(frame) in (3, 4)
                        and frame[0] == "ack"
                        and tuple(frame[1]) == endpoint
                        and frame[2] == seq
                    ):
                        return True
                    # Stale ack from an earlier resend — keep waiting.
            except (EOFError, OSError) as e:
                if self._closed.is_set():
                    raise ChannelClosed(
                        f"transport closed; cannot send on {endpoint}"
                    ) from e
                raise ChannelClosed(
                    f"connection lost awaiting ack on {endpoint}: {e}"
                ) from e

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        first = not self._closed.is_set()
        super().close()
        if not first:
            return
        self._spare_evt.set()  # unblock the prefault thread so it exits
        with self._seg_lock:
            own = [arena.seg for arena in self._arenas.values()]
            self._arenas.clear()
            self._free_arenas.clear()
            self._spare_arenas.clear()
            self._arena = None
            attached = dict(self._attach_cache)
        for seg in own:
            try:
                seg.close()
            except BufferError:
                pass
            _unlink_segment_name(seg.name)
        for name, seg in attached.items():
            # Drop mappings whose delivered views are all dead; a mapping
            # with live views stays cached (and valid — only the *name*
            # was the sender's to unlink) until the views are collected.
            try:
                seg.close()
            except BufferError:
                continue
            with self._seg_lock:
                self._attach_cache.pop(name, None)

    @classmethod
    def sweep(cls, authkey: bytes) -> int:
        """Crash teardown: unlink every leftover segment of one fleet.

        A worker killed mid-send cannot run its own cleanup; the
        coordinator knows the fleet's ``authkey`` and removes whatever the
        namespace glob still finds.  Returns the number of segments
        removed.  No-op where ``/dev/shm`` does not exist (non-Linux) —
        there the per-process ``close`` paths are the only cleanup.
        """
        prefix = shm_namespace(authkey)
        removed = 0
        for path in glob.glob(f"/dev/shm/{prefix}-*"):
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
        return removed

    @classmethod
    def conformance(
        cls,
        tmp_path: str,
        locations: Iterable[str],
        *,
        loss: float = 0.0,
        ack_loss: float = 0.0,
        seed: int = 0,
    ) -> "SharedMemoryTransport":
        return cls(
            socket_addresses(locations, base_dir=tmp_path),
            serve=locations,
            ack_timeout=0.1,
            connect_timeout=5.0,
            drop_prob=loss,
            drop_ack_prob=ack_loss,
            seed=seed,
            min_frame_bytes=64,  # exercise the segment path on small arrays
        )


# ---------------------------------------------------------------------------
# Hybrid transport — in-process hops for co-resident locations
# ---------------------------------------------------------------------------


class HybridTransport(Transport):
    """Route co-resident endpoints in memory, the rest over another wire.

    When several locations share one process (the multiprocess backend's
    schedule pinning / ``workers=`` packing), an endpoint whose ``src`` and
    ``dst`` are both local has no reason to pay pickling + socket loopback:
    it goes through ``local`` (an :class:`InMemoryTransport` by default)
    while every cross-process endpoint uses ``remote``.  This is what makes
    the cost model's "cheap intra-rack links" literal: pinned locations
    talk at memory speed.

    Not in the named-transport registry — it is a per-process composite
    built around an already-configured remote transport, not a wire you
    select by name.
    """

    name = "hybrid"
    crosses_processes = False

    def __init__(
        self,
        remote: Transport,
        local_locations,
        *,
        local: Transport | None = None,
    ):
        self.remote = remote
        self.local = local or InMemoryTransport()
        self._local_locs = frozenset(local_locations)

    def _pick(self, endpoint: Endpoint) -> Transport:
        src, dst, _ = endpoint
        if src in self._local_locs and dst in self._local_locs:
            return self.local
        return self.remote

    def open(self, endpoint: Endpoint) -> None:
        self._pick(endpoint).open(endpoint)

    def send(self, endpoint: Endpoint, data_name: str, payload: Any) -> None:
        self._pick(endpoint).send(endpoint, data_name, payload)

    def send_many(
        self, endpoint: Endpoint, items: "Iterable[tuple[str, Any]]"
    ) -> None:
        self._pick(endpoint).send_many(endpoint, items)

    def scatter(
        self,
        sends: "Iterable[tuple[Endpoint, Iterable[tuple[str, Any]]]]",
    ) -> None:
        by_transport: dict[int, tuple[Transport, list]] = {}
        for endpoint, items in sends:
            t = self._pick(endpoint)
            by_transport.setdefault(id(t), (t, []))[1].append(
                (endpoint, items)
            )
        for t, group in by_transport.values():
            t.scatter(group)

    def recv(
        self, endpoint: Endpoint, timeout: float | None = None
    ) -> Message:
        return self._pick(endpoint).recv(endpoint, timeout)

    def close(self) -> None:
        self.local.close()
        self.remote.close()

    def stats(self) -> dict[str, Any]:
        return {
            "local": self.local.stats(),
            "remote": self.remote.stats(),
            "local_locations": sorted(self._local_locs),
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

TRANSPORTS: dict[str, type[Transport]] = {}


def register_transport(
    name: str, cls: type[Transport], *, overwrite: bool = False
) -> None:
    """Make ``cls`` selectable by name (backend ``transport=`` options)."""
    if not overwrite and name in TRANSPORTS:
        raise ValueError(f"transport {name!r} is already registered")
    TRANSPORTS[name] = cls


def get_transport(name: str) -> type[Transport]:
    try:
        return TRANSPORTS[name]
    except KeyError:
        raise KeyError(
            f"unknown transport {name!r}; available: {sorted(TRANSPORTS)}"
        ) from None


register_transport("memory", InMemoryTransport)
register_transport("socket", SocketTransport)
register_transport("shm", SharedMemoryTransport)
