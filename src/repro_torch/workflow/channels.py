"""In-process channels for the decentralised threaded runtime.

A copy of ``repro/workflow/channels.py``: the same seeded per-endpoint
streams, so a seed drops and delays the same messages in both packages.

Each ``(src, dst, port)`` triple gets one FIFO queue — the in-memory analogue
of the reference implementation's TCP sockets.  ``FaultyChannelRegistry``
injects transport faults (drops / delays) for the fault-tolerance tests; a
dropped message is re-sent by the sender after ``ack_timeout`` (at-least-once
delivery + idempotent receive = exactly-once effect, which is sound because
SWIRL data elements are immutable and COMM copies rather than consumes).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Hashable

Endpoint = tuple[str, str, str]  # (src, dst, port)


class ChannelClosed(Exception):
    pass


def endpoint_rng(seed: int, endpoint: Endpoint) -> random.Random:
    """Independent per-endpoint RNG stream.

    ``random.Random`` seeds strings via SHA-512, so mixing the registry seed
    with the endpoint triple is deterministic across runs and processes
    (unaffected by ``PYTHONHASHSEED``) while decorrelating the channels.
    """
    src, dst, port = endpoint
    return random.Random(f"{seed}\x1f{src}\x1f{dst}\x1f{port}")


@dataclass
class Message:
    data_name: str
    payload: Any
    seq: int = 0


class Channel:
    """One directed FIFO with optional injected unreliability."""

    def __init__(
        self,
        endpoint: Endpoint,
        *,
        drop_prob: float = 0.0,
        delay_s: float = 0.0,
        rng: random.Random | None = None,
        seed: int = 0,
    ):
        self.endpoint = endpoint
        self._items: deque[Message] = deque()
        self._cond = threading.Condition()
        self.drop_prob = drop_prob
        self.delay_s = delay_s
        # Each endpoint gets its own stream, derived from the registry seed
        # mixed with (src, dst, port) — a shared Random(0) would make every
        # channel drop/delay in lockstep, i.e. perfectly correlated faults.
        self._rng = rng or endpoint_rng(seed, endpoint)
        self.sent = 0
        self.dropped = 0
        self.delivered = 0
        self._closed = threading.Event()

    def put(self, data_name: str, payload: Any) -> bool:
        """Send; returns False if the transport 'lost' the message."""
        if self._closed.is_set():
            raise ChannelClosed(f"channel {self.endpoint} is closed")
        self.sent += 1
        if self._rng.random() < self.drop_prob:
            self.dropped += 1
            return False
        if self.delay_s:
            time.sleep(self.delay_s)
        with self._cond:
            self._items.append(Message(data_name, payload, self.sent))
            self._cond.notify()
        return True

    def put_reliable(self, data_name: str, payload: Any, *, max_tries: int = 20) -> None:
        """At-least-once: retry until the transport accepts the message."""
        for _ in range(max_tries):
            if self.put(data_name, payload):
                return
        raise ChannelClosed(
            f"channel {self.endpoint} dropped the message {max_tries} times"
        )

    def get(self, timeout: float | None = None) -> Message:
        """Blocking receive.

        A :meth:`close` wakes blocked receivers immediately: pending
        messages are still drained after close, then (and on any later
        call) :class:`ChannelClosed` is raised.  A ``timeout`` raises
        :class:`TimeoutError` exactly as before.
        """
        with self._cond:
            self._cond.wait_for(
                lambda: self._items or self._closed.is_set(), timeout
            )
            if self._items:
                return self._items.popleft()
            if self._closed.is_set():
                raise ChannelClosed(
                    f"channel {self.endpoint} closed while receiving"
                )
            raise TimeoutError(f"recv timed out on {self.endpoint}")

    def close(self) -> None:
        self._closed.set()
        with self._cond:
            self._cond.notify_all()


class ChannelRegistry:
    """Lazily creates one channel per endpoint; thread-safe.

    ``seed`` is the registry-wide fault-injection seed: each channel derives
    its own RNG from it via :func:`endpoint_rng`, so two registries with the
    same seed reproduce the same faults while distinct endpoints within one
    registry stay uncorrelated.
    """

    def __init__(self, *, seed: int = 0, **channel_kwargs):
        self._channels: dict[Endpoint, Channel] = {}
        self._lock = threading.Lock()
        self._seed = seed
        self._kwargs = channel_kwargs
        self._closed = False

    def channel(self, src: str, dst: str, port: str) -> Channel:
        key = (src, dst, port)
        with self._lock:
            if key not in self._channels:
                ch = Channel(key, seed=self._seed, **self._kwargs)
                if self._closed:
                    ch.close()
                self._channels[key] = ch
            return self._channels[key]

    def close(self) -> None:
        """Close every channel (blocked receivers raise ChannelClosed)."""
        with self._lock:
            self._closed = True
            for ch in self._channels.values():
                ch.close()

    # dict-style access used by the generated bundles (core.compile).
    def __getitem__(self, key: Endpoint):
        return _BundleChannelView(self.channel(*key))

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "channels": len(self._channels),
                "sent": sum(c.sent for c in self._channels.values()),
                "dropped": sum(c.dropped for c in self._channels.values()),
            }


class _BundleChannelView:
    """Adapter exposing the ``put((name, payload))`` / ``get()`` protocol the
    generated Python bundles expect."""

    def __init__(self, ch: Channel):
        self._ch = ch

    def put(self, item: tuple[str, Any]) -> None:
        self._ch.put_reliable(item[0], item[1])

    def get(self) -> tuple[str, Any]:
        m = self._ch.get(timeout=30.0)
        return (m.data_name, m.payload)
