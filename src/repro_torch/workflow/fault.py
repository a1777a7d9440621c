"""Fault-tolerance primitives: retries, heartbeats, straggler speculation.

SWIRL steps are pure dataflow steps (``In^D(s) ↦ Out^D(s)``); re-executing a
step with the same inputs yields the same outputs.  That single assumption —
the same one behind RDD lineage recovery — makes all three mechanisms here
sound:

* **retry** — transient step failures are retried up to ``max_retries``;
* **heartbeat** — a location that stops beating is declared dead and its work
  queue is eligible for re-mapping (the reference's ``workflow/elastic.py``);
* **speculation** — a step exceeding ``speculation_factor ×`` its expected
  duration is speculatively re-executed; the first result wins.
"""

from __future__ import annotations

import os
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

#: The one heartbeat deadline default, shared by :class:`HeartbeatMonitor`
#: and :class:`repro_torch.exec.policy.FaultPolicy`.  Historically ``fault.py``
#: said 5s while ``central.py`` constructed 60s; 30s is the documented
#: middle ground — long enough that a loaded CI machine never declares a
#: healthy worker dead, short enough that a genuinely wedged worker is
#: recovered within one straggler window.
DEFAULT_HEARTBEAT_TIMEOUT_S = 30.0


class TransientError(RuntimeError):
    """A step failure worth retrying (node blip, OOM-kill, preemption)."""


class PermanentError(RuntimeError):
    """A step failure that must not be retried (bad program)."""


class LocationDead(RuntimeError):
    """Raised by the heartbeat monitor when a location misses its deadline."""


@dataclass
class RetryPolicy:
    """Bounded retry with capped exponential backoff and **full jitter**.

    The sleep before retry ``n`` (0-based) is drawn uniformly from
    ``[0, min(backoff_cap_s, backoff_s * 2**n)]`` — the AWS "full jitter"
    scheme, which decorrelates a thundering herd of retriers.  ``rng`` is
    any object with ``random()``; inject a seeded ``random.Random`` for
    deterministic tests.
    """

    max_retries: int = 3
    backoff_s: float = 0.0  # tests keep this at 0
    backoff_cap_s: float = 30.0
    rng: Any = None

    def sleep_s(self, attempt: int) -> float:
        """The jittered sleep before retrying after failed ``attempt``."""
        if not self.backoff_s:
            return 0.0
        ceiling = min(self.backoff_cap_s, self.backoff_s * (2**attempt))
        return ceiling * (self.rng or random).random()

    def run(self, fn: Callable[[], Any], *, on_retry=None) -> Any:
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except PermanentError:
                raise
            except Exception as e:  # noqa: BLE001 — step code is arbitrary
                last = e
                if on_retry is not None:
                    on_retry(attempt, e)
                delay = self.sleep_s(attempt)
                if delay:
                    time.sleep(delay)
        raise TransientError(
            f"step failed after {self.max_retries + 1} attempts"
        ) from last


@dataclass
class SpeculationPolicy:
    """Speculative re-execution of stragglers (pure steps make this safe)."""

    enabled: bool = True
    factor: float = 3.0  # speculate when t > factor × expected
    min_expected_s: float = 0.01
    max_speculative: int = 1

    def run(
        self,
        fn: Callable[[], Any],
        expected_s: float | None,
        pool: ThreadPoolExecutor,
    ) -> tuple[Any, bool]:
        """Run ``fn``; launch a backup copy if the primary straggles.

        Returns ``(result, speculated)``.
        """
        if not self.enabled or expected_s is None:
            return fn(), False
        deadline = max(expected_s, self.min_expected_s) * self.factor
        futures: list[Future] = [pool.submit(fn)]
        speculated = False
        launched = 0
        while True:
            done, pending = wait(futures, timeout=deadline, return_when=FIRST_COMPLETED)
            if done:
                winner = next(iter(done))
                for p in pending:
                    p.cancel()
                return winner.result(), speculated
            if launched < self.max_speculative:
                futures.append(pool.submit(fn))
                launched += 1
                speculated = True
            # else: keep waiting on the already-launched copies


class HeartbeatMonitor:
    """Tracks per-location liveness; ``dead()`` lists expired locations."""

    def __init__(
        self,
        timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, location: str) -> None:
        with self._lock:
            self._last[location] = self._clock()

    def register(self, location: str) -> None:
        self.beat(location)

    def dead(self) -> list[str]:
        now = self._clock()
        with self._lock:
            return sorted(
                l for l, t in self._last.items() if now - t > self.timeout_s
            )

    def alive(self) -> list[str]:
        now = self._clock()
        with self._lock:
            return sorted(
                l for l, t in self._last.items() if now - t <= self.timeout_s
            )

    def check(self, location: str) -> None:
        if location in self.dead():
            raise LocationDead(location)


# ---------------------------------------------------------------------------
# Fault injection helpers for tests & benchmarks
# ---------------------------------------------------------------------------


@dataclass
class FlakyFn:
    """Wraps a step fn to fail the first ``failures`` invocations."""

    fn: Callable[[Mapping[str, Any]], Mapping[str, Any]]
    failures: int = 1
    exc: type[Exception] = TransientError
    calls: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __call__(self, inputs: Mapping[str, Any]) -> Mapping[str, Any]:
        with self._lock:
            self.calls += 1
            n = self.calls
        if n <= self.failures:
            raise self.exc(f"injected failure #{n}")
        return self.fn(inputs)


@dataclass
class SlowFn:
    """Wraps a step fn to straggle on its first ``slow_calls`` invocations."""

    fn: Callable[[Mapping[str, Any]], Mapping[str, Any]]
    delay_s: float = 0.5
    slow_calls: int = 1
    calls: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __call__(self, inputs: Mapping[str, Any]) -> Mapping[str, Any]:
        with self._lock:
            self.calls += 1
            n = self.calls
        if n <= self.slow_calls:
            time.sleep(self.delay_s)
        return self.fn(inputs)


@dataclass
class SlowOnceAcrossProcesses:
    """Straggle exactly once **fleet-wide**, surviving process respawns.

    :class:`SlowFn` counts calls in one process's memory; under the fork
    start method every respawned worker inherits ``calls == 0`` and would
    straggle again, so heartbeat-recovery scenarios never converge.  This
    variant claims a filesystem flag (``O_CREAT | O_EXCL`` — atomic across
    processes): the first caller anywhere in the fleet creates it and
    sleeps, every later caller in any process is fast.
    """

    fn: Callable[[Mapping[str, Any]], Mapping[str, Any]]
    flag_path: str
    delay_s: float = 0.5

    def __call__(self, inputs: Mapping[str, Any]) -> Mapping[str, Any]:
        try:
            os.close(os.open(self.flag_path, os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            pass
        else:
            time.sleep(self.delay_s)
        return self.fn(inputs)
