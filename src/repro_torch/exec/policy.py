"""The uniform fault policy accepted by every backend's ``lower()``.

One frozen :class:`FaultPolicy` names everything a backend may do about a
misbehaving step or run — retry with capped exponential backoff + full
jitter, a per-step wall-clock ``timeout_s``, speculative re-execution of
stragglers, a heartbeat deadline for declaring remote locations dead, and
a whole-run ``deadline_s`` — and is passed as a lowering option::

    exe = plan.lower(backend, policy=FaultPolicy(max_retries=2,
                                                 timeout_s=5.0)).compile(steps)

The port's ``torch`` backend honours retry and timeout around each step
fire and checks the deadline once per reduction round, as the reference's
``jax`` backend does; speculation and heartbeats have no use in its one
process.

The soundness argument is the one :mod:`repro_torch.workflow.fault` documents:
SWIRL steps are pure ``In^D(s) ↦ Out^D(s)`` functions, so re-execution
(retry, speculation, replay after a declared death) cannot corrupt data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.workflow.fault import (
    DEFAULT_HEARTBEAT_TIMEOUT_S,
    HeartbeatMonitor,
    RetryPolicy,
    SpeculationPolicy,
    TransientError,
)

__all__ = [
    "FaultPolicy",
    "RunDeadlineExceeded",
    "StepTimeoutError",
]


class StepTimeoutError(TransientError):
    """A step exceeded the policy's per-step ``timeout_s``.

    Subclasses :class:`TransientError` because a timed-out pure step is
    retryable by definition — the abandoned attempt cannot have corrupted
    anything the dataflow can observe.
    """

    def __init__(self, step: str, timeout_s: float):
        super().__init__(f"step {step!r} exceeded timeout {timeout_s}s")
        self.step = step
        self.timeout_s = timeout_s


class RunDeadlineExceeded(RuntimeError):
    """The whole run exceeded the policy's ``deadline_s``.

    Deliberately **not** transient: the deadline is the caller's patience,
    not a step fault, so no backend retries past it.  The gateway maps it
    to HTTP 504.
    """

    def __init__(self, deadline_s: float, *, elapsed_s: float | None = None):
        detail = f" (elapsed {elapsed_s:.3f}s)" if elapsed_s is not None else ""
        super().__init__(f"run exceeded deadline {deadline_s}s{detail}")
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


@dataclass(frozen=True)
class FaultPolicy:
    """Uniform per-run fault handling, backend-independent.

    Fields (all optional; the zero policy is a no-op):

    * ``max_retries`` — per-step retry budget for transient failures;
    * ``backoff_s`` / ``backoff_cap_s`` — base and cap of the capped
      exponential full-jitter backoff between retries;
    * ``timeout_s`` — per-step wall-clock limit; an overrun raises
      :class:`StepTimeoutError` (transient, so it consumes a retry);
    * ``speculation_factor`` — launch a backup copy of a step running
      longer than ``factor ×`` its expected duration (backends with a
      central pool and expected durations only);
    * ``max_speculative`` — backup copies per straggling step;
    * ``heartbeat_interval_s`` — how often liveness is (expected to be)
      reported;
    * ``heartbeat_timeout_s`` — silence after which a location/worker is
      declared dead and elastic recovery may fire;
    * ``deadline_s`` — whole-run wall-clock budget; an overrun raises
      :class:`RunDeadlineExceeded`.

    Frozen and picklable — it crosses process boundaries inside the
    multiprocess worker config verbatim.
    """

    max_retries: int = 0
    backoff_s: float = 0.0
    backoff_cap_s: float = 30.0
    timeout_s: float | None = None
    speculation_factor: float | None = None
    max_speculative: int = 1
    heartbeat_interval_s: float = 1.0
    heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S
    deadline_s: float | None = None

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_cap_s < 0:
            raise ValueError(
                f"backoff_cap_s must be >= 0, got {self.backoff_cap_s}"
            )
        for name in ("timeout_s", "speculation_factor", "deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if self.max_speculative < 1:
            raise ValueError(
                f"max_speculative must be >= 1, got {self.max_speculative}"
            )
        for name in ("heartbeat_interval_s", "heartbeat_timeout_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0, got {getattr(self, name)}")

    # -- engine constructors --------------------------------------------------
    # The inprocess runtime's existing fault primitives become the policy's
    # engine; other backends reuse the same constructors so semantics (and
    # jitter determinism under an injected rng) match everywhere.

    def retry_policy(self, rng: Any = None) -> RetryPolicy | None:
        """A :class:`RetryPolicy` for this policy, or ``None`` when inert."""
        if self.max_retries <= 0:
            return None
        return RetryPolicy(
            max_retries=self.max_retries,
            backoff_s=self.backoff_s,
            backoff_cap_s=self.backoff_cap_s,
            rng=rng,
        )

    def speculation_policy(self) -> SpeculationPolicy | None:
        if self.speculation_factor is None:
            return None
        return SpeculationPolicy(
            enabled=True,
            factor=self.speculation_factor,
            max_speculative=self.max_speculative,
        )

    def heartbeat_monitor(self) -> HeartbeatMonitor:
        return HeartbeatMonitor(timeout_s=self.heartbeat_timeout_s)

    @property
    def active(self) -> bool:
        """Whether any mechanism is switched on (the zero policy is inert)."""
        return bool(
            self.max_retries
            or self.timeout_s is not None
            or self.speculation_factor is not None
            or self.deadline_s is not None
        )
