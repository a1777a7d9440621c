"""Distributed workflow runtime for SWIRL systems, copied from ``repro.workflow``.

* :mod:`~repro_torch.workflow.runtime`  — reduction-driven, checkpointable
  executor with retry / speculation / heartbeats (execution *is* SWIRL
  reduction); the run records of the ``inprocess`` backend's engine.
* :mod:`~repro_torch.workflow.threaded` — decentralised per-location threads
  interpreting the execution IR (:class:`ThreadedProgramRuntime`, the
  generated-program execution model of paper §5; the tree-walking
  ``ThreadedRuntime`` is kept as a deprecated reference oracle).
* :mod:`~repro_torch.workflow.channels` — in-process channels with fault
  injection.
* :mod:`~repro_torch.workflow.transport` — pluggable COMM transports
  (in-memory queues, ack-based sockets, shared memory) under the threaded
  backend.
* :mod:`~repro_torch.workflow.fault`    — retry/speculation/heartbeat policies.
* :mod:`~repro_torch.workflow.elastic`  — location renaming, recovery, rebalance.
"""

from .channels import Channel, ChannelClosed, ChannelRegistry
from .transport import (
    AckTimeout,
    InMemoryTransport,
    SocketTransport,
    Transport,
    get_transport,
    register_transport,
    socket_addresses,
)
from .fault import (
    DEFAULT_HEARTBEAT_TIMEOUT_S,
    FlakyFn,
    HeartbeatMonitor,
    LocationDead,
    PermanentError,
    RetryPolicy,
    SlowFn,
    SlowOnceAcrossProcesses,
    SpeculationPolicy,
    TransientError,
)
from .runtime import Checkpoint, Runtime, RunStats, WorkflowDeadlock
from .threaded import ThreadedProgramRuntime, ThreadedRuntime
from .elastic import (
    fold_payloads,
    plan_recovery,
    rebalance,
    recover_checkpoint,
    rename_locations,
)

__all__ = [
    "AckTimeout",
    "Channel",
    "ChannelClosed",
    "ChannelRegistry",
    "DEFAULT_HEARTBEAT_TIMEOUT_S",
    "Transport",
    "InMemoryTransport",
    "SocketTransport",
    "register_transport",
    "get_transport",
    "socket_addresses",
    "Runtime",
    "RunStats",
    "Checkpoint",
    "WorkflowDeadlock",
    "ThreadedRuntime",
    "ThreadedProgramRuntime",
    "RetryPolicy",
    "SpeculationPolicy",
    "HeartbeatMonitor",
    "TransientError",
    "PermanentError",
    "LocationDead",
    "FlakyFn",
    "SlowFn",
    "SlowOnceAcrossProcesses",
    "rename_locations",
    "fold_payloads",
    "recover_checkpoint",
    "plan_recovery",
    "rebalance",
]
