"""Deterministic sharded token pipeline (the port's copy of ``repro.data.pipeline``).

numpy, copied verbatim so that the two packages draw equal batches;
``make_batch_specs`` gives the dry-run's stand-ins as meta tensors.

``SyntheticLM`` generates a reproducible pseudo-corpus: token ``t`` of
document ``i`` is a hash-mix of ``(seed, i, t)`` with a Zipf-ish skew, so the
stream is (a) deterministic per (seed, step, shard) — restart-safe without
saving cursor state beyond the step counter — and (b) *shardable by
construction*: shard ``s`` of ``S`` reads rows ``s::S`` of the global batch,
matching the SWIRL ``shard_<i>`` steps of the training workflow.

``ShardedLoader`` adds a background prefetch thread (double buffering): the
host assembles step ``n+1`` while the device chews on step ``n``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


def _mix(seed: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """64-bit splitmix-style hash of (seed, a, b) — vectorised."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ (
        b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
    )
    x ^= np.uint64(seed) * np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.1  # skew: token = floor(V · u^s) biases small ids

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Return this shard's slice of the global batch for ``step``."""
        assert self.global_batch % n_shards == 0
        rows_per_shard = self.global_batch // n_shards
        row_ids = shard + np.arange(rows_per_shard, dtype=np.uint64) * n_shards
        doc = np.uint64(step) * np.uint64(self.global_batch) + row_ids
        t = np.arange(self.seq_len + 1, dtype=np.uint64)
        h = _mix(self.seed, doc[:, None], t[None, :])
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        tok = np.floor(self.vocab * np.power(u, self.zipf_s)).astype(np.int32)
        tok = np.clip(tok, 0, self.vocab - 1)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class ShardedLoader:
    """Background-prefetching iterator over SyntheticLM steps."""

    def __init__(
        self,
        dataset: SyntheticLM,
        *,
        shard: int = 0,
        n_shards: int = 1,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.dataset.batch(step, self.shard, self.n_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get(timeout=30.0)

    def close(self) -> None:
        self._stop.set()


def make_batch_specs(vocab: int, seq_len: int, global_batch: int) -> dict:
    """Meta int32 tensors for one training batch (dry-run input stand-ins)."""
    import torch

    shape = (global_batch, seq_len)
    return {
        "tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
        "labels": torch.empty(shape, dtype=torch.int32, device="meta"),
    }
