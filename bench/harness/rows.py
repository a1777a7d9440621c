"""Training rows made from a seed: the benchmark's own copy of the port's
``SyntheticLM`` arithmetic (``repro_torch.data.pipeline``), so that the
program and the reference read the same rows and neither depends on the
other.  Token ``t`` of document ``i`` is a splitmix-style hash of
``(seed, i, t)`` with a Zipf-like skew; shard ``s`` of ``S`` takes rows
``s::S`` of the global batch of a step, and every step's documents differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _mix(seed: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ (b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
    x ^= np.uint64(seed) * np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


@dataclass(frozen=True)
class Rows:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int
    zipf_s: float = 1.1

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """``{"tokens", "labels"}`` int32 ``[global_batch / n_shards, seq_len]``."""
        rows = self.global_batch // n_shards
        row_ids = shard + np.arange(rows, dtype=np.uint64) * n_shards
        doc = np.uint64(step) * np.uint64(self.global_batch) + row_ids
        t = np.arange(self.seq_len + 1, dtype=np.uint64)
        with np.errstate(over="ignore"):
            h = _mix(self.seed, doc[:, None], t[None, :])
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        tok = np.clip(np.floor(self.vocab * np.power(u, self.zipf_s)).astype(np.int32), 0, self.vocab - 1)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
