"""Data pipeline: sharded synthetic token streams with background prefetch."""

from .pipeline import ShardedLoader, SyntheticLM

__all__ = ["SyntheticLM", "ShardedLoader"]
