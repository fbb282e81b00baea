"""Deterministic, resumable, elastic data pipeline.

Batches are a pure function of ``(global_step, shard_index, num_shards)``
— there is no mutable iterator state to checkpoint, restarts resume from
the step counter alone, and changing the host count (elastic scaling)
re-partitions the same global batch stream with no data loss or dupes.

Sources: a synthetic LM corpus (seeded PRNG token stream) or a memory-
mapped token file (``np.memmap``) sliced by step.

A copy of the JAX package's ``train/pipeline.py`` (numpy only): the port
draws the same batches bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: str | None = None


class DataPipeline:
    def __init__(self, cfg: PipelineConfig, shard_index: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0, "batch must split across hosts"
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._tokens = (
            np.memmap(cfg.token_file, dtype=np.int32, mode="r")
            if cfg.token_file else None
        )

    def global_batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        if self._tokens is not None:
            span = cfg.global_batch * (cfg.seq_len + 1)
            start = (step * span) % max(len(self._tokens) - span, 1)
            flat = np.asarray(self._tokens[start : start + span])
            return flat.reshape(cfg.global_batch, cfg.seq_len + 1)
        rng = np.random.default_rng((cfg.seed, step))
        return rng.integers(
            0, cfg.vocab, (cfg.global_batch, cfg.seq_len + 1), dtype=np.int32
        )

    def local_batch_at(self, step: int) -> dict[str, np.ndarray]:
        full = self.global_batch_at(step)
        lo = self.shard_index * self.local_batch
        mine = full[lo : lo + self.local_batch]
        return {"tokens": mine[:, :-1], "labels": mine[:, 1:]}

    def reshard(self, shard_index: int, num_shards: int) -> "DataPipeline":
        """Elastic re-partition (same stream, new host count)."""
        return DataPipeline(self.cfg, shard_index, num_shards)
