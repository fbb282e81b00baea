"""Streaming sketches for the statistics layer (DESIGN.md §10).

Two bounded-memory sketches, both numpy only and mergeable, so the
incremental maintainer can fold insert deltas in without rescanning
base relations:

* :class:`DistinctSketch` — KMV (k-minimum-values) distinct counting
  over ``splitmix64`` hashes.  Exact while fewer than ``k`` distinct
  hashes have been seen; beyond that the classic ``(k-1)/U_(k)``
  estimator applies, with relative standard error ``~1/sqrt(k-2)``.

* :class:`HeavyHitterSketch` — Misra–Gries / SpaceSaving frequency
  counters with batched decrements.  Maintains the invariant
  ``err <= (n - sum(counters)) / (m + 1) <= n / (m + 1)`` where ``err``
  upper-bounds any key's undercount, so every key with true frequency
  above ``n/(m+1)`` is guaranteed retained, and estimates satisfy
  ``true - err <= est <= true``.

Copy of the JAX package's ``stats/sketches.py``.
"""
from __future__ import annotations

import math

import numpy as np

_U64 = np.uint64
_HASH_SPACE = 2.0**64


def splitmix64(values: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: int array -> uint64 hashes."""
    z = np.asarray(values).astype(_U64, copy=True)
    z += _U64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


class DistinctSketch:
    """KMV distinct-count sketch: the ``k`` smallest distinct hashes."""

    __slots__ = ("k", "_hashes")

    def __init__(self, k: int = 256):
        if k < 4:
            raise ValueError(f"KMV needs k >= 4, got {k}")
        self.k = k
        self._hashes = np.empty(0, dtype=_U64)

    def update(self, values: np.ndarray) -> "DistinctSketch":
        h = np.unique(splitmix64(values))
        self._hashes = np.union1d(self._hashes, h)[: self.k]
        return self

    def merge(self, other: "DistinctSketch") -> "DistinctSketch":
        if other.k != self.k:
            raise ValueError(f"cannot merge KMV k={self.k} with k={other.k}")
        out = DistinctSketch(self.k)
        out._hashes = np.union1d(self._hashes, other._hashes)[: self.k]
        return out

    @property
    def is_exact(self) -> bool:
        """Fewer than ``k`` distinct hashes seen: the count is exact."""
        return len(self._hashes) < self.k

    def estimate(self) -> float:
        n = len(self._hashes)
        if n < self.k:
            return float(n)
        kth = float(self._hashes[self.k - 1]) + 1.0  # in (0, 2^64]
        return (self.k - 1) * _HASH_SPACE / kth

    def error_bound(self) -> float:
        """Advertised relative error (~4 standard errors of the KMV
        estimator) once the sketch is past its exact regime."""
        return 4.0 / math.sqrt(self.k - 2)

    def state(self) -> tuple:
        """Canonical state, for associativity checks in tests."""
        return (self.k, self._hashes.tobytes())

    def __repr__(self) -> str:
        tag = "exact" if self.is_exact else "approx"
        return f"DistinctSketch(k={self.k}, est={self.estimate():.0f}, {tag})"


class HeavyHitterSketch:
    """Misra–Gries heavy hitters with weighted batch updates."""

    __slots__ = ("m", "counts", "n", "err")

    def __init__(self, m: int = 32):
        if m < 1:
            raise ValueError(f"Misra-Gries needs m >= 1, got {m}")
        self.m = m
        self.counts: dict[int, int] = {}
        self.n = 0  # total weight processed
        self.err = 0  # upper bound on any key's undercount

    def update(
        self, values: np.ndarray, weights: np.ndarray | None = None
    ) -> "HeavyHitterSketch":
        v = np.asarray(values).ravel()
        if len(v) == 0:
            return self
        if weights is None:
            keys, w = np.unique(v, return_counts=True)
        else:
            keys, inv = np.unique(v, return_inverse=True)
            w = np.bincount(inv.ravel(), weights=np.asarray(weights).ravel())
        for key, wt in zip(keys.tolist(), w.tolist()):
            wt = int(wt)
            if wt <= 0:
                continue
            self.n += wt
            self.counts[int(key)] = self.counts.get(int(key), 0) + wt
        self._trim()
        return self

    def _trim(self) -> None:
        if len(self.counts) <= self.m:
            return
        # batched Misra-Gries decrement: subtract the (m+1)-th largest
        # counter from everything; at least m+1 counters shed >= cut
        # total mass each round, so err accumulates at most n/(m+1)
        cut = sorted(self.counts.values(), reverse=True)[self.m]
        self.counts = {k: c - cut for k, c in self.counts.items() if c > cut}
        self.err += cut

    def merge(self, other: "HeavyHitterSketch") -> "HeavyHitterSketch":
        if other.m != self.m:
            raise ValueError(f"cannot merge MG m={self.m} with m={other.m}")
        out = HeavyHitterSketch(self.m)
        out.n = self.n + other.n
        out.err = self.err + other.err
        out.counts = dict(self.counts)
        for k, c in other.counts.items():
            out.counts[k] = out.counts.get(k, 0) + c
        out._trim()
        return out

    def estimate(self, key: int) -> int:
        """Estimated frequency; ``true - err <= estimate <= true``."""
        return self.counts.get(int(key), 0)

    def share(self, key: int) -> float:
        return self.estimate(key) / self.n if self.n else 0.0

    def top(self, j: int) -> list[tuple[int, int]]:
        """``j`` highest-estimate ``(key, count)`` pairs, deterministic."""
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))[:j]

    def heavy(self, min_share: float) -> list[tuple[int, float]]:
        """Keys with estimated share >= ``min_share``, heaviest first.

        Guaranteed to include every key whose *true* share exceeds
        ``min_share + err/n`` (the Misra-Gries undercount bound)."""
        if not self.n:
            return []
        out = [
            (k, c / self.n)
            for k, c in self.counts.items()
            if c / self.n >= min_share
        ]
        return sorted(out, key=lambda kv: (-kv[1], kv[0]))

    def max_share(self) -> float:
        if not self.counts or not self.n:
            return 0.0
        return max(self.counts.values()) / self.n

    def __repr__(self) -> str:
        return (
            f"HeavyHitterSketch(m={self.m}, n={self.n}, "
            f"tracked={len(self.counts)}, err<={self.err})"
        )
