"""Fault-tolerance machinery for long training runs.

Port of the JAX package's ``train/fault_tolerance.py``:

* :class:`StragglerMonitor` -- per-step wall-time tracking with outlier
  detection;
* :class:`PreemptionHandler` -- a SIGTERM watcher; the train loop polls
  ``should_stop`` and checkpoints before it exits;
* :func:`run_with_retries` -- a retry wrapper for transient failures;
* :func:`elastic_reshard` -- a restored state put onto a new mesh
  (``launch/mesh.py``): each rank keeps its block of every leaf.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.5):
        self.window = window
        self.threshold = threshold
        self.durations: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step was a straggler: more than
        ``threshold`` times the median of the last ``window`` steps (once
        there are 8)."""
        hist = self.durations[-self.window:]
        self.durations.append(seconds)
        if len(hist) >= 8:
            med = statistics.median(hist)
            if seconds > self.threshold * med:
                self.flagged.append((step, seconds))
                return True
        return False

    def summary(self) -> dict:
        if not self.durations:
            return {"steps": 0}
        return {
            "steps": len(self.durations),
            "median_s": statistics.median(self.durations),
            "stragglers": len(self.flagged),
        }


class PreemptionHandler:
    """Installs signal handlers; ``should_stop`` flips on SIGTERM.
    ``restore()`` puts the previous handlers back."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self.should_stop = True

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)


def run_with_retries(fn: Callable, retries: int = 3, backoff: float = 0.5):
    """Call ``fn()``; on an exception retry with exponential backoff, and
    raise the last exception after ``retries`` retries."""
    err: Exception | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- transient failures of any kind
            err = e
            if attempt == retries:
                break
            time.sleep(backoff * (2**attempt))
    raise err


def elastic_reshard(tree, mesh, spec_fn):
    """``tree`` (nested dicts, lists and tuples of whole leaves, tensors or
    numpy arrays) with each leaf replaced by this rank's block
    (``launch/sharding.py:shard_of``) under ``spec_fn(path, leaf)``, a
    tensor on the mesh's device; ``path`` is the tuple of keys and indices
    that leads to the leaf.  Used after restoring a checkpoint on another
    mesh (grow or shrink between restarts)."""
    from repro_torch.launch.sharding import shard_of
    from repro_torch.train.checkpoint import _flatten, _unflatten

    out = [shard_of(leaf, spec_fn(path, leaf), mesh).to(mesh.device)
           for path, leaf in _flatten(tree)]
    return _unflatten(tree, iter(out))
