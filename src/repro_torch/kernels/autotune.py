"""Per-device tuning of the fused hop's launch shape (DESIGN.md §13).

The port of the JAX package's ``kernels/autotune.py``.  There the fused
megakernel's TPU tiles (edge, segment and gather tile) are picked per
device; here ``csrc/fused_hop.cu``'s launch shape is: for the slab-major
warp walk of one-child hops (``csrc/gathered_rows.cuh``) the column slab,
rows and warps a block, edges in flight and block order; for the
sorted-run tile walk of the others (``csrc/segmented_rows.cuh``) rows a
tile and column slabs.  No shape changes a bit of the answer: each output
element is folded by one lane over its row's edges in grouped-CSR order
whatever the shape, so the shape only decides who folds it.

* **Model ranking.**  :func:`candidates` lists the fixed plan
  (``ops.gather_plan``/``ops.walk_plan``, the fastest of
  ``tools/walk_sweep.py``'s grid at the main path's shapes) and that
  grid; :func:`candidate_plans` ranks them by
  :func:`repro_torch.launch.roofline.fused_hop_cost`.  Plans modelled
  within :data:`MODEL_TOLERANCE` of the fastest count as tied with it,
  and the fixed plan leads a tie; the rest order by modelled seconds,
  then by :meth:`HopPlan.key`.  The ranking is deterministic, so
  ``Plan.explain()`` and the verifier read it
  (:func:`model_plan_for`) and never the cache.
* **Measurement, on the card only.**  On a miss :func:`plan_for` times
  the top :data:`MEASURE_TOP_N` candidates, and the fixed plan where the
  model ranks it lower (so tuning never loses to it), on the launch's own operands
  (a ``run`` callable that launches one plan into the hop's output):
  one warm-up launch each, then the least of :data:`TIMED_LAUNCHES`
  launches between CUDA events on the current stream, one host sync in
  all; the fastest wins (ties by key) and is launched last, so its
  output stands.  A hit never syncs.  On the CPU the plain version runs,
  so nothing is timed and the model's pick is the plan.
* **Cache.**  Winners are kept per card and bucketed hop shape
  (:func:`hop_shape`) in memory, one lock a key so concurrent first
  launches of a shape measure once, and in a flat JSON file
  (``REPRO_TORCH_AUTOTUNE_CACHE``, by default
  ``~/.cache/repro_torch/autotune.json``) keyed by ``<card name>|<source
  digest of the fused_hop build>|<shape key>``: a rebuilt kernel is tuned
  afresh, and deleting the file retunes.  The file is written atomically
  and read and written best-effort.  An entry the kernel cannot take at
  the launch's shape (``ops.make_*_plan`` raises) is dropped and tuned
  again; it never reaches a launch.
"""
from __future__ import annotations

import functools
import json
import math
import os
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_hop import gathers_one_child
from repro_torch.launch import roofline

__all__ = [
    "HopPlan",
    "HopShape",
    "MEASURE_TOP_N",
    "cached_plan_for",
    "candidate_plans",
    "candidates",
    "fixed_plan",
    "hop_shape",
    "model_plan_for",
    "plan_for",
    "reset_cache",
    "stats",
]

#: how many model-ranked candidates a miss measures on the card
MEASURE_TOP_N = 3
#: timed launches per measured candidate, after one warm-up launch
TIMED_LAUNCHES = 3
#: plans modelled within this share of the fastest are tied with it:
#: the model's fitted constants do not separate them (launch/roofline.py)
MODEL_TOLERANCE = 0.05
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

# the grid (tools/walk_sweep.py times the same): warp walk ... (4 and 8
# rows a block let a few-row hop spread its rows over more warps)
GATHER_SLABS = (32, 64, 128, 256)
GATHER_TILE_ROWS = (4, 8, 16, 32, 64)
GATHER_FEWER_WARPS = (1, 2)
# ... and tile walk: floats a narrow tile, rows and slabs of the row walk
NARROW_TILE_ELEMS = (4096, 8192, 16384, 32768)
WIDE_TILE_ROWS = (1, 2, 4)
WIDE_SLABS = (1, 2, 3, 5, 9)


@dataclass(frozen=True)
class HopShape:
    """Bucketed shape of one fused hop: the cache key."""

    edges: int
    child_rows: tuple[int, ...]
    child_widths: tuple[int, ...]
    num_segments: int
    k: int = 1
    kind: str = "sum"
    walk: str = "tile"  # "gather": csrc/gathered_rows.cuh; "tile": segmented_rows.cuh

    @property
    def width(self) -> int:
        return math.prod(self.child_widths)

    @property
    def d(self) -> int:
        """Floats of one output row."""
        return self.width * self.k

    def dims(self) -> tuple[int, int, int]:
        """``(edges, num_rows, d)`` of a launch of this bucketed shape."""
        return min(self.edges, ops.MAX_EDGES), self.num_segments or 8, self.d

    def key(self) -> str:
        rows = ",".join(str(r) for r in self.child_rows) or "-"
        widths = ",".join(str(w) for w in self.child_widths) or "-"
        return (
            f"fused_hop|e{self.edges}|r{rows}|w{widths}"
            f"|s{self.num_segments}|k{self.k}|{self.kind}|{self.walk}"
        )


def _bucket(n: int, floor: int = 8) -> int:  # tile-math
    """Round up to the next power of two (>= floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def hop_shape(
    edges: int,
    child_rows: tuple[int, ...],
    width: int = 1,
    k: int = 1,
    kind: str = "sum",
    child_widths: tuple[int, ...] | None = None,
    num_segments: int = 0,
) -> HopShape:
    """Bucket a concrete hop into its shape class: edges, child rows and
    segments to powers of two (at least 256, 8 and 8), as the reference;
    widths, ``k`` and ``kind`` as they are, and the walk the hop takes."""
    if child_widths is None:
        child_widths = ((width,) + (1,) * (len(child_rows) - 1))[: len(child_rows)]
    child_widths = tuple(int(w) for w in child_widths)
    d = math.prod(child_widths) * int(k)
    return HopShape(
        edges=_bucket(edges, 256),
        child_rows=tuple(_bucket(r, 8) for r in child_rows),
        child_widths=child_widths,
        num_segments=_bucket(num_segments, 8) if num_segments else 0,
        k=int(k),
        kind=kind,
        walk="gather" if gathers_one_child(len(child_rows), d) else "tile",
    )


@dataclass(frozen=True)
class HopPlan:
    """The parameters of one launch shape, independent of the launch's
    sizes: :meth:`make` turns them into the ``ops`` plan for one launch
    (and raises where the kernel cannot take them)."""

    walk: str
    rows: int  # gather: rows a block; tile: rows a tile
    slab: int = 0  # gather: columns a slab
    warps: int = 0  # gather: warps a block
    in_flight: int = 0  # gather: edges whose gathers a lane starts at once
    slab_major: bool = False  # gather: blocks walk slab by slab
    slabs: int = 0  # tile: column slabs a row

    def key(self) -> str:
        """The plan's name, numbers zero-padded so that names sort as
        numbers: among plans the model ties, smaller tiles (more warps at
        work) come first."""
        if self.walk == "gather":
            order = "sm" if self.slab_major else "tm"
            return (f"gather.s{self.slab:04d}.r{self.rows:04d}.w{self.warps}"
                    f".u{self.in_flight}.{order}")
        return f"tile.r{self.rows:05d}.x{self.slabs:02d}"

    def make(self, n: int, num_rows: int, d: int):
        if self.walk == "gather":
            return ops.make_gather_plan(n, num_rows, d, self.slab, self.rows, self.warps,
                                        self.in_flight, self.slab_major)
        if self.walk == "tile":
            return ops.make_walk_plan(n, num_rows, d, self.rows, self.slabs)
        raise ValueError(f"unknown walk {self.walk!r}")

    def fields(self) -> dict:
        return {"walk": self.walk, "rows": self.rows, "slab": self.slab,
                "warps": self.warps, "in_flight": self.in_flight,
                "slab_major": self.slab_major, "slabs": self.slabs}

    @classmethod
    def from_fields(cls, raw) -> HopPlan:
        """A plan from :meth:`fields`; raises ``ValueError`` on anything else."""
        try:
            ints = {f: raw[f] for f in ("rows", "slab", "warps", "in_flight", "slabs")}
            if raw["walk"] not in ("gather", "tile") or not isinstance(raw["slab_major"], bool):
                raise ValueError(f"not a plan: {raw!r}")
            if not all(type(v) is int for v in ints.values()):
                raise ValueError(f"not a plan: {raw!r}")
            return cls(walk=raw["walk"], slab_major=raw["slab_major"], **ints)
        except (KeyError, TypeError) as e:
            raise ValueError(f"not a plan: {raw!r}") from e


# ----------------------------------------------------------------------
# candidates and their model ranking
# ----------------------------------------------------------------------


def fixed_plan(shape: HopShape, num_rows: int | None = None) -> HopPlan:  # tile-math
    """Today's fixed choice for ``shape``'s walk: ``ops.gather_plan``'s
    (for ``num_rows`` output rows, by default the shape's) or
    ``ops.walk_plan``'s parameters."""
    d = shape.d
    if shape.walk == "gather":
        rows = ops.gather_rows(num_rows or shape.dims()[1], d)
        return HopPlan("gather", rows, ops.GATHER_SLAB, ops.GATHER_WARPS,
                       ops.GATHER_IN_FLIGHT, True)
    rows, slabs = ops.walk_tile(d)
    return HopPlan("tile", rows, slabs=slabs)


def _grid(shape: HopShape) -> list[HopPlan]:  # tile-math
    d = shape.d
    if shape.walk == "gather":
        grid = [
            HopPlan("gather", rows, slab, ops.GATHER_WARPS, in_flight, True)
            for slab in GATHER_SLABS
            for in_flight in ops.GATHER_IN_FLIGHT_CHOICES
            for rows in GATHER_TILE_ROWS
        ]
        grid += [
            HopPlan("gather", ops.GATHER_ROWS, slab, ops.GATHER_WARPS, ops.GATHER_IN_FLIGHT, False)
            for slab in GATHER_SLABS
        ]
        return grid + [
            HopPlan("gather", ops.GATHER_ROWS, ops.GATHER_SLAB, warps, ops.GATHER_IN_FLIGHT, True)
            for warps in GATHER_FEWER_WARPS
        ]
    rows, slabs = ops.walk_tile(d)
    if d < ops.NARROW_WIDTH:
        return [HopPlan("tile", max(1, elems // d), slabs=1)  # lint-ok: tile-floordiv (whole rows a tile)
                for elems in NARROW_TILE_ELEMS]
    return [
        HopPlan("tile", r, slabs=s)
        for r in sorted(set(WIDE_TILE_ROWS) | {rows})
        for s in sorted(set(WIDE_SLABS) | {slabs})
    ]


def _makes(plan: HopPlan, dims: tuple[int, int, int]):
    """``plan`` made for a launch of ``dims``, or None where the kernel
    cannot take it."""
    try:
        made = plan.make(*dims)
    except ValueError:
        return None
    return made if roofline.fused_hop_admissible(made) else None


@functools.lru_cache(maxsize=4096)
def candidates(shape: HopShape) -> tuple[HopPlan, ...]:
    """The fixed plan, then ``tools/walk_sweep.py``'s grid for the
    shape's walk, each once (by the launch plan it makes at the bucketed
    shape), without those the kernel cannot take there."""
    dims = shape.dims()
    out, seen = [], set()
    for plan in [fixed_plan(shape)] + _grid(shape):
        made = _makes(plan, dims)
        if made is not None and bytes(made) not in seen:
            seen.add(bytes(made))
            out.append(plan)
    return tuple(out)


def model_seconds(shape: HopShape, plan: HopPlan, dims: tuple[int, int, int] | None = None) -> float:
    """Modelled seconds of ``plan`` at ``dims`` (by default the bucketed
    shape's), gathering from children of the shape's bucketed rows."""
    n, num_rows, d = dims or shape.dims()
    return roofline.fused_hop_cost(
        n, shape.child_rows, shape.child_widths, num_rows, shape.k, plan.make(n, num_rows, d)
    )["seconds"]


@functools.lru_cache(maxsize=4096)
def candidate_plans(shape: HopShape) -> tuple[tuple[float, HopPlan], ...]:
    """Every candidate with its modelled seconds, best first: those within
    :data:`MODEL_TOLERANCE` of the fastest lead (the fixed plan first
    among them), then by seconds, then by key."""
    scored = [(model_seconds(shape, p), p) for p in candidates(shape)]
    if not scored:
        return ()
    band = min(s for s, _ in scored) * (1 + MODEL_TOLERANCE)
    fixed = fixed_plan(shape)

    def rank(t):
        tied = t[0] <= band
        return not tied, tied and t[1] != fixed, t[0], t[1].key()

    return tuple(sorted(scored, key=rank))


def model_plan_for(shape: HopShape, dims: tuple[int, int, int] | None = None) -> HopPlan:
    """The model's pick that the launch of ``dims`` (by default the
    bucketed shape's) can take: what ``Plan.explain()`` and the verifier
    show, on every machine.  Never reads the cache."""
    dims = dims or shape.dims()
    for _, plan in candidate_plans(shape):
        if _makes(plan, dims) is not None:
            return plan
    return fixed_plan(shape, dims[1])


# ----------------------------------------------------------------------
# cache and measurement
# ----------------------------------------------------------------------

_lock = threading.Lock()
_memory: dict[str, HopPlan] = {}  # guarded-by: _lock
_key_locks: dict[str, threading.Lock] = {}  # guarded-by: _lock
_disk_loaded = False  # guarded-by: _lock
_stats = {"measurements": 0, "timing_launches": 0, "dropped": 0}  # guarded-by: _lock
_log: dict[str, dict] = {}  # guarded-by: _lock


def cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


def _card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


def cache_key(shape: HopShape, device: torch.device) -> str:
    return f"{_card_name(device)}|{ops.source_digest('fused_hop')}|{shape.key()}"


def _read_disk() -> dict:
    try:
        raw = json.loads(cache_path().read_text())
    except (OSError, ValueError):
        return {}
    return raw if isinstance(raw, dict) else {}


def _load_disk() -> None:  # guarded-by: _lock
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    for key, raw in _read_disk().items():
        try:
            _memory.setdefault(key, HopPlan.from_fields(raw))
        except ValueError:
            _stats["dropped"] += 1


def _store_disk() -> None:  # guarded-by: _lock
    """Merge the memory cache into the file, atomically; best-effort."""
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        merged = _read_disk()
        merged.update({key: plan.fields() for key, plan in _memory.items()})
        fd, tmp = tempfile.mkstemp(prefix=path.name, suffix=".tmp", dir=path.parent)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError:  # the cache is best-effort; never fail the query
        pass


def _lookup(shape: HopShape, key: str, dims: tuple[int, int, int]) -> HopPlan | None:
    """The cached plan for ``key`` if the launch of ``dims`` can take it;
    an entry it cannot take is dropped."""
    with _lock:
        _load_disk()
        plan = _memory.get(key)
        if plan is None:
            return None
        if plan.walk == shape.walk and _makes(plan, dims) is not None:
            return plan
        del _memory[key]
        _stats["dropped"] += 1
        return None


def _key_lock(key: str) -> threading.Lock:
    with _lock:
        return _key_locks.setdefault(key, threading.Lock())


def _time_candidates(run, plans: list[HopPlan], device: torch.device) -> list[float]:
    """ms of each plan's fastest of :data:`TIMED_LAUNCHES` launches after
    a warm-up, between CUDA events on the current stream; one host sync."""
    events = []
    stream = torch.cuda.current_stream(device)
    for plan in plans:
        run(plan)
        pairs = []
        for _ in range(TIMED_LAUNCHES):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            run(plan)
            stop.record(stream)
            pairs.append((start, stop))
        events.append(pairs)
    events[-1][-1][1].synchronize()
    return [min(a.elapsed_time(b) for a, b in pairs) for pairs in events]


def cached_plan_for(shape: HopShape, device, dims: tuple[int, int, int] | None = None) -> HopPlan | None:
    """The plan the cache holds for ``shape`` on ``device``'s card, if the
    launch of ``dims`` can take it; measures nothing."""
    return _lookup(shape, cache_key(shape, torch.device(device)), dims or shape.dims())


def plan_for(shape: HopShape, device, run=None, dims: tuple[int, int, int] | None = None) -> HopPlan:
    """The launch shape for one fused hop of ``shape`` whose launch has
    ``dims`` (by default the bucketed shape's) on ``device``.

    On a CUDA device with ``run`` (``run(plan)`` launches the hop with
    ``plan`` into its output buffer): the cached plan, or on a miss the
    fastest measured of the top :data:`MEASURE_TOP_N` candidates and the
    fixed plan, whose launch by ``run`` is the last, so the output holds
    its result (a caller that saw ``run`` called need not launch again).
    Otherwise the model's pick, timing nothing."""
    dims = dims or shape.dims()
    device = torch.device(device)
    if device.type != "cuda" or run is None:
        return model_plan_for(shape, dims)
    key = cache_key(shape, device)
    hit = _lookup(shape, key, dims)
    if hit is not None:
        return hit
    with _key_lock(key):
        hit = _lookup(shape, key, dims)
        if hit is not None:
            return hit
        ranked = [p for _, p in candidate_plans(shape) if _makes(p, dims) is not None]
        ranked = ranked[:MEASURE_TOP_N]
        fixed = fixed_plan(shape, dims[1])
        if fixed not in ranked:  # so that tuning never loses to the fixed plan
            ranked.append(fixed)
        ms = _time_candidates(run, ranked, device)
        winner = min(zip(ms, ranked), key=lambda t: (t[0], t[1].key()))[1]
        run(winner)
        with _lock:
            _memory[key] = winner
            _stats["measurements"] += 1
            _stats["timing_launches"] += len(ranked) * (1 + TIMED_LAUNCHES)
            _log[key] = {
                "shape": shape, "dims": dims, "winner": winner,
                "model": model_plan_for(shape, dims),
                "fixed": fixed_plan(shape, dims[1]),
                "measured": [(p, t) for p, t in zip(ranked, ms)],
            }
            _store_disk()
    return winner


def stats() -> dict:
    """Counts since the process started: ``measurements`` (misses timed
    on the card), ``timing_launches`` (their launches besides each
    winner's last one) and ``dropped`` (cache entries refused)."""
    with _lock:
        return dict(_stats)


def measurement_log() -> dict[str, dict]:
    """Per measured cache key: the bucketed ``shape``, the launch's
    ``dims``, each ``measured`` ``(plan, ms)``, the ``winner``, the
    ``model`` pick and the ``fixed`` plan."""
    with _lock:
        return dict(_log)


def reset_cache() -> None:
    """Drop the memory cache and read the file again at the next lookup."""
    global _disk_loaded
    with _lock:
        _memory.clear()
        _disk_loaded = False
