"""Kernel build, launch counters and the device dispatch rule.

* **Build.**  Every ``csrc/*.cu`` compiles with ``nvcc`` into its own
  shared library with a plain C interface under
  ``build/repro_torch_kernels/`` (one ``nvcc`` per source, all started
  together), at first use, and is loaded with ``ctypes``.  A library's
  file name carries a digest of its sources and flags, so a build is
  reused until a source changes.
* **Dispatch.**  A wrapper given CPU tensors runs the kernel's plain
  version (``ref.py``); given CUDA tensors it launches the kernel or
  raises — nothing falls back.  Inputs are checked for device, dtype,
  shape and contiguity only: properties that need a pass over the data
  (sorted ids) are preconditions that the callers establish once, when a
  grouped-CSR view is built, and are never checked per launch.
* **Launch counters.**  One integer per kernel, bumped by its wrapper
  right after a successful launch and nowhere else, so a run can show
  which kernels its main path went through.  They are the module's only
  mutable state besides the per-process memo of built, loaded libraries.
* **Walk plans.**  :func:`walk_plan` is the launch shape of the
  sorted-run tile walk (``csrc/segmented_rows.cuh``) of ``segment_sum``,
  ``segment_reduce`` and the ``fused_hop`` hops that do not gather one
  child row per edge; :func:`gather_plan` that of the slab-major warp walk
  (``csrc/gathered_rows.cuh``) of ``coo_spmm`` and the one-child
  ``fused_hop`` hops of width >= 32.  Both come from ``(n, num_rows, d)``
  alone; the wrappers pass them to the C entry points.
  :func:`matmul_plan` is the launch shape of ``semiring_matmul``'s
  register-tiled loop (block tile, stage depth, access width).
* **Fused-path switch.**  :func:`fused_enabled` resolves ``Q.fused`` and
  the ``REPRO_FUSED`` environment variable, as the JAX package's
  ``kernels/ops.py:fused_enabled`` does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

KERNELS = ("segment_sum", "coo_spmm", "segment_reduce", "fused_hop", "semiring_matmul")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_launches_lock = threading.Lock()
_launches = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    with _launches_lock:
        _launches[name] += 1


def launch_counts() -> dict[str, int]:
    with _launches_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launches_lock:
        for name in _launches:
            _launches[name] = 0


# ----------------------------------------------------------------------
# launch shape of the sorted-run tile walk
# ----------------------------------------------------------------------

WALK_THREADS = 256  # csrc/segmented_rows.cuh:kThreads
NARROW_WIDTH = 32  # rows narrower than a warp take the narrow (flat) walk
NARROW_TILE_ELEMS = 16384  # output floats of one narrow tile, at most
WIDE_TILE_ELEMS = 2048  # output floats of one row-walk block
MAX_SLAB = 1024  # columns of one row-walk slab, at most
SMEM_LIMIT = 49152  # dynamic shared memory a block gets without opting in
MAX_BLOCKS = 2**31 - 1  # blocks of one launch
MAX_EDGES = 2**31 - 1  # run bounds are 32-bit offsets


class WalkPlan(ctypes.Structure):
    """``ReproWalkPlan`` of ``csrc/segmented_rows.cuh``: tiles of
    ``rows_per_tile`` consecutive output rows, each row cut into ``slabs``
    column slabs of ``slab`` columns (the last one shorter); block ``b``
    walks slab ``b mod slabs`` of tile ``b div slabs``."""

    _fields_ = [
        ("rows_per_tile", ctypes.c_int64),
        ("slab", ctypes.c_int64),
        ("slabs", ctypes.c_int64),
        ("blocks", ctypes.c_int64),
        ("smem_bytes", ctypes.c_int64),
        ("narrow", ctypes.c_int32),
    ]

    def __repr__(self) -> str:
        return "WalkPlan(" + ", ".join(
            f"{name}={getattr(self, name)}" for name, _ in self._fields_
        ) + ")"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def walk_plan(n: int, num_rows: int, d: int) -> WalkPlan:
    """Launch shape of the sorted-run walk for ``n`` edges into a
    ``(num_rows, d)`` output, both at least 1 wide.

    Rows narrower than a warp (the leaf hops: d = k channels) take the
    narrow walk: tiles of up to :data:`NARROW_TILE_ELEMS` output floats,
    one contiguous span filled with 16-byte vectors.  Wider rows take the row walk: each row is cut
    into column slabs of at most :data:`MAX_SLAB` columns (a multiple of
    4, so vectors never straddle slabs) over as many blocks, with enough
    rows per tile for about :data:`WIDE_TILE_ELEMS` output floats per
    block and two int32 of shared memory per row.  One block per tile
    and slab; the tile sizes are the fastest of ``tools/walk_sweep.py``'s
    candidates on an H100."""
    if n > MAX_EDGES:
        raise ValueError(f"the sorted-run walk takes at most {MAX_EDGES} edges, got {n}")
    if num_rows < 1 or d < 1:
        raise ValueError(f"walk_plan needs num_rows >= 1 and d >= 1, got {num_rows}, {d}")
    narrow = d < NARROW_WIDTH
    if narrow:
        slab, slabs = d, 1
        rows = max(1, NARROW_TILE_ELEMS // d)
    else:
        slabs = _ceil_div(d, MAX_SLAB)
        slab = d if slabs == 1 else 4 * _ceil_div(d, 4 * slabs)
        slabs = _ceil_div(d, slab)
        rows = max(1, WIDE_TILE_ELEMS // slab)
    rows = min(rows, num_rows)
    blocks = _ceil_div(num_rows, rows) * slabs
    if blocks > MAX_BLOCKS:
        raise ValueError(f"a ({num_rows}, {d}) output needs {blocks} blocks, more than one launch has")
    smem = 0 if narrow else 8 * rows  # the row walk's run bounds
    return WalkPlan(rows, slab, slabs, blocks, smem, int(narrow))


# ----------------------------------------------------------------------
# launch shape of the slab-major warp walk
# ----------------------------------------------------------------------

GATHER_SLAB = 128  # W: output columns per slab
GATHER_ROWS = 16  # output rows per block
GATHER_WARPS = 4  # warps per block, each walking rows of the tile in turn
GATHER_IN_FLIGHT = 1  # edges whose gathers a lane starts before it folds them
GATHER_MAX_ROWS = 1024  # csrc/gathered_rows.cuh:kGatherMaxRows
GATHER_MAX_WARPS = 4  # csrc/gathered_rows.cuh:kGatherMaxWarps
GATHER_IN_FLIGHT_CHOICES = (1, 4, 8)  # the kernel's instantiations


class GatherPlan(ctypes.Structure):
    """``ReproGatherPlan`` of ``csrc/gathered_rows.cuh``: the output's
    columns cut into ``slabs`` slabs of ``slab`` columns (the last one
    shorter), its rows into ``tiles`` tiles of ``rows_per_block`` rows, one
    block of ``warps`` warps per (tile, slab), each warp walking rows of
    the tile in turn; with ``slab_major`` block ``b`` walks slab ``b div
    tiles`` of tile ``b mod tiles``, else slab ``b mod slabs`` of tile
    ``b div slabs``."""

    _fields_ = [
        ("slab", ctypes.c_int64),
        ("slabs", ctypes.c_int64),
        ("rows_per_block", ctypes.c_int64),
        ("tiles", ctypes.c_int64),
        ("blocks", ctypes.c_int64),
        ("smem_bytes", ctypes.c_int64),
        ("slab_major", ctypes.c_int32),
        ("in_flight", ctypes.c_int32),
        ("warps", ctypes.c_int32),
    ]

    def __repr__(self) -> str:
        return "GatherPlan(" + ", ".join(
            f"{name}={getattr(self, name)}" for name, _ in self._fields_
        ) + ")"


def make_gather_plan(
    n: int,
    num_rows: int,
    d: int,
    slab: int = GATHER_SLAB,
    rows: int = GATHER_ROWS,
    warps: int = GATHER_WARPS,
    in_flight: int = GATHER_IN_FLIGHT,
    slab_major: bool = True,
) -> GatherPlan:
    """A slab-major warp walk plan for ``n`` edges into a ``(num_rows,
    d)`` output with the given slab width (a multiple of 32; rows narrower
    than it take one slab of ``d`` rounded up to 32), rows and warps per
    block and edges in flight; raises on what the kernel cannot take.
    ``tools/walk_sweep.py`` times such candidates."""
    if n > MAX_EDGES:
        raise ValueError(f"the gather walk takes at most {MAX_EDGES} edges, got {n}")
    if num_rows < 1 or d < 1:
        raise ValueError(f"gather_plan needs num_rows >= 1 and d >= 1, got {num_rows}, {d}")
    if slab < 32 or slab % 32:
        raise ValueError(f"a gather slab is a multiple of 32 columns, got {slab}")
    if not 1 <= rows <= GATHER_MAX_ROWS:
        raise ValueError(f"a gather block holds 1 to {GATHER_MAX_ROWS} rows, got {rows}")
    if not 1 <= warps <= GATHER_MAX_WARPS:
        raise ValueError(f"a gather block has 1 to {GATHER_MAX_WARPS} warps, got {warps}")
    if in_flight not in GATHER_IN_FLIGHT_CHOICES:
        raise ValueError(f"edges in flight must be one of {GATHER_IN_FLIGHT_CHOICES}, got {in_flight}")
    slab = min(slab, 32 * _ceil_div(d, 32))
    slabs = _ceil_div(d, slab)
    rows = min(rows, num_rows)
    warps = min(warps, rows)
    tiles = _ceil_div(num_rows, rows)
    blocks = tiles * slabs
    if blocks > MAX_BLOCKS:
        raise ValueError(f"a ({num_rows}, {d}) output needs {blocks} blocks, more than one launch has")
    return GatherPlan(slab, slabs, rows, tiles, blocks, 8 * rows, int(slab_major),
                      in_flight, warps)


def gather_plan(n: int, num_rows: int, d: int) -> GatherPlan:
    """Launch shape of the slab-major warp walk for ``n`` edges into a
    ``(num_rows, d)`` output: slabs of :data:`GATHER_SLAB` columns walked
    slab by slab, :data:`GATHER_ROWS` rows and :data:`GATHER_WARPS` warps
    per block, and :data:`GATHER_IN_FLIGHT` gathers in flight per lane,
    the fastest of ``tools/walk_sweep.py``'s candidates on an H100.  At
    the main path's shape a slab of the (50000, 4500) operand is 25.6 MB
    of the 50 MB L2.  An output of more rows than one launch's blocks can
    take at that tile height gets taller tiles."""
    rows = max(GATHER_ROWS, _ceil_div(num_rows * _ceil_div(d, GATHER_SLAB), MAX_BLOCKS))
    return make_gather_plan(n, num_rows, d, rows=rows)


# ----------------------------------------------------------------------
# launch shape of semiring_matmul's tile loop
# ----------------------------------------------------------------------

MATMUL_THREADS = 256  # csrc/semiring_matmul.cu:kThreads, 8 warps as 4 x 2
MATMUL_STAGES = 2  # csrc/semiring_matmul.cu:kStages
MATMUL_TILES = ((128, 128, 16), (128, 128, 8), (128, 64, 16))  # (BM, BN, BK) built
MATMUL_TILE = (128, 128, 16)
MATMUL_VECS = (4, 2, 1)  # floats per global access
PACKED = "or_and"  # the semiring that runs on words of 32 packed values of k


class MatmulPlan(ctypes.Structure):
    """``ReproMatmulPlan`` of ``csrc/semiring_matmul.cu``: ``tiles_m x
    tiles_n`` blocks of ``block_m x block_n`` outputs (block ``b`` owns tile
    row ``b div tiles_n`` and tile column ``b mod tiles_n``), each walking
    ``k_steps`` in stages of ``block_k`` with global accesses ``vec`` floats
    wide.  For ``or_and`` the loop runs over packed words: ``k_steps`` words
    per row of A (``ceil(kd / 32)`` rounded up to 4) and rows of ``ldb``
    words in B (``n`` rounded up to 4)."""

    _fields_ = [
        ("block_m", ctypes.c_int64),
        ("block_n", ctypes.c_int64),
        ("block_k", ctypes.c_int64),
        ("vec", ctypes.c_int64),
        ("k_steps", ctypes.c_int64),
        ("ldb", ctypes.c_int64),
        ("tiles_m", ctypes.c_int64),
        ("tiles_n", ctypes.c_int64),
        ("blocks", ctypes.c_int64),
        ("smem_bytes", ctypes.c_int64),
    ]

    def __repr__(self) -> str:
        return "MatmulPlan(" + ", ".join(
            f"{name}={getattr(self, name)}" for name, _ in self._fields_
        ) + ")"


def alignment(*tensors: torch.Tensor) -> int:
    """The largest of 16, 8 and 4 bytes that every tensor's data pointer
    is a multiple of."""
    return next(
        (al for al in (16, 8) if all(t.data_ptr() % al == 0 for t in tensors)), 4
    )


def matmul_plan(
    m: int,
    n: int,
    kd: int,
    semiring: str,
    align: int = 16,
    tile: tuple[int, int, int] = MATMUL_TILE,
    vec: int | None = None,
) -> MatmulPlan:
    """Launch shape of ``semiring_matmul`` for ``(m, kd) x (kd, n)`` with
    operand pointers aligned to ``align`` bytes: block tile ``tile``, by
    default :data:`MATMUL_TILE`, the fastest of ``tools/walk_sweep.py
    --cases matmul``'s candidates on an H100, and ``vec`` floats per
    access, by default the widest that ``align``, ``kd`` and ``n`` allow;
    raises on what the kernel cannot take."""
    if m < 1 or n < 1 or kd < 0:
        raise ValueError(f"matmul_plan needs m, n >= 1 and kd >= 0, got {m}, {n}, {kd}")
    if tile not in MATMUL_TILES:
        raise ValueError(f"a matmul block tile is one of {MATMUL_TILES}, got {tile}")
    bm, bn, bk = tile
    if semiring == PACKED:
        k_steps, ldb, widest = 4 * _ceil_div(_ceil_div(kd, 32), 4), 4 * _ceil_div(n, 4), 4
    else:
        k_steps, ldb = kd, n
        widest = next(v for v in MATMUL_VECS if align % (4 * v) == 0 and kd % v == 0 and n % v == 0)
    vec = widest if vec is None else vec
    if vec not in MATMUL_VECS or vec > widest or (semiring == PACKED and vec != 4):
        raise ValueError(f"{vec} floats per access do not fit ({m}, {kd}) x ({kd}, {n}) "
                         f"{semiring} at {align}-byte alignment (widest {widest})")
    tiles_m, tiles_n = _ceil_div(m, bm), _ceil_div(n, bn)
    blocks = tiles_m * tiles_n
    if blocks > MAX_BLOCKS:
        raise ValueError(f"a ({m}, {n}) output needs {blocks} blocks, more than one launch has")
    smem = MATMUL_STAGES * bk * (bm + bn) * 4
    return MatmulPlan(bm, bn, bk, vec, k_steps, ldb, tiles_m, tiles_n, blocks, smem)


# ----------------------------------------------------------------------
# fused-path switch
# ----------------------------------------------------------------------

_TRUTHY = frozenset({"1", "true", "on", "yes"})


def fused_enabled(option: bool | None = None) -> bool:
    """Resolve the fused-hop switch: an explicit plan option wins,
    otherwise the ``REPRO_FUSED`` environment variable decides."""
    if option is not None:
        return bool(option)
    return os.environ.get("REPRO_FUSED", "").strip().lower() in _TRUTHY


# ----------------------------------------------------------------------
# build
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class BuiltKernel:
    name: str
    library: Path
    log: str  # nvcc's output: ptxas registers, stack and spills
    seconds: float  # 0.0 when an existing build was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin); the "
        "repro_torch CUDA kernels are built from src/repro_torch/csrc at "
        "first use"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


# one build per process: concurrent first launches (the query server's
# workers) wait for it instead of starting nvcc on the same temp file
_build_lock = threading.Lock()
_built: dict[str, BuiltKernel] = {}  # guarded-by: _build_lock


def build() -> dict[str, BuiltKernel]:
    """Compile every kernel library not built yet, in parallel; raise
    with nvcc's output if any compile fails.  Built once per process;
    concurrent callers wait for the one build."""
    with _build_lock:
        if not _built:
            _built.update(_build_all())
        return dict(_built)


def _build_all() -> dict[str, BuiltKernel]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built: dict[str, BuiltKernel] = {}
    pending: dict[str, tuple[Path, Path, subprocess.Popen, float]] = {}
    try:
        for name in KERNELS:
            lib = _library_path(name)
            log = lib.with_suffix(".log")
            if lib.exists() and log.exists():
                built[name] = BuiltKernel(name, lib, log.read_text(), 0.0)
                continue
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            pending[name] = (lib, tmp, proc, time.perf_counter())
        for name, (lib, tmp, proc, t0) in pending.items():
            output, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name} (exit {proc.returncode}):\n{output}"
                )
            os.replace(tmp, lib)
            lib.with_suffix(".log").write_text(output)
            built[name] = BuiltKernel(name, lib, output, seconds)
    finally:
        for _, tmp, proc, _ in pending.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return built


@functools.cache
def load(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name``, built at
    first use; it returns a ``cudaError_t`` as an int."""
    lib = ctypes.CDLL(str(build()[name].library))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------
# dispatch and checks
# ----------------------------------------------------------------------


def device_of(*tensors: torch.Tensor | None) -> torch.device:
    """The one device all given tensors lie on; raises on a mix."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs lie on different devices: {devices}")
    return devices.pop()


def require(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {ndim}-d {dtype} tensor, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def output(
    kernel: str, out: torch.Tensor | None, shape: tuple[int, int], like: torch.Tensor
) -> torch.Tensor:
    """``out`` checked against ``shape``, or a new uninitialised tensor
    (the kernel writes every element)."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=like.device)
    require(kernel, "out", out, torch.float32, 2)
    if tuple(out.shape) != shape or out.device != like.device:
        raise ValueError(
            f"{kernel}: out must be {shape} on {like.device}, got "
            f"{tuple(out.shape)} on {out.device}"
        )
    return out


def check_width(kernel: str, d: int) -> None:
    if d >= 2**31:
        raise ValueError(f"{kernel}: row width {d} exceeds the kernel's 2**31 - 1")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(kernel: str, rc: int) -> None:
    """Raise if the launch was refused; count it otherwise."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
    count_launch(kernel)
