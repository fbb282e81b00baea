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

KERNELS = ("segment_sum", "coo_spmm", "segment_reduce")

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


@functools.cache
def build() -> dict[str, BuiltKernel]:
    """Compile every kernel library not built yet, in parallel; raise
    with nvcc's output if any compile fails."""
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
