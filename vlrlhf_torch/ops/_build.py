"""Build and load the hand-written CUDA kernels in vlrlhf_torch/csrc/.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with nvcc for sm_90a into `<repo>/build/lib<name>-<hash>.so`, then
loaded with ctypes. The hash covers the source and the shared headers
(`csrc/*.cuh`), so an edited kernel gets a fresh library and an unchanged
one is reused. Nothing is built at import:
the CPU tests import every module on machines without nvcc. Each library has
its own lock, so different kernels build in parallel (`build_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}  # (name, symbol) -> prototyped C function
build_seconds: dict[str, float] = {}  # name -> nvcc wall seconds (0 = cached)
ptxas_info: dict[str, str] = {}  # name -> nvcc's register/smem report


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, compiling it if needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            build_seconds[name] = 0.0
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)  # atomic: a concurrent process never loads a partial .so
            build_seconds[name] = time.perf_counter() - t0
            ptxas_info[name] = proc.stderr.strip()
        _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def fn(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function `symbol` of csrc/<name>.cu with its ctypes prototype
    set once per library, so a launch pays a dict lookup, not the set-up."""
    f = _fns.get((name, symbol))
    if f is None:
        f = getattr(load(name), symbol)
        f.argtypes, f.restype = list(argtypes), restype
        _fns[(name, symbol)] = f
    return f


def build_all(names) -> None:
    """Load every named library, running their nvcc builds concurrently
    (one process per source); raises the first build error."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for fut in [pool.submit(load, n) for n in names]:
            fut.result()


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


class Rotating:
    """A call that launches the C function fn on the next of arg_sets each
    time (a kernel alone: no wrapper, no launch counted), so that timed
    launches read a cache or weights that moved out of the L2; `index` is
    the arg set it launched on last."""

    def __init__(self, fn, arg_sets, what: str):
        self.fn, self.arg_sets, self.what, self.index = fn, list(arg_sets), what, -1

    def __call__(self) -> None:
        self.index = (self.index + 1) % len(self.arg_sets)
        check(self.fn(*self.arg_sets[self.index]), self.what)
