"""Build and bind the port's hand-written CUDA kernels.

Every ``*.cu`` under ``kernels/csrc/`` and ``kernels/<name>/csrc/`` is
compiled with ``nvcc`` for ``sm_90a`` into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at the
first launch, never at import (the CPU tests import every module on a
host with no ``nvcc``): one ``nvcc -c`` per source, all started
together, then one link. The library lands in ``kernels/_build/`` (git
ignores it) under a name keyed by a hash of the sources and flags, so a
fresh checkout builds once and a source change rebuilds.

``CudaKernel`` is what each op's wrapper holds: the C symbol with its
``argtypes`` (``c_void_p`` for every pointer and the stream, or ctypes
would cut pointers to 32 bits) and a launch counter that the wrapper
bumps only where it launches. The count is exact under threads (a
campaign's prefetch threads launch ``fast_features`` at once, and ctypes
releases the GIL during the launch), so the bump takes a lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources(kernels_dir: Path = KERNELS_DIR) -> list[Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(list(kernels_dir.glob("csrc/*.cu"))
                  + list(kernels_dir.glob("*/csrc/*.cu")))


def _fingerprint(kernels_dir: Path) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(list(kernels_dir.glob("csrc/*"))
                    + list(kernels_dir.glob("*/csrc/*"))):
        h.update(str(p.relative_to(kernels_dir)).encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                       "the port's CUDA kernels are built from source at "
                       "first launch")


def library_path(kernels_dir: Path = KERNELS_DIR) -> Path:
    return BUILD_DIR / f"libadaparse_kernels_{_fingerprint(kernels_dir)}.so"


def build(kernels_dir: Path = KERNELS_DIR) -> Path:
    """Compile every source in parallel and link them into the keyed
    library (no-op when it already exists). Compiler output, including
    ``-Xptxas -v``'s register and shared-memory report, is kept in
    ``<library>.log``. Raises with that output when a step fails.
    ``kernels_dir``: the ``kernels/`` directory of another checkout, to
    build its library beside this one's (``launch.kernel_timing``)."""
    lib = library_path(kernels_dir)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for src in sources(kernels_dir):
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.relative_to(kernels_dir)} (rc {p.returncode})\n"
                   f"{out}")
        if p.returncode:
            failed.append(src.name)
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    try:
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode:
                failed.append("link")
        text = "".join(log)
        lib.with_suffix(".log").write_text(text)
        if failed:
            raise RuntimeError(f"CUDA kernel build failed at {failed}:\n"
                               f"{text}")
        os.replace(tmp, lib)         # atomic: concurrent builds agree
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe: the
    prefetch worker thread may launch the first kernel)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.adaparse_error_string.argtypes = [ctypes.c_int]
            lib.adaparse_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


#: every CudaKernel made in this process, by name (``launch_counts``)
_KERNELS: dict[str, "CudaKernel"] = {}


class CudaKernel:
    """One exported C launcher plus the wrapper's launch counter."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()
        _KERNELS[name] = self

    def __call__(self, *args) -> None:
        """Launch on the current stream; raise if the launch was refused.
        Counts one launch per call, exactly under concurrent callers."""
        if self._fn is None:
            lib = library()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            msg = library().adaparse_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{err} ({msg})")
        with self._count_lock:
            self.launches += 1


def launch_counts() -> dict[str, int]:
    """Launches of every kernel whose wrapper this process imported
    (a worker process ships these to the coordinator, whose own counters
    never see its launches)."""
    return {name: k.launches for name, k in _KERNELS.items()}


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

# A kernel that does nothing (blocks, threads, cooperative, stream): the
# floor under a small kernel's device time at its grid and launch kind.
# Measurement only; no path launches it.
EMPTY = CudaKernel("empty", "adaparse_empty", [I, I, I, P])
