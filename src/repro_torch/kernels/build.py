"""Compile CUDA C++ sources with ``nvcc`` and load them with ``ctypes``.

Each kernel source under a ``csrc/`` directory exposes a plain C interface
(no PyTorch headers), so one ``nvcc`` call takes seconds.  Libraries are
built on first use into :data:`repro_torch.compat.BUILD_DIR`, named by the
hash of their source so an edited source is never served a stale build,
and written under a temporary name then renamed, so concurrent processes
never load a half-written file.  Within a process each library is built
and loaded once, under a lock of its own: compile-service worker threads
may ask for it concurrently, and building one library never blocks a
caller of another.  Once loaded, a library is returned without locking.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from repro_torch import compat

__all__ = ["NVCC_FLAGS", "load_cuda_library", "build_log"]

#: ``sm_90a`` (not ``sm_90``): wgmma and setmaxnreg exist only there.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: guards ``_name_locks``; held only to look up or create a name's lock
_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"path", "seconds", "built", "log"} of each library loaded
_logs: dict[str, dict] = {}


def build_log(name: str) -> dict | None:
    """How library ``name`` was obtained: path, build seconds, whether it
    was compiled in this process, and the compiler's output."""
    return _logs.get(name)


def load_cuda_library(name: str, source: Path) -> ctypes.CDLL:
    """The loaded shared library compiled from ``source``; compiles it on
    first use.  Raises if no CUDA compiler is found or the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            path, info = _build(name, Path(source))
            lib = ctypes.CDLL(str(path))
            _logs[name] = info
            _libs[name] = lib
        return lib


def _build(name: str, source: Path) -> tuple[Path, dict]:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = compat.BUILD_DIR / f"lib{name}-{digest}.so"
    if out.is_file():
        return out, {"path": str(out), "seconds": 0.0, "built": False,
                     "log": ""}
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {name}: no nvcc on the PATH, under CUDA_HOME or "
            f"in /usr/local/cuda")
    compat.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, {"path": str(out), "seconds": seconds, "built": True,
                 "log": proc.stdout + proc.stderr}
