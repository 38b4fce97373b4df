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

Two hooks serve the persistent variant cache
(:mod:`repro_torch.core.variant_cache`): :func:`record_loads` reports
which libraries the calls made inside it asked for (a variant's
"compile"), and :func:`install_library` puts a cached library back under
its hashed name, so the next :func:`load_cuda_library` loads it without
calling ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from repro_torch import compat

__all__ = ["NVCC_FLAGS", "load_cuda_library", "build_log", "build_logs",
           "library_path", "source_digest", "record_loads",
           "install_library"]

#: ``sm_90a`` (not ``sm_90``): wgmma and setmaxnreg exist only there.
#: ``-split-compile=0`` runs a source's device-code optimisation on as many
#: threads as the host has: the flash attention source's 48 instantiations
#: built in 47 s instead of 125 (``chip_smoke.py`` phase 2, five libraries
#: at once on the card's 8-core host; PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

#: guards ``_name_locks``; held only to look up or create a name's lock
_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"path", "seconds", "built", "log"} of each library loaded
_logs: dict[str, dict] = {}
#: per thread: the lists of :func:`record_loads` scopes open on it
_recording = threading.local()


def build_log(name: str) -> dict | None:
    """How library ``name`` was obtained: path, build seconds, whether it
    was compiled in this process, and the compiler's output."""
    return _logs.get(name)


def build_logs() -> dict[str, dict]:
    """:func:`build_log` of every library loaded in this process."""
    return dict(_logs)


def library_path(name: str, source: Path) -> Path:
    """Where the library built from ``source`` lives: its name carries
    the hash of the source and of :data:`NVCC_FLAGS`."""
    return compat.BUILD_DIR / f"lib{name}-{source_digest(Path(source))}.so"


def source_digest(source: Path) -> str:
    """The hash a build of ``source`` is named by (source and flags)."""
    return hashlib.sha1(source.read_bytes()
                        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]


@contextlib.contextmanager
def record_loads():
    """Collect ``(name, source)`` of every library that
    :func:`load_cuda_library` is asked for on this thread inside the
    block, whether it was built, found on disk or already loaded."""
    scopes = getattr(_recording, "scopes", None)
    if scopes is None:
        scopes = _recording.scopes = []
    loads: list[tuple[str, Path]] = []
    scopes.append(loads)
    try:
        yield loads
    finally:
        scopes.remove(loads)


def install_library(name: str, source: Path, digest: str,
                    blob: bytes) -> bool:
    """Write a cached build of library ``name`` under its hashed name, so
    loading it calls no ``nvcc``.  Refuses (returns False) a build whose
    ``digest`` is not that of the current ``source``: a stale library is
    never served.  Writes under the name's lock, to a temporary name
    then renamed, like a build."""
    source = Path(source)
    if not source.is_file() or digest != source_digest(source):
        return False
    out = library_path(name, source)
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if not out.is_file():
            compat.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_bytes(blob)
            os.replace(tmp, out)
    return True


def load_cuda_library(name: str, source: Path) -> ctypes.CDLL:
    """The loaded shared library compiled from ``source``; compiles it on
    first use.  Raises if no CUDA compiler is found or the build fails."""
    for loads in getattr(_recording, "scopes", ()):
        loads.append((name, Path(source)))
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
    out = library_path(name, source)
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
