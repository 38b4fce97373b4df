"""Persistent variant cache: built kernel libraries across process runs.

The paper's online search pays a compile per candidate (§6.4, Table 4).
In the port, compiling a variant means building and loading the kernel
libraries its configuration names (one ``nvcc`` call each,
:mod:`repro_torch.kernels.build`).  This module makes that free on a warm
restart: every variant the runtime compiles is recorded on disk with the
libraries it loaded (their ``.so`` bytes, name and source digest), and a
fresh process that asks for the same (handler, config, context, backend)
puts those libraries back under their hashed names and loads them with
**zero ``nvcc`` calls**.  A variant that names no library (every variant
on the CPU) is stored as a record only; its hit counts all the same.

Key schema (any component changing invalidates the entry):

    (cache format version, handler name, config_key, instrumented flag,
     argument fingerprint, backend fingerprint)

hashed to one file ``<dir>/<sha256>.var``.  The runtime passes the
*context* as the argument fingerprint: a library does not depend on
shapes, and it is built when a variant is installed, before any call's
arguments are seen; the serve engine's contexts are its shape classes.
The backend fingerprint is the torch and CUDA versions, the device's name
and compute capability, the ``nvcc`` release, the ``nvcc`` flags and the
device count.  The source digest is not in the key but in the entry: an
entry whose digest is not the current source's is a miss, so a stale
build is never served.  Writes are atomic (tempfile + rename) so a crash
mid-store never corrupts an entry; an unreadable entry logs a warning, is
deleted, and the caller builds again.
"""
from __future__ import annotations

import functools
import hashlib
import logging
import os
import pickle
import re
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any

import torch

from repro_torch import compat
from repro_torch.core.metrics import AtomicCounter

logger = logging.getLogger("repro_torch.core.variant_cache")

__all__ = ["VariantCache", "CacheStats", "spec_fingerprint",
           "backend_fingerprint"]

_FORMAT_VERSION = 1
_SUFFIX = ".var"
#: library sources are recorded relative to the package root, so an entry
#: stays valid for another checkout of the same sources
_PACKAGE_ROOT = Path(__file__).resolve().parents[1]


def _describe_leaf(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return f"{x.dtype}{tuple(x.shape)}@{x.device}"
    return f"py:{x!r}"


def spec_fingerprint(args: tuple, kwargs: dict) -> str:
    """Canonical string for an argument pytree (tensors by dtype, shape
    and device; anything else by repr)."""
    leaves, treedef = compat.tree_flatten((args, kwargs))
    return f"{treedef}|{';'.join(_describe_leaf(x) for x in leaves)}"


def _device_info() -> tuple[str, str, int]:
    """(device name, compute capability, device count) of this host."""
    if torch.cuda.is_available():
        cap = torch.cuda.get_device_capability(0)
        return (torch.cuda.get_device_name(0), f"sm{cap[0]}{cap[1]}",
                torch.cuda.device_count())
    return "cpu", "-", 1


@functools.lru_cache(maxsize=1)
def _nvcc_release() -> str:
    nvcc = compat.nvcc_path()
    if nvcc is None:
        return "none"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    m = re.search(r"release ([\d.]+)", out)
    return m.group(1) if m else "unknown"


def backend_fingerprint(portable: bool = False) -> str:
    """Backend component of the cache key.

    ``portable=True`` drops the device *count* (keeping the device kind,
    capability, toolchain and versions), so libraries built on one host
    warm-start N identical replicas.
    """
    from repro_torch.kernels import build

    name, cap, count = _device_info()
    count = "*" if portable else str(count)
    return (f"torch-{torch.__version__}|cuda-{torch.version.cuda}|{name}"
            f"|{cap}|nvcc-{_nvcc_release()}|{' '.join(build.NVCC_FLAGS)}"
            f"|{count}")


class CacheStats:
    """Lock-free counters (loads/stores run on concurrent compile workers)."""

    __slots__ = ("hits", "misses", "stores", "errors", "evictions")

    def __init__(self):
        self.hits = AtomicCounter()
        self.misses = AtomicCounter()
        self.stores = AtomicCounter()
        self.errors = AtomicCounter()
        self.evictions = AtomicCounter()

    def as_dict(self) -> dict:
        return {name: getattr(self, name).value() for name in self.__slots__}


class VariantCache:
    """Disk cache of the kernel libraries each variant loaded (see the
    module docstring).

    ``max_bytes`` caps the on-disk size: when an insert pushes the total
    over the cap, the least-recently-used entries (by file mtime — loads
    touch their entry, so mtime tracks last use, not last write) are
    evicted until the cache fits again.  ``None`` = unbounded.

    ``portable=True`` drops the device **count** from the entry key, so a
    cache populated on one host warm-starts N identical replicas behind a
    shared store.  A library is compiled for one architecture
    (``sm_90a``) and does not depend on the count, so the tradeoff the
    reference names (a program partitioned for another topology) does not
    arise here; the default stays pinned to the exact count, as there.
    """

    def __init__(self, directory: str, max_bytes: int | None = None,
                 portable: bool = False):
        self.directory = str(directory)
        self.max_bytes = max_bytes
        self.portable = bool(portable)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self.stats = CacheStats()

    # -- keys -----------------------------------------------------------------
    def entry_key(self, handler_name: str, config_key: tuple,
                  instrumented: bool, arg_fingerprint: str) -> str:
        raw = repr((_FORMAT_VERSION, handler_name, config_key,
                    bool(instrumented), arg_fingerprint,
                    backend_fingerprint(self.portable)))
        return hashlib.sha256(raw.encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key + _SUFFIX)

    # -- load / store ----------------------------------------------------------
    def load(self, key: str) -> list[str] | None:
        """Install the entry's libraries into the build directory and
        return their names (``[]`` for a record-only entry), or None on a
        miss: no entry, a corrupt one (deleted), or one holding a library
        whose source has changed since it was built."""
        from repro_torch.kernels import build

        path = self._path(key)
        if not os.path.exists(path):
            self.stats.misses.bump()
            return None
        try:
            with open(path, "rb") as f:
                entry = pickle.load(f)
            libraries = entry["libraries"]
            for lib in libraries:
                if not build.install_library(
                        lib["name"], _PACKAGE_ROOT / lib["source"],
                        lib["digest"], lib["blob"]):
                    logger.info("variant cache entry %s holds a stale "
                                "build of %s; building again", key,
                                lib["name"])
                    self.stats.misses.bump()
                    return None
        except Exception as e:
            # Corrupt / cross-version entry: drop it and build again.
            self.stats.errors.bump()
            self.stats.misses.bump()
            logger.warning("variant cache entry %s unreadable (%s: %s); "
                           "deleting and building again", key,
                           type(e).__name__, e)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.stats.hits.bump()
        try:
            os.utime(path, None)         # refresh last_used for LRU eviction
        except OSError:
            pass
        return [lib["name"] for lib in libraries]

    def store(self, key: str, libraries: list[tuple[str, Path]],
              meta: dict | None = None) -> bool:
        """Record the libraries ``(name, source)`` a variant loaded (their
        builds are read from the build directory); atomic, best-effort."""
        from repro_torch.kernels import build

        try:
            records = []
            for name, source in dict(libraries).items():
                source = Path(source).resolve()
                records.append({
                    "name": name,
                    "source": str(source.relative_to(_PACKAGE_ROOT)),
                    "digest": build.source_digest(source),
                    "blob": build.library_path(name, source).read_bytes()})
            blob = pickle.dumps({"format": _FORMAT_VERSION,
                                 "backend": backend_fingerprint(
                                     self.portable),
                                 "meta": dict(meta or {}),
                                 "libraries": records})
        except (OSError, ValueError) as e:
            self.stats.errors.bump()
            logger.warning("variant cache cannot record %s: %s", key, e)
            return False
        path = self._path(key)
        with self._lock:
            tmp = None
            try:
                # distinct suffix: a crash mid-store must not leave a file
                # that entries()/load() would mistake for a real entry
                fd, tmp = tempfile.mkstemp(dir=self.directory,
                                           prefix=".tmp_", suffix=".part")
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)            # atomic publish
            except OSError as e:
                self.stats.errors.bump()
                logger.warning("variant cache store failed for %s: %s",
                               key, e)
                if tmp is not None:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                return False
            if self.max_bytes is not None:
                self._evict_lru_locked(keep=path)
        self.stats.stores.bump()
        return True

    def _evict_lru_locked(self, keep: str | None = None) -> int:
        """Evict least-recently-used entries until the cache fits
        ``max_bytes``.  The just-written entry (``keep``) survives even when
        it alone exceeds the cap — evicting what was just stored would make
        the cache useless for oversized-but-only entries."""
        entries = []
        for name in os.listdir(self.directory):
            if not name.endswith(_SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
        total = sum(size for _, size, _ in entries)
        evicted = 0
        for _, size, path in sorted(entries):   # oldest last_used first
            if total <= self.max_bytes:
                break
            if path == keep:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            evicted += 1
            self.stats.evictions.bump()
            logger.info("variant cache evicted LRU entry %s (%d bytes)",
                        os.path.basename(path), size)
        return evicted

    # -- maintenance -----------------------------------------------------------
    def entries(self) -> list[str]:
        return sorted(n[:-len(_SUFFIX)] for n in os.listdir(self.directory)
                      if n.endswith(_SUFFIX))

    def clear(self) -> None:
        for key in self.entries():
            try:
                os.unlink(self._path(key))
            except OSError:
                pass
