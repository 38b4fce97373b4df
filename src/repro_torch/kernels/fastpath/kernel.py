"""``ctypes`` wrapper of the hand-written CUDA fast-path matcher
(``csrc/fastpath.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/fastpath/kernel.py::fastpath_lookup_pallas``).  The
library is compiled for ``sm_90a`` with ``nvcc`` on first use
(:func:`load_library`); the wrappers check their inputs, allocate the
outputs, launch on PyTorch's current stream and raise if the launch
reports an error.  ``launches`` counts the kernel launches of this
process, through either entry point.

Two entry points, one kernel entry with two bodies (:data:`BODIES`):

* :func:`fastpath_cuda` takes the raw table ``(keys, values)`` and runs
  the dense body (every query against every key).
* :func:`fastpath_cuda_prepared` takes a :class:`PreparedTable`, built
  once by :func:`prepare_table` when a handler is specialized: the table
  as an open-addressing hash table (built on the host with numpy,
  uploaded once), beside the raw arrays.  The kernel picks the hashed
  body for a table of at least ``kHashMinKeys`` keys and the dense one
  below (:func:`body` says which).

``block_b`` (query rows per thread block, at most) is any positive
integer: the kernel rounds it up to whole warps and caps it at 256 rows,
and takes fewer rows a block when the batch would not fill the card's
SMs; the reference's ``block_b`` only tiles the batch, and no answer
depends on it.  Queries are of any integer dtype (int8, int16, int32,
int64, uint8), keys of those or fp32, bf16 or fp16, and the two need not
share one: a query and a key compare as ``==`` compares them, in their
promoted dtype.  The kernel compares canonical integers
(:func:`canonical_keys`: an integer key's value, a float key's fp32 bit
pattern with -0.0 as +0.0), and canonicalises each query as it loads it.
Keys have any width (past 32 integers a slower path of the same
kernel).  Values are float32, bfloat16, float16, int32 or int64.  Integer
values are summed exactly (wrapping) in their own type, float values in
fp32 and rounded once.  A ragged batch is masked in the kernel, never
padded.

Every launch also counts the batch's misses.  Given a
:class:`MissReadback`, the kernel writes the count to a mapped host word
and the call waits on the stream, so the caller reads it with no copy and
no reduction launch.

A launch costs more on the host than on the card at the router's size, so
the common case runs one combined check, packs its arguments into one
bytes object (the table's half packed once, in the :class:`PreparedTable`)
and reads the current stream through PyTorch's raw-stream call; a call
that fails the check goes through a ``_diagnose`` function, which raises
the precise error (of a dtype, shape or size the library lacks:
:func:`unsupported`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
import weakref
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.common import refuse_autograd

__all__ = ["BODIES", "DEFAULT_BLOCK_B", "MissReadback", "PreparedTable",
           "SOURCE", "body", "build_hashed", "canonical_keys",
           "canonical_queries", "fastpath_cuda", "fastpath_cuda_prepared",
           "hash_keys", "hash_min_keys", "launches", "load_library",
           "prepare_table", "reset_launches", "unsupported"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastpath.cu"

#: rows per block when the caller does not choose (the reference's)
DEFAULT_BLOCK_B = 256
#: the kernel's bodies, by the code ``fastpath_body`` returns
BODIES = ("dense", "hashed")

#: query dtypes by the library's code (csrc/fastpath.cu: KeyCode)
_QUERY_CODES = {torch.int32: 0, torch.int64: 1, torch.int8: 2,
                torch.int16: 3, torch.uint8: 4}
#: key dtypes by the library's code: the query dtypes and three float ones
_KEY_CODES = {**_QUERY_CODES, torch.float32: 5, torch.bfloat16: 6,
              torch.float16: 7}
_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
                torch.int64: 3, torch.float16: 4}
_LIMIT = 2 ** 31

# The key hash, as the kernel's (csrc/fastpath.cu: kHashSeed, kMix1, kMix2,
# mix64, hash_step): each key integer, sign-extended to 64 bits, is xored
# into the state and mixed with splitmix64's finalizer.
_HASH_SEED = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``fastpath_fwd_packed``, set by :func:`load_library`
_fwd = None
#: a launch's per-call arguments, the first half of the library's ``Args``:
#: x, out, hit, ticket, host_miss, stream, b, block_b, sms, body, wait,
#: query_dtype
_pack_call = struct.Struct("<6Q6q").pack
#: a table's half: keys, vals, hkeys, hvals, slots, n, kw, v, mask,
#: key_dtype, value_dtype
_pack_table = struct.Struct("<5Q6q").pack
#: the current stream's handle on a device: PyTorch's raw-stream call where
#: this build has it (a CUDA build does), which builds no
#: ``torch.cuda.Stream``
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda dev: torch.cuda.current_stream(dev).cuda_stream)

#: (device, stream) -> (the device's SMs, address of the stream's scratch
#: word: the kernel's miss ticket, 0 between launches)
_scratch: dict[tuple[int, int], tuple[int, int]] = {}
#: device -> its scratch words (zeroed once), and how many are taken
_pools: dict[int, torch.Tensor] = {}
_pool_used: dict[int, int] = {}
_POOL_WORDS = 1024
_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("fastpath", SOURCE)
    if _fwd is None:
        lib.fastpath_body.argtypes = [ctypes.c_longlong]
        lib.fastpath_body.restype = ctypes.c_int
        lib.fastpath_hash_min_keys.argtypes = []
        lib.fastpath_hash_min_keys.restype = ctypes.c_longlong
        lib.fastpath_hash.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.fastpath_hash.restype = None
        lib.fastpath_host_word.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2
        lib.fastpath_host_word.restype = ctypes.c_int
        lib.fastpath_free_host_word.argtypes = [ctypes.c_void_p]
        lib.fastpath_free_host_word.restype = ctypes.c_int
        lib.fastpath_error_string.argtypes = [ctypes.c_int]
        lib.fastpath_error_string.restype = ctypes.c_char_p
        fn = lib.fastpath_fwd_packed
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return lib


# -- the hashed table, built on the host -----------------------------------------

def canonical_keys(keys: torch.Tensor) -> torch.Tensor:
    """Keys as the kernel compares them (``canon_key`` in
    ``csrc/fastpath.cu``): integer keys as their values (int64 keys as
    int64, the others as int32), float keys as the int32 bit pattern of
    their fp32 value with -0.0 as +0.0 (a NaN keeps its pattern, which no
    query reaches)."""
    if keys.dtype.is_floating_point:
        bits = keys.to(torch.float32).contiguous().view(torch.int32)
        return torch.where(bits == -2 ** 31, torch.zeros_like(bits), bits)
    return keys if keys.dtype == torch.int64 else keys.to(torch.int32)


def canonical_queries(x: torch.Tensor, key_dtype: torch.dtype
                      ) -> torch.Tensor:
    """Integer queries as the kernel compares them against keys of
    ``key_dtype`` (``canon_query``): against float keys, the canonical
    form of the query rounded to the keys' dtype (``==``'s promotion);
    against integer keys, the value, as int64."""
    if key_dtype.is_floating_point:
        return canonical_keys(x.to(key_dtype))
    return x.to(torch.int64)


def hash_keys(keys: np.ndarray) -> np.ndarray:
    """``(N, K)`` canonical integer keys -> their ``(N,)`` uint64 hashes, as
    the kernel computes them (``Query::hash`` in ``csrc/fastpath.cu``)."""
    k = np.ascontiguousarray(np.asarray(keys).astype(np.int64)).view(
        np.uint64)
    h = np.full(k.shape[0], _HASH_SEED, np.uint64)
    m1, m2 = np.uint64(_MIX1), np.uint64(_MIX2)
    s30, s27, s31 = np.uint64(30), np.uint64(27), np.uint64(31)
    with np.errstate(over="ignore"):
        for c in range(k.shape[1]):
            z = h ^ k[:, c]
            z ^= z >> s30
            z *= m1
            z ^= z >> s27
            z *= m2
            z ^= z >> s31
            h = z
    return h


def build_hashed(keys: np.ndarray, values: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The hashed form of a table ``keys (N, K)``, ``values (N, V)``:
    ``(slots, distinct keys (D, K), summed values (D, V))``.

    ``slots`` has a power of two of at least ``2 N`` (and 2) entries, each
    a distinct key's row or -1, filled by linear probing from the key's
    hash; the distinct keys keep their first row's order, and each one's
    values are the sum over its duplicates, in the values' dtype (float32
    for float values: integers wrap, floats round once at the output)."""
    n, kw = keys.shape
    if n:
        uniq, first, inv = np.unique(keys, axis=0, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        dkeys, row = uniq[order], rank[inv.reshape(-1)]
    else:
        dkeys, row = keys[:0], np.zeros(0, np.int64)
    dvalues = np.zeros((len(dkeys), values.shape[1]), values.dtype)
    np.add.at(dvalues, row, values)
    size = 2
    while size < 2 * n:
        size *= 2
    mask = size - 1
    slots = np.full(size, -1, np.int32)
    for i, s in enumerate((hash_keys(dkeys) & np.uint64(mask)).tolist()):
        while slots[s] >= 0:
            s = (s + 1) & mask
        slots[s] = i
    return slots, dkeys, dvalues


@dataclasses.dataclass(frozen=True, eq=False)
class PreparedTable:
    """A fast-path table in the kernel's hashed form (:func:`prepare_table`),
    with the raw arrays it was built from (the dense body's, and the plain
    version's)."""

    keys: torch.Tensor     # (N, K), as given
    values: torch.Tensor   # (N, V), as given
    slots: torch.Tensor    # (S,) int32: a distinct key's row, or -1
    hkeys: torch.Tensor    # (D, K) the distinct canonical keys
    hvalues: torch.Tensor  # (D, V) their summed values (fp32 for floats)
    packed: bytes          # the table's half of a launch's arguments
    device: int            # CUDA device index, -1 on the host
    kdtype: torch.dtype    # the keys' dtype
    kw: int                # key width K
    v: int                 # value width V
    rows: int              # batches must have fewer rows (32-bit indices)

    @property
    def n(self) -> int:
        return self.keys.shape[0]


def prepare_table(keys: torch.Tensor, values: torch.Tensor
                  ) -> PreparedTable:
    """Build the hashed form of ``keys (N, K)`` and ``values (N, V)`` (of
    dtypes the kernel takes), contiguous on one device, on the host with
    numpy, and upload it to that device once.  The hashed form holds the
    canonical keys (:func:`canonical_keys`).  On the CPU the form serves
    the plain probe (``ref.lookup_prepared``)."""
    if keys.device != values.device:
        raise ValueError(f"keys on {keys.device}, values on "
                         f"{values.device}")
    if keys.dtype not in _KEY_CODES:
        raise TypeError(f"keys must be int8, int16, int32, int64, uint8, "
                        f"float32, bfloat16 or float16, got {keys.dtype}")
    if values.dtype not in _VALUE_CODES:
        raise TypeError(f"values must be float32, bfloat16, float16, int32 "
                        f"or int64, got {values.dtype}")
    if keys.ndim != 2 or values.ndim != 2 or keys.shape[0] != values.shape[0]:
        raise ValueError(f"need keys (N, K) and values (N, V), got "
                         f"{tuple(keys.shape)} and {tuple(values.shape)}")
    if keys.shape[1] < 1:
        raise ValueError("keys must have at least one integer")
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("prepare_table needs contiguous keys and values")
    n, kw = keys.shape
    v = values.shape[1]
    if max(4 * n, n * kw, n * v) >= _LIMIT:
        raise ValueError("the table exceeds the kernel's 32-bit indices")
    host = values.detach().cpu()
    stored = torch.float32 if host.dtype.is_floating_point else host.dtype
    slots, dkeys, dvalues = build_hashed(
        canonical_keys(keys.detach().cpu()).numpy(), host.to(stored).numpy())
    dev = keys.device
    slots_t = torch.from_numpy(slots).to(dev)
    hkeys = torch.from_numpy(dkeys).to(dev)
    hvalues = torch.from_numpy(dvalues).to(dev)
    if dev.type == "cuda":
        load_library()
    packed = _pack_table(keys.data_ptr(), values.data_ptr(),
                         hkeys.data_ptr(), hvalues.data_ptr(),
                         slots_t.data_ptr(), n, kw, v, len(slots) - 1,
                         _KEY_CODES[keys.dtype], _VALUE_CODES[values.dtype])
    return PreparedTable(keys, values, slots_t, hkeys, hvalues, packed,
                         keys.get_device(), keys.dtype, kw, v,
                         (_LIMIT - 32) // max(kw, v, 1))


def body(table: PreparedTable) -> str:
    """The body (:data:`BODIES`) a launch on ``table`` runs unless told
    which (:func:`fastpath_cuda` always runs the dense one)."""
    return BODIES[load_library().fastpath_body(table.n)]


def hash_min_keys() -> int:
    """The least table size a prepared launch runs on the hashed body."""
    return int(load_library().fastpath_hash_min_keys())


class MissReadback:
    """A mapped, pinned host word that a launch writes its batch's miss
    count to (allocated by the library with ``cudaHostAllocMapped``, so the
    kernel stores into host memory and no copy is launched).  A launch
    given one waits on the stream before it returns; :attr:`misses` then
    holds that launch's count."""

    def __init__(self):
        lib = load_library()
        host, device = ctypes.c_void_p(), ctypes.c_void_p()
        err = lib.fastpath_host_word(ctypes.byref(host), ctypes.byref(device))
        if err:
            _launch_failed(err, "mapping a host word")
        self.device_address = device.value
        self._word = ctypes.c_int32.from_address(host.value)
        weakref.finalize(self, lib.fastpath_free_host_word, host.value)

    @property
    def misses(self) -> int:
        return self._word.value


# -- launches ----------------------------------------------------------------------

def _launch_failed(err: int, what: str = "fastpath launch") -> None:
    msg = load_library().fastpath_error_string(err).decode()
    raise RuntimeError(f"{what} failed: {msg} ({err})")


def _stream_scratch(dev: int, stream: int) -> tuple[int, int]:
    """``_scratch``'s entry for a stream, made on its first launch."""
    with _lock:
        entry = _scratch.get((dev, stream))
        if entry is not None:
            return entry
        pool = _pools.get(dev)
        if pool is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the fast-path matcher's first launch on a device must "
                    "not be captured in a CUDA graph")
            pool = torch.zeros(_POOL_WORDS, dtype=torch.int64,
                               device=torch.device("cuda", dev))
            torch.cuda.synchronize(dev)       # zero before any stream uses it
            _pools[dev], _pool_used[dev] = pool, 0
        used = _pool_used[dev]
        if used == _POOL_WORDS:
            raise RuntimeError(f"the fast-path matcher has launched on "
                               f"{used} streams of cuda:{dev}, the most its "
                               f"scratch words serve")
        _pool_used[dev] = used + 1
        entry = _scratch[(dev, stream)] = (
            torch.cuda.get_device_properties(dev).multi_processor_count,
            pool.data_ptr() + 8 * used)
        return entry


def _launch(x: torch.Tensor, dev: int, b: int, v: int, vdtype: torch.dtype,
            table: bytes, block_b: int, body_code: int, query_code: int,
            readback: MissReadback | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the outputs, launch, count.  ``out`` and ``hit`` are two
    allocations: on an H100's host two ``torch.empty`` calls cost less
    than one allocation and the views that would cut it into a value
    tensor and a bool one (``tools/fastpath_ab.py``, ``alloc_us``)."""
    global launches
    stream = _stream(dev)
    entry = _scratch.get((dev, stream))
    sms, scratch = entry if entry is not None else _stream_scratch(
        dev, stream)
    out = x.new_empty((b, v), dtype=vdtype)
    hit = x.new_empty((b,), dtype=torch.bool)
    if b == 0:
        if readback is not None:
            readback._word.value = 0
        return out, hit
    if _fwd is None:
        load_library()
    err = _fwd(_pack_call(
        x.data_ptr(), out.data_ptr(), hit.data_ptr(), scratch,
        readback.device_address if readback is not None else 0, stream,
        b, block_b, sms, body_code, readback is not None,
        query_code) + table)
    if err:
        _launch_failed(err)
    launches += 1
    return out, hit


def _ok(t: torch.Tensor, dev: int) -> bool:
    return t.get_device() == dev and t.dim() == 2 and t.is_contiguous()


def unsupported(x: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                *, block_b: int = DEFAULT_BLOCK_B) -> Exception | None:
    """The error :func:`fastpath_cuda` raises on these arguments for what
    the library does not instantiate (queries of a dtype other than int8,
    int16, int32, int64 and uint8, keys of another than those and fp32,
    bf16 and fp16, values of another than fp32, bf16, fp16, int32 and
    int64, sizes past 32-bit indices), for a ``block_b`` that is not a
    positive integer or for shapes that disagree; None where it takes
    them.  Reads dtypes and shapes only, so it runs on the CPU; devices and
    layout are the wrapper's to check."""
    for what, t in (("x", x), ("keys", keys), ("values", values)):
        if t.ndim != 2:
            return ValueError(f"{what} must be 2-D, got {tuple(t.shape)}")
    if x.dtype not in _QUERY_CODES:
        return TypeError(f"queries must be integer (int8, int16, int32, "
                         f"int64 or uint8), got {x.dtype}")
    if keys.dtype not in _KEY_CODES:
        return TypeError(f"keys must be int8, int16, int32, int64, uint8, "
                         f"float32, bfloat16 or float16, got {keys.dtype}")
    if values.dtype not in _VALUE_CODES:
        return TypeError(f"values must be float32, bfloat16, float16, int32 "
                         f"or int64, got {values.dtype}")
    b, kw = x.shape
    n, v = values.shape
    if keys.shape != (n, kw):
        return ValueError(f"keys must be ({n}, {kw}), got "
                          f"{tuple(keys.shape)}")
    if kw < 1:
        return ValueError("keys must have at least one integer")
    if not (isinstance(block_b, int) and block_b >= 1):
        return ValueError(f"block_b must be a positive integer, got "
                          f"{block_b!r}")
    if max(b * kw, n * kw, n * v, b * v, b + 32) >= _LIMIT:
        return ValueError("sizes exceed the kernel's 32-bit indices")
    return None


def _diagnose(name: str, tensors: dict, block_b: int) -> None:
    """Raise the error a call that failed the combined check deserves."""
    x = tensors["x"]
    for what, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, {what} is on "
                             f"{t.device}")
        if t.device != x.device:
            raise ValueError(f"{what} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors; {what} is "
                             f"not")
    err = unsupported(x, tensors["keys"], tensors["values"], block_b=block_b)
    if err is not None:
        raise err
    raise ValueError("sizes exceed the kernel's 32-bit indices")


def fastpath_cuda(x: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                  *, block_b: int = DEFAULT_BLOCK_B,
                  readback: MissReadback | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Match the rows of integer queries ``x (B, K)`` against ``keys (N,
    K)`` (``==`` in their promoted dtype) and sum the rows of ``values (N,
    V)`` whose keys match, all contiguous on one CUDA device, on the dense
    body.  Returns ``(out (B, V) of values.dtype, hit (B,) bool)``, ``out``
    rows 0 where ``hit`` is False; with ``readback`` the batch's miss count
    lands there and the call waits on the stream."""
    refuse_autograd("fastpath_cuda", values)
    dev = x.get_device()
    b, kw = x.shape if x.dim() == 2 else (0, 0)
    n, v = values.shape if values.dim() == 2 else (0, 0)
    qcode = _QUERY_CODES.get(x.dtype)
    if not (dev >= 0 and _ok(x, dev) and _ok(keys, dev) and _ok(values, dev)
            and qcode is not None and keys.dtype in _KEY_CODES
            and values.dtype in _VALUE_CODES and keys.shape == (n, kw)
            and kw >= 1 and isinstance(block_b, int) and block_b >= 1
            and max(b * kw, n * kw, n * v, b * v, b + 32) < _LIMIT):
        _diagnose("fastpath_cuda", {"x": x, "keys": keys, "values": values},
                  block_b)
    table = _pack_table(keys.data_ptr(), values.data_ptr(), 0, 0, 0, n, kw,
                        v, 0, _KEY_CODES[keys.dtype],
                        _VALUE_CODES[values.dtype])
    return _launch(x, dev, b, v, values.dtype, table, block_b, 0, qcode,
                   readback)


def fastpath_cuda_prepared(x: torch.Tensor, table: PreparedTable, *,
                           block_b: int = DEFAULT_BLOCK_B,
                           body: str | None = None,
                           readback: MissReadback | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fastpath_cuda` of integer queries ``x`` (any integer dtype)
    against a :class:`PreparedTable` on ``x``'s device: the hashed body for
    a table of at least ``kHashMinKeys`` keys, the dense one below, unless
    ``body`` (one of :data:`BODIES`) names one."""
    refuse_autograd("fastpath_cuda_prepared", table.values)
    dev = x.get_device()
    qcode = _QUERY_CODES.get(x.dtype)
    if not (dev >= 0 and dev == table.device and qcode is not None
            and x.dim() == 2 and x.size(1) == table.kw and x.is_contiguous()
            and isinstance(block_b, int) and block_b >= 1
            and (body is None or body in BODIES)
            and x.size(0) < table.rows):
        if body is not None and body not in BODIES:
            raise ValueError(f"body must be one of {BODIES}, got {body!r}")
        _diagnose("fastpath_cuda_prepared",
                  {"x": x, "keys": table.keys, "values": table.values},
                  block_b)
    code = -1 if body is None else BODIES.index(body)
    return _launch(x, dev, x.size(0), table.v, table.values.dtype,
                   table.packed, block_b, code, qcode, readback)
