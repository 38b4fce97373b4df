"""``ctypes`` wrapper of the hand-written CUDA fast-path matcher
(``csrc/fastpath.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/fastpath/kernel.py::fastpath_lookup_pallas``).  The
library is compiled for ``sm_90a`` with ``nvcc`` on first use
(:func:`load_library`); the wrapper checks its inputs, allocates the
outputs, launches on PyTorch's current stream and raises if the launch
reports an error.  ``launches`` counts the kernel launches of this
process.

``block_b`` (query rows per thread block) is a template argument; the
library instantiates :data:`BLOCK_B`: the reference's default 256, 128,
and the 32 its tests use.  Queries and keys are int32 or int64 (one
type), values float32, bfloat16, int32 or int64.  Integer values are
summed exactly (wrapping) in their own type, float values in fp32 and
rounded once.  A ragged batch is masked in the kernel, never padded.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library

__all__ = ["BLOCK_B", "DEFAULT_BLOCK_B", "MAX_KEY_WIDTH", "SOURCE",
           "fastpath_cuda", "launches", "load_library", "reset_launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastpath.cu"

#: query rows per thread block the library instantiates
BLOCK_B = (32, 128, 256)
#: rows per block when the caller does not choose (the reference's)
DEFAULT_BLOCK_B = 256
#: widest key (integers per key) the kernel takes (kMaxKeyWidth)
MAX_KEY_WIDTH = 32

_KEY_CODES = {torch.int32: 0, torch.int64: 1}
_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
                torch.int64: 3}

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``fastpath_fwd``, set by the first :func:`load_library`
_fwd = None


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("fastpath", SOURCE)
    if _fwd is None:
        fn = lib.fastpath_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fastpath_error_string.argtypes = [ctypes.c_int]
        lib.fastpath_error_string.restype = ctypes.c_char_p
        _fwd = fn
    return lib


def fastpath_cuda(x: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                  *, block_b: int = DEFAULT_BLOCK_B
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Match the rows of ``x (B, K)`` against ``keys (N, K)`` (one integer
    dtype) and sum the rows of ``values (N, V)`` whose keys match, all
    contiguous on one CUDA device.  Returns ``(out (B, V) of
    values.dtype, hit (B,) bool)``; ``out`` rows are 0 where ``hit`` is
    False."""
    global launches
    for name, t in (("x", x), ("keys", keys), ("values", values)):
        if t.device.type != "cuda":
            raise ValueError(f"fastpath_cuda needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fastpath_cuda needs contiguous tensors; "
                             f"{name} is not")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    if x.dtype not in _KEY_CODES or keys.dtype != x.dtype:
        raise TypeError(f"queries and keys must share one dtype of int32 "
                        f"or int64, got {x.dtype} and {keys.dtype}")
    if values.dtype not in _VALUE_CODES:
        raise TypeError(f"values must be float32, bfloat16, int32 or int64, "
                        f"got {values.dtype}")
    b, kw = x.shape
    n, v = values.shape
    if keys.shape != (n, kw):
        raise ValueError(f"keys must be ({n}, {kw}), got "
                         f"{tuple(keys.shape)}")
    if not 1 <= kw <= MAX_KEY_WIDTH:
        raise ValueError(f"key width {kw} outside the kernel's 1..."
                         f"{MAX_KEY_WIDTH}")
    if block_b not in BLOCK_B:
        raise ValueError(f"block_b must be one of {BLOCK_B}, got {block_b}")
    if max(b * kw, n * kw, n * v, b * v) >= 2 ** 31:
        raise ValueError("sizes exceed the kernel's 32-bit indices")
    out = torch.empty((b, v), dtype=values.dtype, device=x.device)
    hit = torch.empty((b,), dtype=torch.bool, device=x.device)
    if b == 0:
        return out, hit
    if _fwd is None:
        load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fwd(x.data_ptr(), keys.data_ptr(), values.data_ptr(),
               out.data_ptr(), hit.data_ptr(), b, n, kw, v,
               _KEY_CODES[x.dtype], _VALUE_CODES[values.dtype],
               int(block_b), stream)
    if err != 0:
        msg = load_library().fastpath_error_string(err).decode()
        raise RuntimeError(f"fastpath_fwd launch failed: {msg} ({err})")
    launches += 1
    return out, hit
