"""``ctypes`` wrapper of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``).  The library is
compiled for ``sm_90a`` with ``nvcc`` on first use
(:func:`load_library`); the wrapper checks its inputs, allocates the
output, launches on PyTorch's current stream and raises if the launch
reports an error.  ``launches`` counts the kernel launches of this
process.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library

__all__ = ["BLOCK_ROWS", "DEFAULT_BLOCK_ROWS", "SOURCE", "launches",
           "load_library", "reset_launches", "rmsnorm_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

#: rows per thread block the library instantiates (one warp per row); the
#: serve path uses 4, and other sizes are added when a measurement picks them
BLOCK_ROWS = (4,)
#: rows per thread block when the caller does not choose
DEFAULT_BLOCK_ROWS = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``rmsnorm_fwd``, set by the first :func:`load_library`
_fwd = None


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("rmsnorm", SOURCE)
    if _fwd is None:
        fn = lib.rmsnorm_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _fwd = fn
    return lib


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, *,
                 eps: float = 1e-6,
                 block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """RMSNorm of the rows of ``x (rows, d)`` (fp32 or bf16, contiguous, on
    a CUDA device) scaled by ``weight (d,)`` (fp32, same device).  Returns a
    new ``(rows, d)`` tensor of ``x.dtype``."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_cuda needs a CUDA tensor, got {x.device}")
    if weight.device != x.device:
        raise ValueError(f"weight on {weight.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm_cuda takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"weight must be float32, got {weight.dtype}")
    if x.ndim != 2 or weight.shape != (x.shape[1],):
        raise ValueError(f"need x (rows, d) and weight (d,), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and weight")
    if block_rows not in BLOCK_ROWS:
        raise ValueError(f"block_rows must be one of {BLOCK_ROWS}, "
                         f"got {block_rows}")
    rows, d = x.shape
    if rows >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's "
                         f"32-bit row/column indices")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if _fwd is None:
        load_library()
    # Launches on x's device's current stream; if the runtime's current
    # device is another, the launch fails and raises below.
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fwd(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
               float(eps), _DTYPE_CODES[x.dtype], int(block_rows), stream)
    if err != 0:
        msg = load_library().rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_fwd launch failed: {msg} ({err})")
    launches += 1
    return out
