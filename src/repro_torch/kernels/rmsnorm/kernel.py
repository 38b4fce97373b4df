"""``ctypes`` wrapper of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``).  The library is
compiled for ``sm_90a`` with ``nvcc`` on first use
(:func:`load_library`); the wrappers check their inputs, allocate the
output, launch on PyTorch's current stream and raise if the launch
reports an error.  ``launches`` counts the kernel launches of this
process.

:func:`rmsnorm_cuda` normalises one tensor, :func:`rmsnorm_pair_cuda` two
tensors of one width in a single launch (a layer's q-norm and k-norm).
A tensor is taken in storage order: its last dimension must be contiguous
and its elements dense (any permutation of a contiguous tensor, such as
the ``einsum`` output the attention projections give), and the output has
its layout, so no copy is made.

A launch is on the decode step's critical path, where the host's part of
it costs more than the device's, so the common case runs one combined
check and reads the current stream through PyTorch's raw-stream call; a
call that fails the check goes through :func:`_diagnose`, which raises the
precise error (of a dtype, shape or size the library lacks:
:func:`unsupported`).
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.common import refuse_autograd

__all__ = ["BLOCK_ROWS", "DEFAULT_BLOCK_ROWS", "SOURCE", "launches",
           "load_library", "reset_launches", "rmsnorm_cuda",
           "rmsnorm_pair_cuda", "row_dense", "unsupported",
           "uses_registers"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

#: warps per thread block the library instantiates (one warp per row in
#: its general body); the serve path uses 4, and other sizes are added when
#: a measurement picks them
BLOCK_ROWS = (4,)
#: warps per thread block when the caller does not choose
DEFAULT_BLOCK_ROWS = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_ROWS = 2 ** 31 - 1

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``rmsnorm_fwd_packed``, set by :func:`load_library`
_fwd = None
#: packs a launch's arguments as the library's ``PairArgs``: x0, w0, out0,
#: rows0, x1, w1, out1, rows1, d, eps, dtype, block_rows, stream (one bytes
#: object through ctypes instead of thirteen converted arguments)
_pack = struct.Struct("<QQQqQQQqqdqqQ").pack
#: the current stream's handle on a device: PyTorch's raw-stream call where
#: this build has it (a CUDA build does), which builds no
#: ``torch.cuda.Stream``
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda dev: torch.cuda.current_stream(dev).cuda_stream)
_F32 = torch.float32


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("rmsnorm", SOURCE)
    if _fwd is None:
        lib.rmsnorm_uses_registers.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int]
        lib.rmsnorm_uses_registers.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        fn = lib.rmsnorm_fwd_packed
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return lib


def row_dense(x: torch.Tensor) -> bool:
    """True if ``x``'s last dimension is contiguous and its elements fill
    ``x.numel()`` consecutive slots of storage (some permutation of its
    leading dimensions is contiguous): its rows can be taken in storage
    order."""
    if x.is_contiguous():
        return True
    if x.ndim == 0 or x.stride(-1) != 1:
        return False
    expected = x.shape[-1]
    dims = sorted((st, sz) for st, sz in zip(x.stride()[:-1], x.shape[:-1])
                  if sz != 1)
    for st, sz in dims:
        if st != expected:
            return False
        expected *= sz
    return True


def _ok(x: torch.Tensor, weight: torch.Tensor, dev: int, d: int) -> bool:
    """The combined check of the common case (see :func:`_diagnose`):
    ``x`` on CUDA device ``dev`` with rows of ``d``."""
    return (dev >= 0 and weight.get_device() == dev
            and x.dtype in _DTYPE_CODES and weight.dtype is _F32
            and weight.dim() == 1 and weight.numel() == d
            and weight.is_contiguous()
            and (x.is_contiguous() or row_dense(x))
            and (x.numel() <= _MAX_ROWS or x.numel() // d <= _MAX_ROWS))


def unsupported(x: torch.Tensor, weight: torch.Tensor, *,
                block_rows: int = DEFAULT_BLOCK_ROWS) -> Exception | None:
    """The error :func:`rmsnorm_cuda` raises on ``x`` and ``weight`` for
    what the library does not instantiate (a dtype other than fp32, bf16
    or fp16 rows and an fp32 weight, a block size, more rows than 32-bit
    indices reach) or for shapes that disagree; None where it takes them.
    Reads dtypes and shapes only, so it runs on the CPU; devices and layout
    are the wrapper's to check."""
    if x.dtype not in _DTYPE_CODES:
        return TypeError(f"rmsnorm_cuda takes float32, bfloat16 or float16, "
                         f"got {x.dtype}")
    if weight.dtype != torch.float32:
        return TypeError(f"weight must be float32, got {weight.dtype}")
    if x.ndim < 1 or weight.shape != x.shape[-1:]:
        return ValueError(f"need x (..., d) and weight (d,), got "
                          f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if block_rows not in BLOCK_ROWS:
        return ValueError(f"block_rows must be one of {BLOCK_ROWS}, got "
                          f"{block_rows}")
    n = x.numel()
    if n > _MAX_ROWS and n // x.size(-1) > _MAX_ROWS:
        return ValueError(f"shape {tuple(x.shape)} exceeds the kernel's "
                          f"32-bit row indices")
    return None


def _diagnose(name: str, x: torch.Tensor, weight: torch.Tensor, dev: int,
              block_rows: int) -> None:
    """Raise the error a call that failed :func:`_ok` on device ``dev``
    (or asked for a block size the library lacks) deserves."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.get_device() != dev:
        raise ValueError(f"{name} normalises tensors of one device; got "
                         f"cuda:{dev} and {x.device}")
    if weight.device != x.device:
        raise ValueError(f"weight on {weight.device}, x on {x.device}")
    err = unsupported(x, weight, block_rows=block_rows)
    if err is not None:
        raise err
    raise ValueError(f"{name} needs a contiguous weight and an x whose last "
                     f"dimension is contiguous and whose elements are "
                     f"dense; got strides {x.stride()}")


def _launch_failed(err: int) -> None:
    msg = load_library().rmsnorm_error_string(err).decode()
    raise RuntimeError(f"rmsnorm launch failed: {msg} ({err})")


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, *,
                 eps: float = 1e-6,
                 block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """RMSNorm over the last dimension of ``x (..., d)`` (fp32, bf16 or
    fp16, on a CUDA device, rows dense: :func:`row_dense`) scaled by
    ``weight (d,)`` (fp32, contiguous, same device).  Returns a new tensor of
    ``x``'s shape, dtype and layout.  Launches on the current stream of
    ``x``'s device (the launch fails and raises if the runtime's current
    device is another)."""
    global launches
    refuse_autograd("rmsnorm_cuda", x, weight)
    dev = x.get_device()
    d = x.size(-1) if x.dim() else 0
    if not (_ok(x, weight, dev, d) and block_rows in BLOCK_ROWS):
        _diagnose("rmsnorm_cuda", x, weight, dev, block_rows)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    if _fwd is None:
        load_library()
    err = _fwd(_pack(x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                     n // d, 0, 0, 0, 0, d, eps, _DTYPE_CODES[x.dtype],
                     block_rows, _stream(dev)))
    if err:
        _launch_failed(err)
    launches += 1
    return out


def rmsnorm_pair_cuda(x0: torch.Tensor, w0: torch.Tensor, x1: torch.Tensor,
                      w1: torch.Tensor, *, eps: float = 1e-6,
                      block_rows: int = DEFAULT_BLOCK_ROWS
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rmsnorm(x0, w0), rmsnorm(x1, w1))`` in one launch: each as
    :func:`rmsnorm_cuda`, both of one dtype, width and device."""
    global launches
    refuse_autograd("rmsnorm_pair_cuda", x0, w0, x1, w1)
    dev = x0.get_device()
    d = x0.size(-1) if x0.dim() else 0
    if not (_ok(x0, w0, dev, d) and block_rows in BLOCK_ROWS):
        _diagnose("rmsnorm_pair_cuda", x0, w0, dev, block_rows)
    if x1.dtype != x0.dtype or (x1.size(-1) if x1.dim() else 0) != d:
        raise ValueError(f"one launch normalises one dtype and width; got "
                         f"{x0.dtype} {tuple(x0.shape)} and {x1.dtype} "
                         f"{tuple(x1.shape)}")
    if not _ok(x1, w1, dev, d):
        _diagnose("rmsnorm_pair_cuda", x1, w1, dev, block_rows)
    n0, n1 = x0.numel(), x1.numel()
    if n0 == 0 or n1 == 0:
        # the kernel's segments must have rows: one launch for the other
        return tuple(rmsnorm_cuda(x, w, eps=eps, block_rows=block_rows)
                     if x.numel() else torch.empty_like(x)
                     for x, w in ((x0, w0), (x1, w1)))
    out0, out1 = torch.empty_like(x0), torch.empty_like(x1)
    if _fwd is None:
        load_library()
    err = _fwd(_pack(x0.data_ptr(), w0.data_ptr(), out0.data_ptr(), n0 // d,
                     x1.data_ptr(), w1.data_ptr(), out1.data_ptr(), n1 // d,
                     d, eps, _DTYPE_CODES[x0.dtype], block_rows,
                     _stream(dev)))
    if err:
        _launch_failed(err)
    launches += 1
    return out0, out1


def uses_registers(x: torch.Tensor, weight: torch.Tensor,
                   out: torch.Tensor | None = None) -> bool:
    """Whether a launch on these tensors takes the register body (one read
    of each row) rather than the general one."""
    lib = load_library()
    out_ptr = x.data_ptr() if out is None else out.data_ptr()
    return bool(lib.rmsnorm_uses_registers(
        x.data_ptr(), weight.data_ptr(), out_ptr, x.shape[-1],
        _DTYPE_CODES[x.dtype]))
