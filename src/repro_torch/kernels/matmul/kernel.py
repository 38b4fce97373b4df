"""``ctypes`` wrapper of the hand-written CUDA blocked matmul
(``csrc/matmul.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/matmul/kernel.py::matmul_pallas``).  The library is
compiled for ``sm_90a`` with ``nvcc`` on first use (:func:`load_library`);
the wrapper checks its inputs, allocates the output, launches on
PyTorch's current stream and raises if the launch reports an error.
``launches`` counts the kernel launches of this process.

The tile triple ``(bm, bn, bk)`` — the paper's block size ``B`` — is a
template argument, so each triple is its own compiled kernel, and so is
``assume_divisible`` (no edge masks).  :data:`TILES` lists the triples
the library instantiates:

* every triple the reference's tests run: (32, 16, 8)
  (``tests/test_kernels.py:34``), (16, 16, 16), (32, 64, 32) and
  (64, 32, 8) (``:41``), (16, 16, 16) (``:52`` and
  ``tests/test_kernel_registry.py:124``);
* :data:`CARD_TILES`, the tiles a card-sized product wants.

The library picks one of three bodies per call (:func:`body`): at the
card tiles an fp32 product runs the cp.async-pipelined FMA body (16-byte
copies where x, y and the output have 16-byte-aligned rows, 4-byte
copies otherwise) and a bf16 or fp16 product the ``wgmma`` body fed by
TMA (where x and y have 16-byte-aligned rows, k and n multiples of 8);
the reference's test tiles, and half operands TMA cannot take, run the
simt body.  Every body writes fp32, bf16 or fp16, whatever the operands'
dtype (``out_dtype``, default x's).  Operands of two dtypes are widened
to fp32 here, as ``jnp.dot`` promotes them, and take the fp32 bodies:
every product of bf16 and fp16 values is exact in fp32, so the result is
the plain version's.  fp64 operands are not instantiated (the reference's
kernel has no fp64 on its chip either).  Every call on the card launches
the kernel: none falls back to the plain version.

The reference's defaults of 128 to 512 a side are TPU VMEM tiles and do
not all carry over.  The fp32 body keeps an 8 x 8 output tile a thread
in registers (at most 512 threads), so its tiles stop at (128, 256); the
``wgmma`` body keeps 64 x bn accumulators a warpgroup, bn at most 256.
The default (:data:`DEFAULT_TILES`) is (128, 128, 16).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.common import refuse_autograd

__all__ = ["BODIES", "CARD_TILES", "DEFAULT_TILES", "SOURCE", "TEST_TILES",
           "TILES", "body", "launches", "load_library", "matmul_cuda",
           "reset_launches", "unsupported"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"

#: the reference's test tiles (tests/test_kernels.py:28-55)
TEST_TILES = ((16, 16, 16), (32, 16, 8), (32, 64, 32), (64, 32, 8))
#: larger tiles for the card's shapes (the Table-1 handler's candidates),
#: each run by the fp32 body in fp32 and by the wgmma body in bf16 and fp16
CARD_TILES = ((64, 64, 16), (128, 64, 16), (128, 128, 16), (128, 128, 32),
              (128, 128, 64), (128, 256, 64))
#: every (bm, bn, bk) the library instantiates
TILES = TEST_TILES + CARD_TILES
#: tiles when the caller does not choose
DEFAULT_TILES = (128, 128, 16)

#: the library's bodies, by the code ``matmul_body`` returns
BODIES = ("simt", "fp32_cp_async16", "fp32_cp_async4", "wgmma")

#: the operand and output dtypes the library takes, by its codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``matmul_fwd``, set by the first :func:`load_library`
_fwd = None


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("matmul", SOURCE)
    if _fwd is None:
        fn = lib.matmul_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.matmul_body.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 8)
        lib.matmul_body.restype = ctypes.c_int
        lib.matmul_error_string.argtypes = [ctypes.c_int]
        lib.matmul_error_string.restype = ctypes.c_char_p
        _fwd = fn
    return lib


def unsupported(x: torch.Tensor, y: torch.Tensor, *,
                bm: int = DEFAULT_TILES[0], bn: int = DEFAULT_TILES[1],
                bk: int = DEFAULT_TILES[2],
                out_dtype: torch.dtype | None = None,
                assume_divisible: bool = False) -> Exception | None:
    """The error :func:`matmul_cuda` raises on ``x`` and ``y`` for what the
    library does not instantiate (operands or an output other than fp32,
    bf16 and fp16, fp64 among them; a tile triple outside :data:`TILES`;
    the grid's and 32-bit limits), for shapes that disagree or, under
    ``assume_divisible``, that the tiles do not divide; None where it takes
    them.  Reads dtypes and shapes only, so it runs on the CPU; devices and
    layout are the wrapper's to check."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        return ValueError(f"need x (m, k) and y (k, n), got "
                          f"{tuple(x.shape)} and {tuple(y.shape)}")
    out_dtype = out_dtype or x.dtype
    for what, dtype in (("x", x.dtype), ("y", y.dtype), ("out", out_dtype)):
        if dtype not in _DTYPE_CODES:
            return TypeError(f"matmul_cuda takes float32, bfloat16 and "
                             f"float16 operands and outputs, {what} is "
                             f"{dtype}")
    tiles = (int(bm), int(bn), int(bk))
    if tiles not in TILES:
        return ValueError(f"tiles {tiles} are not instantiated; the library "
                          f"has {TILES}")
    m, k = x.shape
    n = y.shape[1]
    if assume_divisible and (m % bm or n % bn or k % bk):
        return ValueError(f"assume_divisible: shape ({m},{k})x({k},{n}) is "
                          f"not a multiple of the tiles {tiles}")
    if max(m, n, k) >= 2 ** 31 or -(-m // bm) > 65535:
        return ValueError(f"shape ({m},{k})x({k},{n}) exceeds the kernel's "
                          f"grid or 32-bit sizes")
    return None


def matmul_cuda(x: torch.Tensor, y: torch.Tensor, *,
                bm: int = DEFAULT_TILES[0], bn: int = DEFAULT_TILES[1],
                bk: int = DEFAULT_TILES[2],
                out_dtype: torch.dtype | None = None,
                assume_divisible: bool = False) -> torch.Tensor:
    """``x (m, k) @ y (k, n)`` with an fp32 accumulator, for contiguous
    fp32, bf16 or fp16 operands on one CUDA device (any storage offset);
    operands of two dtypes are widened to fp32 first.  ``out_dtype`` (fp32,
    bf16 or fp16) defaults to x's.  ``assume_divisible`` runs the
    instantiation without bounds checks and raises unless the shape is a
    multiple of the tiles.  Returns a new ``(m, n)`` tensor."""
    global launches
    refuse_autograd("matmul_cuda", x, y)
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda":
            raise ValueError(f"matmul_cuda needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"matmul_cuda needs contiguous tensors; {name} "
                             f"is not")
    if y.device != x.device:
        raise ValueError(f"y on {y.device}, x on {x.device}")
    err = unsupported(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                      assume_divisible=assume_divisible)
    if err is not None:
        raise err
    out_dtype = out_dtype or x.dtype
    tiles = (int(bm), int(bn), int(bk))
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if x.dtype != y.dtype:
        # as jnp.dot promotes them: exact, the products of narrow values
        # fit fp32
        x, y = x.float(), y.float()
    if _fwd is None:
        load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
               *tiles, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
               int(bool(assume_divisible)), stream)
    if err != 0:
        msg = load_library().matmul_error_string(err).decode()
        raise RuntimeError(f"matmul_fwd launch failed: {msg} ({err})")
    launches += 1
    return out


def body(x: torch.Tensor, y: torch.Tensor, *, bm: int = DEFAULT_TILES[0],
         bn: int = DEFAULT_TILES[1], bk: int = DEFAULT_TILES[2],
         out_dtype: torch.dtype | None = None) -> str:
    """The body (:data:`BODIES`) :func:`matmul_cuda` runs for these
    operands and tiles (its fresh output, and the fresh fp32 copies of
    operands of two dtypes, are 16-byte aligned)."""
    lib = load_library()
    out_dtype = out_dtype or x.dtype
    m, k = x.shape
    mixed = x.dtype != y.dtype
    code = lib.matmul_body(
        0 if mixed else x.data_ptr(), 0 if mixed else y.data_ptr(), 0, m,
        y.shape[1], k, bm, bn, bk,
        _DTYPE_CODES[torch.float32 if mixed else x.dtype],
        _DTYPE_CODES[out_dtype])
    if code < 0:
        raise ValueError(f"no instantiation for tiles ({bm}, {bn}, {bk}) "
                         f"and {x.dtype} -> {out_dtype}")
    return BODIES[code]
