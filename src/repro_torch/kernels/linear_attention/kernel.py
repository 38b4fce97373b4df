"""``ctypes`` wrapper of the hand-written CUDA chunked linear attention
(``csrc/linear_attention.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/linear_attention/kernel.py::linear_attention_pallas``).
The library is compiled for ``sm_90a`` with ``nvcc`` on first use
(:func:`load_library`); the wrapper checks its inputs, allocates the
output and the chunk-state workspace with ``torch.empty`` on the inputs'
device (so on the current stream's allocator), makes the library's
three launches (chunk summaries, the fold of the chunk states, the chunk
outputs) on PyTorch's current stream and raises if one reports an error.
``launches`` counts the calls of this process (one per call, whatever the
CUDA launches behind it).

The computation is chunk-parallel, in the order of the port's plain
version (:mod:`.chunk_math`): every chunk's summary in parallel, the
states entering each chunk folded in chunk order, then every chunk's
output in parallel.  ``chunk`` (the ``chunk_len`` spec point) is a
template argument: the library instantiates :data:`CHUNKS`, the
reference's candidates.  Head dims up to :data:`MAX_HEAD_DIM` (dk) and
:data:`MAX_VALUE_HEAD_DIM` (dv) are runtime values: each block computes a
slice of 128 dv columns, and the output launch stages 128 key columns at
a time.  A ragged length (not a multiple of the chunk) is masked in the
kernel.  q, k and v of mixed dtypes (each fp32, bf16 or fp16) run on fp32
copies (exact widenings), as the reference's Pallas kernel casts each to
fp32; the kernel stores the output in v's dtype either way.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.common import refuse_autograd

__all__ = ["CHUNKS", "MAX_HEAD_DIM", "MAX_VALUE_HEAD_DIM", "SOURCE",
           "launches", "load_library", "linear_attention_cuda",
           "reset_launches", "unsupported", "workspace_floats"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_attention.cu"

#: chunk lengths the library instantiates (the reference's candidates)
CHUNKS = (16, 32, 64)
#: largest key head dim (dk) the kernel takes (GLA-1.3B's 256)
MAX_HEAD_DIM = 256
#: largest value head dim (dv) the kernel takes (GLA-1.3B's 512)
MAX_VALUE_HEAD_DIM = 512

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``linear_attention_fwd``, set by :func:`load_library`
_fwd = None


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("linear_attention", SOURCE)
    if _fwd is None:
        fn = lib.linear_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.linear_attention_error_string.argtypes = [ctypes.c_int]
        lib.linear_attention_error_string.restype = ctypes.c_char_p
        _fwd = fn
    return lib


def workspace_floats(bh: int, t_len: int, dk: int, dv: int,
                     chunk: int) -> int:
    """fp32 values of workspace a call takes: the state entering each chunk
    (``bh x n_chunks x dk x dv``) and each chunk's total log decay
    (``bh x n_chunks x dk``)."""
    return bh * -(-t_len // chunk) * dk * (dv + 1)


def unsupported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, bonus: torch.Tensor | None = None, *,
                inclusive: bool = False, chunk: int = 64) -> Exception | None:
    """The error :func:`linear_attention_cuda` raises on these arguments
    for what the library does not instantiate (q, k or v of a dtype other
    than fp32, bf16 or fp16, each its own; ``log_w`` and ``bonus`` not
    fp32; head dims over :data:`MAX_HEAD_DIM` / :data:`MAX_VALUE_HEAD_DIM`;
    a chunk outside :data:`CHUNKS`; a bonus on the inclusive recurrence;
    grids and indices past their limits) or for shapes that disagree; None
    where it takes them.  Reads dtypes and shapes only, so it runs on the
    CPU; devices and layout are the wrapper's to check."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPE_CODES:
            return TypeError(f"linear_attention_cuda takes float32, "
                             f"bfloat16 or float16, {name} is {t.dtype}")
    for name, t in (("log_w", log_w), ("bonus", bonus)):
        if t is not None and t.dtype != torch.float32:
            return TypeError(f"{name} is {t.dtype}, wanted "
                             f"{torch.float32}")
    if q.ndim != 3 or v.ndim != 3:
        return ValueError(f"q and v must be 3-D (heads, seq, dim), got "
                          f"{tuple(q.shape)}, {tuple(v.shape)}")
    bh, t_len, dk = q.shape
    dv = v.shape[2]
    if (k.shape != q.shape or log_w.shape != q.shape
            or v.shape[:2] != (bh, t_len)):
        return ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                          f"{tuple(v.shape)} and log_w {tuple(log_w.shape)} "
                          f"do not agree")
    if bonus is not None:
        if bonus.shape != (bh, dk):
            return ValueError(f"bonus must be ({bh}, {dk}), got "
                              f"{tuple(bonus.shape)}")
        if inclusive:
            return ValueError("a bonus is defined for the exclusive "
                              "recurrence only (the reference's oracle "
                              "ignores it when inclusive)")
    if dk > MAX_HEAD_DIM or dv > MAX_VALUE_HEAD_DIM:
        return ValueError(f"head dims ({dk}, {dv}) exceed the kernel's "
                          f"({MAX_HEAD_DIM}, {MAX_VALUE_HEAD_DIM})")
    if chunk not in CHUNKS:
        return ValueError(f"chunk must be in {CHUNKS}, got {chunk}")
    if bh * -(-t_len // chunk) >= 2 ** 31 or max(
            q.numel(), v.numel(), workspace_floats(bh, t_len, dk, dv,
                                                   chunk)) >= 2 ** 31:
        return ValueError(f"(bh, T) = ({bh}, {t_len}) exceed the kernel's "
                          f"grid or 32-bit index range")
    return None


def linear_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_w: torch.Tensor,
                          bonus: torch.Tensor | None = None, *,
                          inclusive: bool = False,
                          chunk: int = 64) -> torch.Tensor:
    """Chunked gated linear attention of ``q, k (BH, T, dk)`` and
    ``v (BH, T, dv)`` (each fp32, bf16 or fp16) with the per-step log
    decay ``log_w (BH, T, dk)`` and the RWKV bonus ``bonus (BH, dk)`` or
    None (both fp32), all contiguous on one CUDA device.  Returns a new
    ``(BH, T, dv)`` tensor of ``v.dtype``."""
    global launches
    refuse_autograd("linear_attention_cuda", q, k, v, log_w, bonus)
    for name, t in (("q", q), ("k", k), ("v", v), ("log_w", log_w),
                    ("bonus", bonus)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"linear_attention_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"linear_attention_cuda needs contiguous "
                             f"tensors; {name} is not")
    err = unsupported(q, k, v, log_w, bonus, inclusive=inclusive,
                      chunk=chunk)
    if err is not None:
        raise err
    bh, t_len, dk = q.shape
    dv = v.shape[2]
    out = torch.empty((bh, t_len, dv), dtype=v.dtype, device=v.device)
    if bh == 0 or t_len == 0:
        return out
    work = torch.empty(workspace_floats(bh, t_len, dk, dv, chunk),
                       dtype=torch.float32, device=v.device)
    if not q.dtype == k.dtype == v.dtype:
        q, k, v = (t.to(torch.float32) for t in (q, k, v))
    if _fwd is None:
        load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
               bonus.data_ptr() if bonus is not None else None,
               out.data_ptr(), work.data_ptr(), bh, t_len, dk, dv, int(chunk),
               int(inclusive), _DTYPE_CODES[q.dtype],
               _DTYPE_CODES[out.dtype], stream)
    if err != 0:
        msg = load_library().linear_attention_error_string(err).decode()
        raise RuntimeError(f"linear_attention_fwd launch failed: {msg} "
                           f"({err})")
    launches += 1
    return out
