"""``ctypes`` wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/attention/kernel.py::flash_attention_pallas``).  The
library is compiled for ``sm_90a`` with ``nvcc`` on first use
(:func:`load_library`); the wrapper checks its inputs, allocates the
output, launches on PyTorch's current stream and raises if the launch
reports an error.  ``launches`` counts the kernel launches of this
process.

Two bodies (:func:`body` says which a call runs): fp32 inputs take the
ring body, which streams each kv tile through a ``cp.async`` ring of
shared-memory chunks while register-tiled FMA products run on the oldest;
bf16 and fp16 inputs take the wgmma body, whose two products run on the
tensor cores (``wgmma``, fp32 accumulators) over K/V tiles that a
producer warp brings in by TMA (by copies where rows are not 16-byte
aligned) ahead of the consumer warpgroups, with the probabilities
rounded to the input dtype before the P.V product, as the reference's
Pallas kernel rounds them to v's dtype.

q, k and v of mixed dtypes (any of fp32, bf16, fp16 each) take the ring
body on fp32 copies (exact widenings), with the library's two runtime
codes set as the Pallas kernel computes: S in fp32 from the promoted
inputs, P rounded to v's dtype before P.V, the output stored in q's
dtype, both in the kernel.  A call whose three inputs share a dtype runs
on them as they are.  ``window`` is any integer (the Pallas kernel keeps
column c of row r where c > r - window, so a window <= 0 keeps no past
column; rows left with none get 0), passed to the library beside a flag
that says whether there is one.

Tile sizes.  ``block_q`` x ``block_kv`` are template arguments of the
kernel, and the library instantiates ``BLOCK_Q`` x ``BLOCK_KV``, each at
every head dim up to ``MAX_HEAD_DIM`` (q, k) and ``MAX_VALUE_HEAD_DIM``
(v), padded to (64, 64), (128, 128), (192, 128) or (256, 256).  The
reference's candidates (128-1024 rows) are sized for a TPU core's
megabytes of VMEM; on Hopper a thread block has at most 227 KB of shared
memory, which the ring body's fp32 q tile, probabilities and chunk ring
must share: (128, 64) at d = 256 takes 224 KB (the wgmma body's
half-precision q tile and two K/V stages 193 KB), while a (1024, 1024)
tile pair would need megabytes.  Any other size raises.  On the card's
qwen3 prefill shape the wgmma body is fastest at (64, 64) or (128, 64)
in half precision, the ring body at (64, 64) in fp32 (PERF.md).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.common import refuse_autograd

__all__ = ["BLOCK_Q", "BLOCK_KV", "BODIES", "DEFAULT_BLOCK_Q",
           "DEFAULT_BLOCK_KV", "MAX_HEAD_DIM", "MAX_VALUE_HEAD_DIM", "SOURCE",
           "body", "flash_attention_cuda", "launches", "load_library",
           "reset_launches", "unsupported"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: query rows per thread block the library instantiates (2 x rows threads)
BLOCK_Q = (64, 128)
#: kv rows per staged tile the library instantiates
BLOCK_KV = (32, 64)
#: the pair measured fastest at the full-width prefill shapes on an H100
#: (``chip_smoke.py``'s attention phase; numbers in PERF.md)
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_KV = 64
#: largest head dim of q and k (d) the kernel takes (Gemma's 256)
MAX_HEAD_DIM = 256
#: largest head dim of v (dv) the kernel takes
MAX_VALUE_HEAD_DIM = 256
#: the bodies :func:`body` names, by the library's code
BODIES = ("ring", "wgmma")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_GRID_Y = 65535
_MAX_BLOCKS = 2 ** 31 - 1

#: kernel launches in this process (see :func:`reset_launches`)
launches = 0

#: the library's bound ``flash_attention_fwd``, set by :func:`load_library`
_fwd = None


def reset_launches() -> None:
    global launches
    launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; declare its C
    signatures.  Raises if the build fails."""
    global _fwd
    lib = load_cuda_library("flash_attention", SOURCE)
    if _fwd is None:
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_body.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2)
        lib.flash_attention_body.restype = ctypes.c_int
        _fwd = fn
    return lib


def body(dtype: torch.dtype, d: int, dv: int, *,
         block_q: int = DEFAULT_BLOCK_Q,
         block_kv: int = DEFAULT_BLOCK_KV) -> dict:
    """The body (:data:`BODIES`) a call at these dims and tiles runs, its
    shared memory a block (bytes) and its stages (the ring body's chunk
    stages, the wgmma body's K/V tile stages)."""
    smem, stages = ctypes.c_int(0), ctypes.c_int(0)
    code = load_library().flash_attention_body(
        _DTYPE_CODES[dtype], block_q, block_kv, d, dv, ctypes.byref(smem),
        ctypes.byref(stages))
    if code < 0:
        raise ValueError(f"no instantiation for {dtype} at (d, dv) = "
                         f"({d}, {dv}), tiles ({block_q}, {block_kv})")
    return {"body": BODIES[code], "smem_bytes": smem.value,
            "stages": stages.value}


def unsupported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int | None = None, block_q: int = DEFAULT_BLOCK_Q,
                block_kv: int = DEFAULT_BLOCK_KV) -> Exception | None:
    """The error :func:`flash_attention_cuda` raises on ``q``, ``k``,
    ``v`` for what the library does not instantiate (a dtype other than
    fp32, bf16 or fp16, head dims over :data:`MAX_HEAD_DIM` /
    :data:`MAX_VALUE_HEAD_DIM`, a tile pair outside :data:`BLOCK_Q` x
    :data:`BLOCK_KV`, grids and indices past their limits) or for shapes
    that disagree; None where it takes them (mixed dtypes and any integer
    ``window`` included).  Reads dtypes and shapes only, so it runs on the
    CPU; devices and layout are the wrapper's to check."""
    del window
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 3:
            return ValueError(f"{name} must be 3-D (heads, seq, dim), got "
                              f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            return TypeError(f"flash_attention_cuda takes float32, bfloat16 "
                             f"or float16, {name} is {t.dtype}")
    bh, sq, d = q.shape
    bhk, skv, dk = k.shape
    dv = v.shape[2]
    if dk != d or v.shape[:2] != (bhk, skv):
        return ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                          f"{tuple(v.shape)} do not agree")
    if bhk == 0 or bh % bhk:
        return ValueError(f"{bh} query heads do not group over {bhk} kv "
                          f"heads")
    if d > MAX_HEAD_DIM or dv > MAX_VALUE_HEAD_DIM:
        return ValueError(f"head dims ({d}, {dv}) exceed the kernel's "
                          f"({MAX_HEAD_DIM}, {MAX_VALUE_HEAD_DIM})")
    if block_q not in BLOCK_Q or block_kv not in BLOCK_KV:
        return ValueError(f"(block_q, block_kv) must be in {BLOCK_Q} x "
                          f"{BLOCK_KV}, got ({block_q}, {block_kv})")
    if (bh > _MAX_GRID_Y or bh * -(-sq // block_q) > _MAX_BLOCKS
            or max(q.numel(), k.numel(), v.numel(), bh * sq * dv) >= 2 ** 31):
        return ValueError(f"shapes {tuple(q.shape)}, {tuple(v.shape)} "
                          f"exceed the kernel's grid or 32-bit index range")
    return None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None,
                         q_offset: int | None = None,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """Attention of ``q (BH, Sq, D)`` over ``k (BHk, Skv, D)`` and
    ``v (BHk, Skv, Dv)`` (each fp32, bf16 or fp16, contiguous, on one CUDA
    device); q head ``bh`` reads kv head ``bh // (BH // BHk)``.  Returns a
    new ``(BH, Sq, Dv)`` tensor of ``q.dtype``.  Ragged lengths need no
    padding: the kernel masks the edge tiles."""
    global launches
    refuse_autograd("flash_attention_cuda", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda needs contiguous "
                             f"tensors; {name} is not")
    err = unsupported(q, k, v, window=window, block_q=block_q,
                      block_kv=block_kv)
    if err is not None:
        raise err
    bh, sq, d = q.shape
    bhk, skv, _ = k.shape
    dv = v.shape[2]
    scale = scale if scale is not None else d ** -0.5
    q_offset = q_offset if q_offset is not None else skv - sq
    if window is not None:
        # Past +-(sq + skv + |q_offset|) a window keeps every past column or
        # none, as at the bound: the clamp keeps the kernel's int arithmetic
        # in range and changes no mask.
        reach = sq + skv + abs(int(q_offset))
        window = max(-reach, min(reach, int(window)))
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    if skv == 0:
        return out.zero_()
    p_round = _DTYPE_CODES[v.dtype]      # P is rounded to v's dtype
    if not q.dtype == k.dtype == v.dtype:
        q, k, v = (t.to(torch.float32) for t in (q, k, v))
    if _fwd is None:
        load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               bh, sq, skv, d, dv, bh // bhk, float(scale), int(causal),
               int(window is not None), int(window or 0), int(q_offset),
               _DTYPE_CODES[q.dtype], p_round,
               _DTYPE_CODES[out.dtype], int(block_q), int(block_kv), stream)
    if err != 0:
        msg = load_library().flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} "
                           f"({err})")
    launches += 1
    return out
