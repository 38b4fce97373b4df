"""Public chunked linear-attention op, registry-dispatched.

Layout ``(BH, T, ·)``, as in the reference.  Two entries: ``torch_ref``
(the plain version, :mod:`.ref`) and ``cuda`` (the hand-written kernel,
:mod:`.kernel`).  The ``cuda`` guard is the card and the reference's own
precondition (``src/repro/kernels/linear_attention/ops.py::_guard``: 3-D
float inputs): any other call (a host tensor, integer inputs) misses it
and runs ``torch_ref``, counted in the registry's ``fallback_counts``.  A
call that passes it launches the kernel or raises: what the kernel lacks
(dk over 256 or dv over 512, a chunk the library lacks) raises in the
wrapper (``kernel.unsupported``) and never runs the plain version.  The
reference's guard also sends a length that is not a multiple of the chunk
to its plain version; the CUDA kernel masks the ragged tail instead, so
it takes every length and gives the same result.
"""
from __future__ import annotations

import math

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.linear_attention import kernel, ref

__all__ = ["linear_attention"]


def _guard(q, k, v, log_w, **_kw):
    # The card and the reference's precondition without its chunk
    # divisibility (the kernel masks the tail), by attribute reads only.
    # A CUDA call the kernel cannot take passes and raises in the wrapper.
    return (q.device.type == "cuda" and q.ndim == 3 and k.ndim == 3
            and v.ndim == 3 and q.dtype.is_floating_point)


@registry.register("linear_attention", "torch_ref", priority=0,
                   description="chunked formulation, chunk states folded "
                               "by a loop (the numerical oracle)")
def _linatt_torch_ref(q, k, v, log_w, *, bonus=None, inclusive=False,
                      chunk=64):
    # The fallback target must accept any input: clamp the chunk length to
    # a divisor of T, as the reference's _linatt_xla_ref does.
    t = q.shape[1]
    c = math.gcd(t, min(chunk, t)) if t else 1
    return ref.linear_attention(q, k, v, log_w, bonus=bonus,
                                inclusive=inclusive, chunk=c)


@registry.register("linear_attention", "cuda", priority=20,
                   supports_grad=False, guard=_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="chunked linear attention in CUDA C++ for "
                               "sm_90a (chunk-parallel: summaries, state "
                               "fold, outputs)")
def _linatt_cuda(q, k, v, log_w, *, bonus=None, inclusive=False, chunk=64):
    return kernel.linear_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        log_w.to(torch.float32).contiguous(),
        bonus.to(torch.float32).contiguous() if bonus is not None else None,
        inclusive=inclusive, chunk=_kernel_chunk(chunk, q.shape[1]))


def _kernel_chunk(chunk: int, t: int) -> int:
    """The instantiated chunk that computes what ``chunk`` asks: ``chunk``
    itself, or, where one chunk spans the whole sequence (``chunk >= T``:
    the models pass ``min(chunk_len, T)``, so a short input asks for
    ``T``), the smallest instantiated chunk that spans it, whose masked
    tail leaves the same single-chunk computation.  Any other chunk goes
    to the wrapper, which raises."""
    if chunk in kernel.CHUNKS or chunk < t:
        return chunk
    return next((c for c in kernel.CHUNKS if c >= t), chunk)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, *,
                     bonus: torch.Tensor | None = None,
                     inclusive: bool = False, chunk: int = 64,
                     impl: str | None = None) -> torch.Tensor:
    """q/k (BH,T,dk), v (BH,T,dv), log_w (BH,T,dk) or (BH,T,1),
    bonus (BH,dk)|None -> (BH,T,dv)."""
    log_w = log_w.expand(q.shape)
    return registry.dispatch("linear_attention", impl, q, k, v, log_w,
                             bonus=bonus, inclusive=inclusive, chunk=chunk)
