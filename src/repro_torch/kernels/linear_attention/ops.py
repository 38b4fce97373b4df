"""Public chunked linear-attention op, registry-dispatched.

Layout ``(BH, T, ·)``, as in the reference.  Two entries: ``torch_ref``
(the plain version, :mod:`.ref`) and ``cuda`` (the hand-written kernel,
:mod:`.kernel`).  A tensor on the CPU that asks for ``cuda`` misses the
guard and runs ``torch_ref``, counted in the registry's
``fallback_counts``; a CUDA tensor that reaches ``cuda`` launches the
kernel or raises.  The reference's guard also sends a length that is not a
multiple of the chunk to its plain version; the CUDA kernel masks the
ragged tail instead, so it takes every length.
"""
from __future__ import annotations

import math

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.linear_attention import kernel, ref

__all__ = ["linear_attention"]


def _guard(q, k, v, log_w, **_kw):
    # Decides by device only: a CUDA tensor the kernel cannot take (a
    # dtype other than fp32/bf16, a head dim over 128, a chunk the library
    # lacks) reaches the wrapper and raises there, never the plain version.
    return q.device.type == "cuda"


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
