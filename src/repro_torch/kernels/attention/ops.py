"""Public attention op, registry-dispatched.

Input layout is ``(B, H, S, D)``, as in the reference.  Two entries:
``torch_ref`` (the plain version, :mod:`.ref`, with the banded
sliding-window variant) and ``cuda`` (the hand-written flash attention,
:mod:`.kernel`), which flattens (B, H) into the kernel's head dimension
and reads kv head ``h // group`` in the kernel.  The ``cuda`` guard is
the card and the reference's own precondition
(``src/repro/kernels/attention/ops.py::_guard``: 4-D float tensors, kv
heads that group the query heads): any other call (a host tensor, integer
inputs, heads that do not group) misses it and runs ``torch_ref``,
counted in the registry's ``fallback_counts``.  A call that passes it
launches the kernel or raises: what the kernel lacks (d or dv over 256,
an uninstantiated tile) raises in the wrapper (``kernel.unsupported``) and
never runs the plain version.  The
reference's guard also sends sequence lengths that are not a multiple of
the tiles to its plain version; the CUDA kernel masks the ragged edge
tiles instead, so it takes every length and gives the same result.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.attention import kernel, ref
from repro_torch.kernels.attention.kernel import (DEFAULT_BLOCK_KV,
                                                  DEFAULT_BLOCK_Q)

__all__ = ["PROFILE_RANGE", "attention"]

#: the profiler range of every :func:`attention` call
PROFILE_RANGE = "repro_torch::attention"


def _guard(q, k, v, **_kw):
    # The card and the reference's precondition without its tile
    # divisibility (the kernel masks the edge tiles), by attribute reads
    # only.  A CUDA call the kernel cannot take passes and raises in the
    # wrapper.
    return (q.device.type == "cuda" and q.ndim == 4 and k.ndim == 4
            and v.ndim == 4 and q.shape[1] % k.shape[1] == 0
            and q.dtype.is_floating_point and k.dtype.is_floating_point
            and v.dtype.is_floating_point)


@registry.register("attention", "torch_ref", priority=0,
                   description="masked-softmax reference "
                               "(+ banded sliding-window variant)")
def _attention_torch_ref(q, k, v, *, causal, window, scale, q_offset,
                         swa_impl, **_tiles):
    if (swa_impl == "banded" and window is not None and causal
            and q.shape[2] == k.shape[2] and q.shape[2] % window == 0):
        return ref.banded_attention(q, k, v, window=window, scale=scale)
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)


@registry.register("attention", "cuda", priority=20,
                   supports_grad=False, guard=_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="flash attention in CUDA C++ for sm_90a "
                               "(fp32: cp.async chunk ring, register-tiled "
                               "FMA; bf16/fp16: wgmma fed by a TMA producer "
                               "warp; skipped masked tiles)")
def _attention_cuda(q, k, v, *, causal, window, scale, q_offset, block_q,
                    block_kv, swa_impl=None):
    del swa_impl
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    dv = v.shape[-1]
    out = kernel.flash_attention_cuda(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * hk, skv, d).contiguous(),
        v.reshape(b * hk, skv, dv).contiguous(),
        causal=causal, window=window, scale=scale, q_offset=q_offset,
        block_q=block_q, block_kv=block_kv)
    return out.reshape(b, h, sq, dv)


def attention(
    q: torch.Tensor,            # (B, H, Sq, D)
    k: torch.Tensor,            # (B, Hk, Skv, D)
    v: torch.Tensor,            # (B, Hk, Skv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_kv: int = DEFAULT_BLOCK_KV,
    impl: str | None = None,
    swa_impl: str = "full",
) -> torch.Tensor:
    """Dispatch to the ``impl`` entry.  Under an active profiler the call
    is the range :data:`PROFILE_RANGE`, which every mixer's attention
    shares: a profile can tell the plain version's ops (and, through
    their autograd sequence numbers, their backward) from the rest."""
    ranged = (torch.profiler.record_function(PROFILE_RANGE)
              if torch.autograd._profiler_enabled()
              else contextlib.nullcontext())
    with ranged:
        return registry.dispatch(
            "attention", impl, q, k, v, causal=causal, window=window,
            scale=scale, q_offset=q_offset, block_q=block_q,
            block_kv=block_kv, swa_impl=swa_impl)
