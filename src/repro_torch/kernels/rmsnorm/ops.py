"""Public RMSNorm op (any leading batch dims), registry-dispatched.

Two entries: ``torch_ref`` (the plain version, :mod:`.ref`) and ``cuda``
(the hand-written kernel, :mod:`.kernel`).  A tensor on the CPU that asks
for ``cuda`` misses the guard and runs ``torch_ref``, counted in the
registry's ``fallback_counts``; a CUDA tensor that reaches ``cuda`` launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.rmsnorm import kernel, ref
from repro_torch.kernels.rmsnorm.kernel import DEFAULT_BLOCK_ROWS

__all__ = ["rmsnorm"]


def _guard(x, weight, **_kw):
    # Decides by device only: a CUDA tensor the kernel cannot take (a
    # dtype other than fp32/bf16, a mismatched weight) reaches the wrapper
    # and raises there, never the plain version.
    return x.device.type == "cuda"


@registry.register("rmsnorm", "torch_ref", priority=0,
                   description="plain PyTorch rmsnorm (the numerical oracle)")
def _rmsnorm_torch_ref(x, weight, *, eps=1e-6,
                       block_rows=DEFAULT_BLOCK_ROWS):
    del block_rows
    return ref.rmsnorm(x, weight, eps)


@registry.register("rmsnorm", "cuda", priority=20,
                   supports_grad=False, guard=_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="one-warp-per-row CUDA rmsnorm for sm_90a")
def _rmsnorm_cuda(x, weight, *, eps=1e-6, block_rows=DEFAULT_BLOCK_ROWS):
    shape = x.shape
    out = kernel.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                              weight.to(torch.float32).contiguous(),
                              eps=eps, block_rows=block_rows)
    return out.reshape(shape)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = DEFAULT_BLOCK_ROWS,
            impl: str | None = None) -> torch.Tensor:
    return registry.dispatch("rmsnorm", impl, x, weight, eps=eps,
                             block_rows=block_rows)
