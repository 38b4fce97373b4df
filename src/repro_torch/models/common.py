"""Shared model components: norms, rope, swiglu, initializers."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.kernel import DEFAULT_BLOCK_ROWS

__all__ = ["KernelOptions", "rms_norm", "rope", "apply_rope", "swiglu",
           "dense_init", "embed_init"]


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    """Per-step kernel configuration — populated from Iridescent spec points.

    These are the constants the specializer bakes into each variant: the
    kernel implementation choices and the kernels' tile shapes.

    ``impl`` is the step-wide implementation choice (a registry entry name —
    ``torch_ref`` | ``cuda`` — with the reference's ``xla``/``pallas_*``
    spellings accepted as aliases; ``None`` = registry auto).  The
    per-family ``*_impl`` fields override it for one kernel family — each
    is its own spec point.  ``norm_block_rows`` is the RMSNorm kernel's
    rows per thread block.  The other kernel families' fields arrive with
    their kernels (ROADMAP K2-K5).
    """

    impl: str | None = None          # step-wide default (None = auto)
    rmsnorm_impl: str | None = None
    norm_block_rows: int = DEFAULT_BLOCK_ROWS

    def impl_for(self, family: str) -> str | None:
        """The effective impl choice for one kernel family (families the
        model step does not route per-family fall through to ``impl``)."""
        return getattr(self, f"{family}_impl", None) or self.impl


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             opts: KernelOptions | None = None) -> torch.Tensor:
    opts = opts or KernelOptions()
    return rmsnorm_kernel.rmsnorm(x, weight, eps=eps,
                                  block_rows=opts.norm_block_rows,
                                  impl=opts.impl_for("rmsnorm"))


def rope(positions: torch.Tensor, dim: int, theta: float = 1e4,
         dtype: torch.dtype = torch.float32
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding tables. positions (...,) -> cos/sin (..., dim/2)."""
    if dim % 2:
        raise ValueError(f"rope needs an even dim, got {dim}")
    half = dim // 2
    exponents = -torch.arange(half, dtype=torch.float32,
                              device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exponents)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, D) with cos/sin (S, D/2) (or broadcastable)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos.to(x1.dtype)
    sin = sin.to(x1.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: silu(x@Wg) * (x@Wu) @ Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def dense_init(gen: torch.Generator, shape: tuple, in_axis: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, fan_in^-1/2) weights, on the generator's device."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: tuple,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)
