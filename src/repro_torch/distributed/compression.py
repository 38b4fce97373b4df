"""Cross-pod gradient-compression collectives: the port of the reference's
``distributed/compression.py``.

At 1000+ node scale the cross-pod links are the slow tier, so the
data-parallel reduction over the ``pod`` dim is the collective to
compress.  The scheme is an allgather-based int8 reduction:

1. each rank quantizes its partial value to int8 with one fp32 scale;
2. an ``all_gather_into_tensor`` ships the int8 payloads (4x fewer bytes
   on the wire than an fp32 all-reduce ring moves), and a second one the
   fp32 scales;
3. each rank dequantizes and sums locally in fp32.

Combined with the error-feedback state in :mod:`repro_torch.optim.adamw`
(``compress="int8_ef"``) the quantization error is re-injected next step.
The collectives run over the process group of one named dim of a
``DeviceMesh`` (``mesh.get_group(axis)``), the counterpart of the
reference's ``shard_map`` over one mesh axis.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.distributed.sharding import is_dtensor, mesh_shape

__all__ = ["compressed_psum", "compressed_psum_tree"]


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, axis: str, mesh: Any) -> torch.Tensor:
    """The sum over the ``axis`` dim of ``mesh`` of each rank's partial
    value ``x`` (a DTensor gives its local tensor), with int8 on the
    wire.  Returns a plain tensor of ``x``'s shape and dtype, the same on
    every rank of the dim."""
    if is_dtensor(x):
        x = x.to_local()
    n = mesh_shape(mesh)[axis]
    group = mesh.get_group(axis)
    q, scale = _quant(x.to(torch.float32))
    qs = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
    ss = torch.empty((n,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)  # int8
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    deq = qs.reshape((n,) + tuple(q.shape)).to(torch.float32) \
        * ss.reshape((-1,) + (1,) * x.ndim)
    return deq.sum(0).to(x.dtype)


def compressed_psum_tree(tree: Any, axis: str, mesh: Any) -> Any:
    return compat.tree_map(lambda x: compressed_psum(x, axis, mesh), tree)
