"""Logical-axis sharding: the bridge between model code and the mesh.

The port of the reference's ``distributed/sharding.py``.  Model code
annotates tensors with *logical* axis names ("batch", "embed", "heads",
"experts", ...).  A :class:`ShardingRules` table maps logical names to
physical mesh dims (``pod`` / ``data`` / ``model``).  Swapping the rules
table re-lays-out the whole model, which makes the layout itself an
Iridescent specialization point (``sharding_profile``).

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims (the ``fake`` backend gives one without devices, for computing
layouts in one process).  A layout is a
:class:`PartitionSpec`, the port's own: a tuple with one entry per tensor
dim (``None``, a mesh dim name, or a tuple of names, major first), equal
as a tuple to the reference's ``jax.sharding.PartitionSpec``.  On a
``DeviceMesh`` a spec becomes DTensor placements (:func:`placements`):
one ``Shard(dim)`` or ``Replicate()`` per mesh dim.  GSPMD's
``with_sharding_constraint`` becomes :func:`constrain`, which returns a
``DTensor`` in the asked-for placement.

Divisibility-aware: a logical axis is only sharded if the dimension is
divisible by the product of the mapped mesh dim sizes (4 kv heads on a
16-way model dim stay replicated), the reference's guarded degrade: an
inapplicable sharding falls back to the generic (replicated) layout.
With no mesh active every function here is a no-op, so model code runs
unchanged on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Any, Mapping, Sequence

import torch

from repro_torch import compat

__all__ = ["ShardingRules", "DEFAULT_RULES", "PartitionSpec", "mesh_context",
           "current_mesh", "current_rules", "constrain", "logical_to_spec",
           "placements", "named_sharding", "spec_for_axes", "mesh_shape",
           "local_shard", "shard_index", "replicate", "is_dtensor",
           "shard_dims", "spec_of_dims", "entry_dims", "local_view",
           "local_start", "local_like",
           "from_local", "whole_layout", "reduce_over", "write_local"]


# Logical axis vocabulary used across the model zoo:
#   batch       global batch                     -> pod+data
#   seq         sequence (activations)           -> None (or model for SP)
#   embed       d_model features                 -> None (acts) / fsdp (params)
#   heads       q heads                          -> model
#   kv_heads    kv heads                         -> model if divisible
#   head_dim    per-head features                -> None
#   ffn         FFN hidden                       -> model
#   vocab       vocabulary                       -> model
#   experts     MoE experts                      -> model (EP)
#   expert_cap  per-expert capacity rows         -> None
#   fsdp        param rows for ZeRO-3 sharding   -> data (+pod optional)
#   layers      stacked layer dim                -> None
#   state       recurrent state features         -> None
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple[tuple[str, tuple[str, ...] | None], ...]

    @staticmethod
    def make(mapping: Mapping[str, Any]) -> "ShardingRules":
        norm = []
        for k, v in mapping.items():
            if v is None:
                norm.append((k, None))
            elif isinstance(v, str):
                norm.append((k, (v,)))
            else:
                norm.append((k, tuple(v)))
        return ShardingRules(tuple(norm))

    def get(self, name: str) -> tuple[str, ...] | None:
        for k, v in self.rules:
            if k == name:
                return v
        raise KeyError(f"no sharding rule for logical axis {name!r}")

    def replace(self, **updates: Any) -> "ShardingRules":
        d = dict(self.rules)
        for k, v in updates.items():
            d[k] = None if v is None else ((v,) if isinstance(v, str)
                                           else tuple(v))
        return ShardingRules.make(d)


DEFAULT_RULES = ShardingRules.make({
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": ("pod", "data"),
    "expert_ffn": None,
    "moe_groups": ("pod", "data"),
    "fsdp": ("data",),
    "expert_fsdp": ("data",),
    "layers": None,
    "state": None,
    "conv": None,
})


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh dim name,
    or a tuple of names (the dim split over several mesh dims, the first
    major).  Trailing ``None`` entries are omitted, as in JAX."""

    def __new__(cls, *parts: None | str | tuple[str, ...]):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh: Any) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh``."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a sharding mesh needs named dims "
                         "(pod / data / model)")
    return dict(zip(names, mesh.mesh.shape))


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Any = None
        self.rules: ShardingRules = DEFAULT_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh: Any, rules: ShardingRules | None = None):
    """Activate a mesh + rules table for model code run inside.

    With a ``DeviceMesh``, plain tensors that meet DTensors inside (index
    tensors, masks built from ``arange``, constants) are taken as
    replicated (DTensor's ``implicit_replication``).
    """
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = rules
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh() -> Any:
    return _CTX.mesh


def current_rules() -> ShardingRules:
    return _CTX.rules


def logical_to_spec(axes: Sequence[str | None],
                    shape: Sequence[int] | None = None,
                    mesh: Any = None,
                    rules: ShardingRules | None = None) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, dropping indivisible
    axes; a mesh dim shards at most one tensor dim, first come first
    served."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    sizes = mesh_shape(mesh) if mesh is not None else {}
    parts: list = []
    used: set[str] = set()
    for i, name in enumerate(axes):
        if name is None:
            parts.append(None)
            continue
        phys = rules.get(name)
        if phys is None or mesh is None:
            parts.append(None)
            continue
        phys = tuple(a for a in phys if a in sizes and a not in used)
        if not phys:
            parts.append(None)
            continue
        if shape is not None:
            n = 1
            for a in phys:
                n *= sizes[a]
            if n == 0 or shape[i] % n != 0:
                parts.append(None)  # degrade to replicated (guarded layout)
                continue
        used.update(phys)
        parts.append(phys if len(phys) > 1 else phys[0])
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def placements(spec: Sequence, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` for the tensor dim ``i`` whose entry names it, else
    ``Replicate()``.  A tensor dim split over several mesh dims is sharded
    on each, in mesh-dim order (pod major on the production meshes)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: dict[str, int] = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [n for n in mesh_shape(mesh) if n in names]
        if order != list(names):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"dim order {tuple(mesh_shape(mesh))}")
        for n in names:
            dim_of[n] = i
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh_shape(mesh))


def named_sharding(axes: Sequence[str | None],
                   shape: Sequence[int] | None = None,
                   mesh: Any = None,
                   rules: ShardingRules | None = None):
    """``(mesh, placements)`` of a logical layout; None without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return mesh, placements(logical_to_spec(axes, shape, mesh, rules), mesh)


def is_dtensor(x: Any) -> bool:
    """``x`` is a DTensor, checked without importing DTensor's module
    (a second's import): no DTensor exists before the module defines the
    class, and another thread may be importing it (``torch._dynamo``
    does) while this runs."""
    cls = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                  None)
    return cls is not None and isinstance(x, cls)


def _to_dtensor(x: torch.Tensor, mesh: Any, place: tuple) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        # a plain tensor under a mesh holds the whole value on every rank
        x = DTensor.from_local(x, mesh, [Replicate()] * len(place),
                               run_check=False)
    if tuple(x.placements) == tuple(place):
        return x
    return x.redistribute(mesh, place)


def constrain(x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
    """The layout constraint by logical axes: ``x`` as a DTensor placed
    per the active rules (a plain tensor is taken as replicated first);
    ``x`` untouched without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _to_dtensor(x, mesh, placements(
        logical_to_spec(axes, x.shape, mesh), mesh))


def local_shard(x: torch.Tensor, mesh: Any, spec: Sequence,
                grad: Mapping[str, str] | None = None) -> torch.Tensor:
    """This rank's shard of ``x`` placed by ``spec`` on ``mesh`` (a plain
    ``x`` is taken as replicated), as a plain tensor: the input of a block
    that runs on each rank's shard, as the reference's ``shard_map``
    blocks do.  ``grad`` ({mesh dim: "partial" or "replicate"}) sets the
    placement of the gradient that comes back through it over those
    dims (the others as placed): ``partial`` where the block on each rank
    uses only a part of an input that is replicated over the dim."""
    from torch.distributed.tensor import Partial, Replicate
    place = placements(spec, mesh)
    x = _to_dtensor(x, mesh, place)
    kinds = {"partial": Partial(), "replicate": Replicate()}
    grads = [kinds[grad[n]] if grad and n in grad else pl
             for n, pl in zip(mesh_shape(mesh), place)]
    return x.to_local(grad_placements=grads)


def shard_index(mesh: Any, dims: Sequence[str]) -> int:
    """This rank's index among the shards of a tensor dim split over the
    mesh dims ``dims`` (major first)."""
    sizes = mesh_shape(mesh)
    idx = 0
    for n in dims:
        idx = idx * sizes[n] + mesh.get_local_rank(n)
    return idx


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on the active mesh, as a plain tensor (the whole
    value on every rank; differentiable).  The degrade for an op that has
    no DTensor sharding strategy; ``x`` untouched without a mesh."""
    return x.full_tensor() if is_dtensor(x) else x


def shard_dims(x: torch.Tensor) -> tuple[tuple[str, ...], ...]:
    """Per tensor dim of ``x``, the mesh dims that split it (mesh order,
    major first); every entry empty for a plain tensor."""
    dims: list[tuple[str, ...]] = [()] * x.ndim
    if is_dtensor(x):
        for name, pl in zip(mesh_shape(x.device_mesh), x.placements):
            if pl.is_shard():
                dims[pl.dim] += (name,)
    return tuple(dims)


def entry_dims(entry: None | str | Sequence[str]) -> tuple[str, ...]:
    """The mesh dims a :class:`PartitionSpec` entry names (major first)."""
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def spec_of_dims(dims: Sequence[tuple[str, ...]]) -> PartitionSpec:
    """The :class:`PartitionSpec` of :func:`shard_dims`' entries."""
    return PartitionSpec(*(None if not d else d[0] if len(d) == 1
                           else tuple(d) for d in dims))


def local_view(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``x`` as a plain tensor sharing its storage
    (an in-place write into it lands in ``x``); ``x`` itself when plain."""
    return x.to_local() if is_dtensor(x) else x


def local_start(x: torch.Tensor, dim: int) -> int:
    """The global index of the first element of ``dim`` in this rank's
    shard of ``x`` (0 for a plain tensor or an unsplit dim)."""
    names = shard_dims(x)[dim]
    if not names:
        return 0
    return shard_index(x.device_mesh, names) * local_view(x).shape[dim]


def from_local(t: torch.Tensor, mesh: Any, spec: Sequence,
               shape: Sequence[int] | None = None) -> torch.Tensor:
    """Each rank's ``t`` as the shards of a DTensor placed by ``spec`` (the
    mesh dims it does not name: the same value on every rank); ``t``
    untouched without a mesh.  ``shape`` is the whole tensor's, where the
    shards are uneven (``torch.chunk``'s split, the last ranks holding
    less) or where ``t`` is not every rank's size."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False, **whole_layout(shape))


def whole_layout(shape: Sequence[int] | None) -> dict:
    """``DTensor.from_local``'s ``shape`` and ``stride`` keywords for a
    contiguous tensor of ``shape`` (none for None), computed without
    allocating one (the dry run's fake-tensor counter would count it)."""
    if shape is None:
        return {}
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= size
    return {"shape": torch.Size(shape), "stride": tuple(reversed(stride))}


def reduce_over(t: torch.Tensor, op: str, dims: Sequence[str],
                mesh: Any) -> torch.Tensor:
    """``t`` all-reduced (``op``: "sum" or "max") over the mesh dims
    ``dims``, a functional collective on each; ``t`` without any."""
    if not dims:
        return t
    from torch.distributed import _functional_collectives as funcol
    for name in dims:
        t = funcol.all_reduce(t, op, mesh.get_group(name))
    return t


def local_like(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``src`` placed as ``like`` is (a plain ``src``
    is taken as replicated; redistributed only where the placements
    differ), as a plain tensor; ``src``'s whole value when ``like`` is
    plain."""
    if is_dtensor(like):
        return _to_dtensor(src, like.device_mesh,
                           tuple(like.placements)).to_local()
    return replicate(src)


def write_local(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` where ``dst`` may be a DTensor: on each rank into
    its own shard, ``src`` placed as ``dst`` is (a plain ``src`` is taken as
    replicated); nothing is gathered to the whole of ``dst``."""
    local_view(dst).copy_(local_like(src, dst) if is_dtensor(dst) else src)


def spec_for_axes(axes_tree: Any, shapes_tree: Any = None,
                  mesh: Any = None,
                  rules: ShardingRules | None = None) -> Any:
    """Map a tree of logical-axes tuples to ``(mesh, placements)`` per
    leaf (None without a mesh).

    ``axes_tree`` leaves are tuples of logical names (or None).  If
    ``shapes_tree`` is given (a matching tree of tensors or
    ``torch.Size``), divisibility is checked per leaf.
    """
    mesh = mesh if mesh is not None else current_mesh()
    is_axes = lambda x: isinstance(x, tuple) and not isinstance(x, torch.Size)

    def one(axes, shaped=None):
        shape = getattr(shaped, "shape", shaped)
        return named_sharding(axes, shape, mesh, rules)

    if shapes_tree is None:
        return compat.tree_map(one, axes_tree, is_leaf=is_axes)
    leaves, treedef = compat.tree_flatten(axes_tree, is_leaf=is_axes)
    shapes = compat.tree_leaves(shapes_tree,
                                is_leaf=lambda x: isinstance(x, torch.Size))
    return compat.tree_unflatten(treedef, [one(a, s)
                                           for a, s in zip(leaves, shapes)])
