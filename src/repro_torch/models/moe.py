"""Mixture-of-Experts FFN (kimi-k2 384e/top-8, deepseek-v2 160e/top-6 + 2
shared), with the dispatch implementation as an Iridescent spec point.

The port of the reference's ``models/moe.py``.  The dispatch
implementations share :func:`assign_experts` (the same routing, positions
and drops under equal capacity settings):

* ``"einsum"``  — one-hot dispatch/combine products (the classic MoE of
  Shazeer et al.): the dispatch and combine each cost ``T*E*C*d``
  multiply-adds, typically more than the experts' own at large E.  The
  generic implementation.  The ``(T, E*C)`` dispatch and combine
  tensors are built by one scatter each: a token's k slots go to distinct
  experts, so a 1 (or the slot's weight) at ``(t, e, pos)`` of each kept
  slot is exactly the reference's sum over k of one-hot products, without
  its ``(T, k, E, C)`` intermediates; the products run per group.
* ``"gather"``  — the tokens copied into per-expert capacity buffers by
  index and the expert outputs gathered back: no dispatch products.  The
  specialized implementation the Controller should find.
* ``"dense"``   — every expert computes every token, combined by the gates.
  Only sane at small sizes; the oracle (equal to the others when capacity
  does not bind).
* ``"shard"``   — explicit expert parallelism over a mesh's ``model``
  dim (:func:`_shard_moe`, the reference's ``shard_map`` block): tokens
  are data-sharded and so replicated across ``model``; each model rank
  routes its data shard's tokens to its own ``E/|model|`` experts, and the
  partial outputs combine with ONE all-reduce over ``model`` per layer.
  Capacity is per (data shard, expert), the standard EP form.  With no
  mesh, no ``model`` dim, or a ``model`` dim that does not divide E it
  degrades to ``gather``, as the reference does; :data:`degrades` counts
  each such call.

The expert products run as one batched product over the experts.
Routing, ranking and the aux loss are plain tensor code here, as in the
reference: no kernel of its own.  Under a mesh ``einsum`` and ``gather``
run on each rank's own tokens, as GSPMD partitions the reference's
(:func:`_mesh_moe`): the router product, the routing and the positions
on the rank's batch rows (a slot keeps the position the whole call gives
it: the earlier ranks' counts per expert come in one all-gather of E
integers), each rank writes the slots its block of the capacity buffers
holds, the blocks are exchanged into the buffers' placement (a
reduce-scatter over the token dims; DTensor has no sharding strategy for
the index writes and reads themselves), the experts run on the DTensors
the reference's ``constrain`` points place, and each rank reads its
slots back from its block.  Nothing holds the call's tokens, slots or
buffers whole.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding import (PartitionSpec, constrain,
                                              current_mesh,
                                              entry_dims, from_local,
                                              local_shard, logical_to_spec,
                                              mesh_context, mesh_shape,
                                              placements, replicate,
                                              shard_index, spec_of_dims,
                                              whole_layout)
from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig

__all__ = ["MoEOptions", "init_moe", "moe_axes", "apply_moe",
           "assign_experts", "degrades", "reset_degrades"]

#: ``impl="shard"`` calls run as ``gather`` (no mesh, no ``model`` dim, or
#: one that does not divide E) since the last :func:`reset_degrades`
degrades = 0


def reset_degrades() -> None:
    global degrades
    degrades = 0


@dataclasses.dataclass(frozen=True)
class MoEOptions:
    """MoE spec-point bundle (populated by the step builder)."""

    impl: str = "gather"             # gather | einsum | dense | shard
    capacity_factor: float = 1.25
    group_size: int = 0              # 0 = one group (all tokens)
    ranking: str = "cumsum"          # cumsum (classic one-hot) | sort
    aux_coef: float = 0.01


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, (d, e)),
        "wg": dense_init(gen, (e, d, f), in_axis=1),
        "wu": dense_init(gen, (e, d, f), in_axis=1),
        "wd": dense_init(gen, (e, f, d), in_axis=1),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = {
            "wg": dense_init(gen, (d, fs)),
            "wu": dense_init(gen, (d, fs)),
            "wd": dense_init(gen, (fs, d)),
        }
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    ax = {
        "router": ("fsdp", None),
        "wg": ("experts", "expert_fsdp", "expert_ffn"),
        "wu": ("experts", "expert_fsdp", "expert_ffn"),
        "wd": ("experts", "expert_ffn", "expert_fsdp"),
    }
    if cfg.n_shared_experts:
        ax["shared"] = {"wg": ("fsdp", "ffn"), "wu": ("fsdp", "ffn"),
                        "wd": ("ffn", "fsdp")}
    return ax


def _rank_positions(flat_e: torch.Tensor, e: int,
                    ranking: str) -> torch.Tensor:
    """Position of each (group, slot) entry within its (group, expert).

    flat_e (G, n), token-major slot order.  Two formulations of the same
    result (a spec point):

    * ``cumsum``: cumulative sum over the one-hot — O(n*E) work;
    * ``sort``: stable argsort by expert id + searchsorted — keeps the
      token-major order within each expert, so the positions are the same.
    """
    if ranking == "sort":
        n = flat_e.shape[1]
        order = torch.argsort(flat_e, dim=1, stable=True)
        sorted_e = torch.gather(flat_e, 1, order)
        experts = torch.arange(e, dtype=flat_e.dtype, device=flat_e.device)
        starts = torch.searchsorted(
            sorted_e, experts.expand(flat_e.shape[0], e).contiguous())
        ranks = torch.arange(n, device=flat_e.device)
        pos_sorted = ranks - torch.gather(starts, 1, sorted_e)
        return torch.empty_like(flat_e).scatter_(1, order, pos_sorted)
    oh = F.one_hot(flat_e, e)                             # (G, n, E)
    pos_incl = torch.cumsum(oh, dim=1)
    return torch.gather(pos_incl, 2, flat_e[..., None])[..., 0] - 1


def _route(logits: torch.Tensor, top_k: int):
    """Softmax, top-k (the lower expert first on a tie, as the reference's
    ``lax.top_k``) and the renormalised weights; (probs, w, idx)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, w, idx


def _aux(probs: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(mean prob * top-1 share)."""
    ce = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    return e * torch.sum(probs.mean(0) * ce)


def _positions(w: torch.Tensor, idx: torch.Tensor, e: int, capacity: int,
               group_size: int, ranking: str,
               offset: torch.Tensor | None = None) -> dict:
    """Each slot's position within its (group, expert) in token-major
    order, plus ``offset[expert]`` (the slots of the group's tokens that
    come before these, on other ranks), and the ``keep`` mask."""
    t, k = idx.shape
    g = group_size if group_size > 0 else t
    if t % g:
        raise ValueError(f"moe_group {group_size} does not divide the "
                         f"{t} tokens of the call")
    flat_e = idx.reshape(t // g, g * k)                   # token-major slots
    pos = _rank_positions(flat_e, e, ranking).reshape(t, k)
    if offset is not None:
        pos = pos + offset[idx]
    return {"idx": idx, "w": w, "pos": pos, "keep": pos < capacity}


def assign_experts(logits: torch.Tensor, top_k: int, n_experts: int,
                   capacity: int, group_size: int = 0,
                   ranking: str = "cumsum") -> dict:
    """Top-k routing with capacity-based dropping, shared by the impls.

    logits (T, E).  Returns (T, k) expert ids ``idx``, combine weights
    ``w`` (fp32), positions within the expert ``pos`` and the ``keep``
    mask, and the scalar ``aux`` loss term.  Positions are assigned in
    token-major order within each group of ``group_size`` tokens (0: one
    group); a group that does not divide T raises ``ValueError``.
    """
    probs, w, idx = _route(logits, top_k)
    a = _positions(w, idx, n_experts, capacity, group_size, ranking)
    a["aux"] = _aux(probs, idx, n_experts)
    return a


def _expert_ffn(buf: torch.Tensor, p: dict, cdt: torch.dtype) -> torch.Tensor:
    """buf (..., E, C, d) -> same; per-expert swiglu."""
    wg, wu, wd = p["wg"].to(cdt), p["wu"].to(cdt), p["wd"].to(cdt)
    h = F.silu(torch.einsum("...ecd,edf->...ecf", buf, wg)) \
        * torch.einsum("...ecd,edf->...ecf", buf, wu)
    h = constrain(h, (None,) * (buf.ndim - 3) + ("experts", None,
                                                 "expert_ffn"))
    return torch.einsum("...ecf,efd->...ecd", h, wd)


def _capacity(t: int, top_k: int, e: int, factor: float) -> int:
    """Per-expert capacity, rounded up to a multiple of 16 (of 512 from
    512 on) as the reference rounds it to shard the capacity dim."""
    c = max(1, math.ceil(t * top_k * factor / e))
    mult = 512 if c >= 512 else 16
    return -(-c // mult) * mult


def _prod(sizes: dict, names) -> int:
    n = 1
    for a in names:
        n *= sizes[a]
    return n


@dataclasses.dataclass
class _Block:
    """The capacity buffers (G groups, E experts, C slots each) as this
    rank fills and reads them, and the rank's tokens.

    The rank holds groups ``[q0, q0 + ql)``, experts ``[e0, e0 + el)`` and
    slots ``[c0, c0 + cl)`` of the buffers (a 4-D local block
    ``(ql, el, cl, d)``), and tokens ``[t0, t0 + t_loc)`` of the call,
    which make up ``gm`` groups from group ``g0`` on.  Without a mesh the
    block is the whole of the buffers and every token.

    Under a mesh (:func:`_mesh_block`) the block is the rank's share of
    the buffers placed as the reference's ``cap_axes`` (seen by the
    experts as one ``(E, G*C, d)`` DTensor, ``target``), before the
    exchange between the ranks that hold different tokens (``fill``:
    ``Partial`` over the token dims, or ``Shard`` where a rank's groups
    are its own tokens'); ``partial`` are the mesh dims over which a
    rank's block holds only a part of its tokens' slots.
    """

    q0: int
    ql: int
    e0: int
    el: int
    c0: int
    cl: int
    t0: int
    t_loc: int
    g0: int
    gm: int
    mesh: object = None
    shape: tuple = ()
    fill: tuple = ()
    target: tuple = ()
    tdims: tuple = ()
    partial: tuple = ()

    def ffn(self, buf: torch.Tensor, p: dict, cdt: torch.dtype
            ) -> torch.Tensor:
        """The experts on the block ``(ql, el, cl, d)``; same shape back.
        Under a mesh the filled blocks are exchanged into the buffers'
        placement (``fill`` -> ``target``: a reduce-scatter over the token
        dims), the experts run on the DTensor, and each rank reads back
        the block it filled (an all-gather over the token dims; its
        gradient is the rank's own slots', a partial sum over them)."""
        if self.mesh is None:
            return _expert_ffn(buf, p, cdt)
        from torch.distributed.tensor import DTensor, Partial, Replicate
        d = buf.shape[-1]
        b3 = buf.permute(1, 0, 2, 3).reshape(self.el, self.ql * self.cl, d)
        e, gc = self.shape
        dt = DTensor.from_local(b3, self.mesh, self.fill, run_check=False,
                                **whole_layout((e, gc, d)))
        h = _expert_ffn(dt.redistribute(self.mesh, self.target), p, cdt)
        back = tuple(Replicate() if pl.is_partial() else pl
                     for pl in self.fill)
        h = h.redistribute(self.mesh, self.target).redistribute(
            self.mesh, back)
        hl = h.to_local(grad_placements=tuple(
            Partial() if f.is_partial() else b
            for f, b in zip(self.fill, back)))
        return hl.reshape(self.el, self.ql, self.cl, d).permute(1, 0, 2, 3)

    def output(self, out: torch.Tensor, shape: tuple) -> torch.Tensor:
        """The rank's part of its tokens' output, ``out`` (its batch rows),
        as the whole ``shape``: a DTensor split over the token dims and a
        partial sum over ``partial``."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        place = tuple(Shard(0) if n in self.tdims else
                      Partial() if n in self.partial else Replicate()
                      for n in mesh_shape(self.mesh))
        return DTensor.from_local(out, self.mesh, place, run_check=False,
                                  **whole_layout(shape))


def _local_block(t: int, g: int, e: int, cap: int) -> _Block:
    return _Block(q0=0, ql=t // g, e0=0, el=e, c0=0, cl=cap, t0=0,
                  t_loc=t, g0=0, gm=t // g)


def _mesh_block(mesh, b: int, s: int, e: int, cap: int, g: int) -> _Block:
    """This rank's :class:`_Block` on ``mesh``: its tokens are its batch
    rows (split over the mesh dims of ``batch``, all ``s`` positions), the
    buffers placed by the reference's ``cap_axes``: one group (``g`` the
    call's ``b * s`` tokens) as ``(experts, expert_cap)``, else
    ``(moe_groups, experts)``."""
    from torch.distributed.tensor import Partial, Shard
    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    t = b * s
    n_groups = t // g
    bspec = logical_to_spec(("batch",), (b,), mesh)
    tdims = entry_dims(bspec[0] if bspec else None)
    t_loc = t // _prod(sizes, tdims)
    t0 = shard_index(mesh, tdims) * t_loc
    if n_groups > 1 and t_loc % g and g % t_loc:
        raise ValueError(f"moe_group {g} neither divides the {t_loc} tokens "
                         f"of a rank nor spans whole ranks ({t} tokens over "
                         f"the mesh dims {tdims})")
    if n_groups > 1:
        gs, es = (logical_to_spec(("moe_groups", "experts"), (n_groups, e),
                                  mesh) + (None, None))[:2]
    else:
        es, gs = (logical_to_spec(("experts", "expert_cap"), (e, cap),
                                  mesh) + (None, None))[:2]
    target = placements(PartitionSpec(es, gs), mesh)
    gdims = tuple(n for n, pl in zip(names, target) if pl == Shard(1))
    own_groups = n_groups > 1 and gdims == tdims
    fill = tuple((Shard(1) if own_groups else Partial()) if n in tdims
                 else pl for n, pl in zip(names, target))

    def span(dim: int, extent: int) -> tuple[int, int]:
        dims = tuple(n for n, pl in zip(names, fill) if pl == Shard(dim))
        n = extent // _prod(sizes, dims)
        return shard_index(mesh, dims) * n, n

    e0, el = span(0, e)
    j0, jl = span(1, n_groups * cap)
    q0, ql, c0, cl = ((j0 // cap, jl // cap, 0, cap) if n_groups > 1
                      else (0, 1, j0, jl))
    return _Block(q0=q0, ql=ql, e0=e0, el=el, c0=c0, cl=cl, t0=t0,
                  t_loc=t_loc, g0=t0 // g, gm=max(1, t_loc // g), mesh=mesh,
                  shape=(e, n_groups * cap), fill=fill, target=target,
                  tdims=tdims, partial=tuple(
                      n for n, pl in zip(names, fill)
                      if n not in tdims and pl.is_shard()))


def _dispatch(a: dict, xl: torch.Tensor, p: dict, k: int, cap: int, g: int,
              impl: str, blk: _Block) -> torch.Tensor:
    """The rank's tokens ``xl (t_loc, d)`` through the experts, routed by
    ``a`` (global positions): each slot the rank's block holds is written
    into it (``gather``: an index write; ``einsum``: a one-hot product of
    the rank's tokens and the block's ``el * cl`` slots of a group), the
    experts run (:meth:`_Block.ffn`), and each slot reads its row back,
    weighted.  A dropped slot, or one outside the block, moves nothing.
    Returns (t_loc, d): under a mesh the rank's part of its tokens'
    output, which :meth:`_Block.output` places."""
    t_loc, d = xl.shape
    cdt = xl.dtype
    b = blk
    flat_t = torch.arange(t_loc, device=xl.device).repeat_interleave(k)
    lq = (b.t0 + flat_t) // g - b.q0
    le = a["idx"].reshape(-1) - b.e0
    lc = a["pos"].reshape(-1) - b.c0
    mine = a["keep"].reshape(-1) & (lq >= 0) & (lq < b.ql) & (le >= 0) \
        & (le < b.el) & (lc >= 0) & (lc < b.cl)
    wk = a["w"].reshape(-1).to(cdt) * mine.to(cdt)
    rows = b.ql * b.el * b.cl
    if impl == "gather":
        dest = torch.where(mine, (lq * b.el + le) * b.cl + lc, rows)
        # a slot the block does not take lands in one extra row, cut off
        buf = torch.zeros((rows + 1, d), dtype=cdt, device=xl.device)
        buf.index_copy_(0, dest, xl[flat_t])
        hbuf = b.ffn(buf[:rows].reshape(b.ql, b.el, b.cl, d), p, cdt)
        gathered = hbuf.reshape(rows, d).index_select(
            0, torch.where(mine, dest, 0)) * wk[:, None]
        return gathered.reshape(t_loc, k, d).sum(1)
    # (token, expert * cl + slot) of each slot, within its group; a slot
    # the block does not take adds its 0 at column 0
    col = torch.where(mine, le * b.cl + lc, 0)
    disp = torch.zeros((t_loc, b.el * b.cl), dtype=cdt, device=xl.device)
    comb = torch.zeros_like(disp)
    disp.index_put_((flat_t, col), mine.to(cdt), accumulate=True)
    comb.index_put_((flat_t, col), wk, accumulate=True)
    per = t_loc // b.gm
    buf = torch.einsum("gtr,gtd->grd", disp.reshape(b.gm, per, -1),
                       xl.reshape(b.gm, per, d))
    buf = buf.reshape(b.gm, b.el, b.cl, d)
    lo = b.g0 - b.q0
    if b.gm != b.ql:                  # the rank's groups among all of them
        buf = F.pad(buf, (0, 0, 0, 0, 0, 0, lo, b.ql - lo - b.gm))
    hbuf = b.ffn(buf, p, cdt)[lo:lo + b.gm]
    return torch.einsum("gtr,grd->gtd", comb.reshape(b.gm, per, -1),
                        hbuf.reshape(b.gm, b.el * b.cl, d)).reshape(t_loc, d)


def _dense_moe(logits: torch.Tensor, xf: torch.Tensor, p: dict, e: int,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    t, d = xf.shape
    probs, w, idx = _route(logits, k)
    full = torch.zeros((t, e), dtype=torch.float32, device=xf.device)
    full.scatter_(1, idx, w)                              # (T, E) gates
    h = _expert_ffn(xf[None].expand(e, t, d), p, xf.dtype)  # (E, T, d)
    out = torch.einsum("te,etd->td", full.to(xf.dtype), h)
    return out, _aux(probs, idx, e)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the gradient passes unchanged.

    The sum's output feeds a tensor that is replicated over the group,
    whose gradient reaches every rank whole: the matching collective of
    the backward is the all-reduce of the inputs' gradients, which the
    DTensors the block's inputs came from perform (their gradient
    placement is ``Partial`` over the group, see :func:`_shard_moe`)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shard_moe(p: dict, xf: torch.Tensor, cfg: ModelConfig,
               opts: MoEOptions, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert parallelism over the ``model`` dim (the module
    docstring): the reference's ``shard_map`` block on local tensors.

    Each rank takes its data shard's tokens ``xl (T_loc, d)`` (replicated
    over ``model``; T must divide over the data dims, as the reference's
    ``shard_map`` in_spec requires, else ValueError), the whole router and its model shard's ``E_loc``
    experts (under an FSDP profile placing them is the per-layer weight
    all-gather over ``data``).  It routes, fills local capacity buffers
    with the reference's sentinel rule and ``sort`` positions, runs its
    experts, and the partial outputs combine with one all-reduce over
    ``model``.  The aux loss is the rank's own, averaged over the data
    dims.

    Gradients: what each rank computes from a replicated input is a
    partial sum of that input's gradient, so the inputs' local tensors
    carry ``Partial`` gradient placements over ``model`` (router, tokens)
    and over the data dims (router, experts); the aux loss,
    the same on every model rank, passes its gradient to each scaled by
    ``1/|model|``.
    """
    from torch.distributed.tensor import DTensor, Replicate
    sizes = mesh_shape(mesh)
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    cdt = xf.dtype
    n_model = sizes["model"]
    e_loc = e // n_model
    t = xf.shape[0]
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    if t % n_dp:
        raise ValueError(f"moe_impl=shard: the {t} tokens do not divide "
                         f"over the data dims {dp} ({n_dp} shards)")
    tok_spec = (dp if len(dp) > 1 else dp[0]) if dp else None
    partial_tok = {a: "partial" for a in dp}
    xl = local_shard(xf, mesh, PartitionSpec(tok_spec), {"model": "partial"})
    router = local_shard(p["router"].to(cdt), mesh, PartitionSpec(),
                    {**partial_tok, "model": "partial"})
    wg, wu, wd = (local_shard(p[n].to(cdt), mesh, PartitionSpec("model"),
                         partial_tok) for n in ("wg", "wu", "wd"))

    t_loc = xl.shape[0]
    cap = _capacity(t_loc, k, e, opts.capacity_factor)
    probs, w, idx = _route(xl @ router, k)
    base = mesh.get_local_rank("model") * e_loc
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t_loc, device=xl.device).repeat_interleave(k)
    local = (flat_e >= base) & (flat_e < base + e_loc)
    le = torch.where(local, flat_e - base, e_loc)         # sentinel e_loc
    pos = _rank_positions(le[None], e_loc + 1, "sort")[0]
    keep = local & (pos < cap)
    rows = e_loc * cap
    dest = torch.where(keep, le * cap + pos, rows)        # rows: dropped
    buf = torch.zeros((rows + 1, d), dtype=cdt, device=xl.device)
    buf.index_copy_(0, dest, xl[flat_t])
    buf = buf[:rows].reshape(e_loc, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) \
        * torch.einsum("ecd,edf->ecf", buf, wu)
    hb = torch.einsum("ecf,efd->ecd", h, wd).reshape(rows, d)
    gathered = hb.index_select(0, torch.where(keep, dest, 0))
    gathered = gathered * (w.reshape(-1).to(cdt) * keep.to(cdt))[:, None]
    out = _AllReduceSum.apply(gathered.reshape(t_loc, k, d).sum(1),
                              mesh.get_group("model"))   # the ONE collective

    aux = _ScaleGrad.apply(_aux(probs, idx, e), 1.0 / n_model)
    for a in dp:
        aux = _AllReduceSum.apply(aux / sizes[a], mesh.get_group(a))
    out_place = placements(PartitionSpec(tok_spec), mesh)
    out = DTensor.from_local(out, mesh, out_place, run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * len(out_place),
                             run_check=False)
    return out, aux


def _shard_mesh(e: int):
    """The active mesh when ``shard`` can run on it, else None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    if "model" not in sizes or e % sizes["model"]:
        return None
    return mesh


def _earlier_counts(idx: torch.Tensor, e: int, g: int,
                    blk: _Block) -> torch.Tensor:
    """Per expert, the slots of the tokens of this rank's group (of ``g``
    tokens, which spans several ranks) on the ranks before this one along
    the token dims: each rank's counts (E integers) all-gathered, the
    earlier ranks' of the group summed."""
    counts = replicate(from_local(F.one_hot(idx.reshape(-1), e).sum(0)[None],
                                  blk.mesh, spec_of_dims((blk.tdims,))))
    r = blk.t0 // blk.t_loc
    return counts[r - r % (g // blk.t_loc):r].sum(0)


def _mesh_moe(p: dict, x: torch.Tensor, cfg: ModelConfig, opts: MoEOptions,
              impl: str, g: int, cap: int, mesh
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``gather``/``einsum`` under a mesh, on each rank's own tokens (its
    batch rows, :func:`_mesh_block`): the router product, the routing and
    the positions run on the local rows, a slot's position is the one
    the whole call gives it (where a group spans ranks, as one group
    does, the local rank plus the group's earlier ranks' counts per
    expert, :func:`_earlier_counts`), and the slots move to and from the
    buffers by :func:`_dispatch`.  The aux
    loss is the whole call's (its means summed over the token dims), its
    gradient scaled by 1 / the ranks that hold a part of each token's
    slots (each passes it back).  Returns the output (B, S, d) as a
    DTensor and the aux loss."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = x.dtype
    blk = _mesh_block(mesh, b, s, e, cap, g)
    part = {n: "partial" for n in blk.partial}
    xl = local_shard(x, mesh, spec_of_dims((blk.tdims,)), part)
    router = local_shard(p["router"].to(cdt), mesh, PartitionSpec(),
                         {**{n: "partial" for n in blk.tdims}, **part})
    xl = xl.reshape(-1, d)
    probs, w, idx = _route((xl @ router).to(torch.float32), k)
    spans = g > blk.t_loc                  # the rank's group spans ranks
    offset = _earlier_counts(idx, e, g, blk) if spans else None
    a = _positions(w, idx, e, cap, 0 if spans else g, opts.ranking, offset)
    out = _dispatch(a, xl, p, k, cap, g, impl, blk)
    me = probs.sum(0)
    ce = F.one_hot(idx[:, 0], e).to(torch.float32).sum(0)
    for n in blk.tdims:
        me = _AllReduceSum.apply(me, mesh.get_group(n))
        ce = _AllReduceSum.apply(ce, mesh.get_group(n))
    aux = e * torch.sum((me / (b * s)) * (ce / (b * s)))
    n_part = _prod(mesh_shape(mesh), blk.partial)
    if n_part > 1:
        aux = _ScaleGrad.apply(aux, 1.0 / n_part)
    return blk.output(out.reshape(-1, s, d), (b, s, d)), aux


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              opts: MoEOptions) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), aux loss scalar (fp32) * aux_coef)."""
    global degrades
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = x.dtype
    t = b * s
    impl = opts.impl
    if impl == "shard":
        mesh = _shard_mesh(e)
        if mesh is not None:
            out, aux = _shard_moe(p, x.reshape(t, d), cfg, opts, mesh)
            return _with_shared(p, x, out.reshape(b, s, d), cdt), \
                aux * opts.aux_coef
        impl = "gather"          # the reference's guarded degrade
        degrades += 1

    mesh = current_mesh()
    if impl == "dense":
        # the oracle: routing and experts on replicated tensors
        xf = replicate(x.reshape(t, d))
        logits = (xf @ replicate(p["router"]).to(cdt)).to(torch.float32)
        with mesh_context(None):
            out, aux = _dense_moe(logits, xf, {
                n: replicate(p[n]) for n in ("wg", "wu", "wd")}, e, k)
        out = out.reshape(b, s, d)
    elif impl in ("einsum", "gather"):
        g = opts.group_size if opts.group_size > 0 else t
        if t % g:
            raise ValueError(f"moe_group {opts.group_size} does not divide "
                             f"the {t} tokens of the call")
        cap = _capacity(g, k, e, opts.capacity_factor)
        if mesh is None:
            xf = x.reshape(t, d)
            a = assign_experts((xf @ p["router"].to(cdt)).to(torch.float32),
                               k, e, cap, opts.group_size, opts.ranking)
            aux = a["aux"]
            out = _dispatch(a, xf, p, k, cap, g, impl,
                            _local_block(t, g, e, cap)).reshape(b, s, d)
        else:
            out, aux = _mesh_moe(p, x, cfg, opts, impl, g, cap, mesh)
    else:
        raise ValueError(f"unknown moe impl {opts.impl!r}")
    # the output re-enters the mesh's tensors placed as x (a plain one as
    # replicated, its gradient then coming back plain)
    out = constrain(out, ("batch", "seq", None))
    return _with_shared(p, x, out, cdt), constrain(aux, ()) * opts.aux_coef


def _with_shared(p: dict, x: torch.Tensor, out: torch.Tensor,
                 cdt: torch.dtype) -> torch.Tensor:
    """``out`` plus the shared experts' swiglu of ``x``, if any (both
    (B, S, d))."""
    if "shared" not in p:
        return out
    sh = p["shared"]
    hs = F.silu(x @ sh["wg"].to(cdt)) * (x @ sh["wu"].to(cdt))
    hs = constrain(hs, ("batch", "seq", "ffn"))
    return out + hs @ sh["wd"].to(cdt)
