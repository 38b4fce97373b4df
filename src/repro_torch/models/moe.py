"""Mixture-of-Experts FFN (kimi-k2 384e/top-8, deepseek-v2 160e/top-6 + 2
shared), with the dispatch implementation as an Iridescent spec point.

The port of the reference's ``models/moe.py``.  The dispatch
implementations share :func:`assign_experts` (the same routing, positions
and drops under equal capacity settings):

* ``"einsum"``  — one-hot dispatch/combine products (the classic MoE of
  Shazeer et al.): the dispatch and combine each cost ``T*E*C*d``
  multiply-adds, typically more than the experts' own at large E.  The
  generic implementation.  The ``(G, g, E, C)`` dispatch and combine
  tensors are built by one scatter each: a token's k slots go to distinct
  experts, so a 1 (or the slot's weight) at ``(t, e, pos)`` of each kept
  slot is exactly the reference's sum over k of one-hot products, without
  its ``(T, k, E, C)`` intermediates.
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
reference: no kernel of its own.  Under a mesh (not ``shard``) the
routing and the index writes and reads of the dispatch run on replicated
tensors (DTensor has no sharding strategy for them), and the expert
products on the DTensors the reference's ``constrain`` points place.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding import (PartitionSpec, constrain,
                                              current_mesh, local_shard,
                                              mesh_context, mesh_shape,
                                              placements, replicate)
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
    t, e = logits.shape
    probs, w, idx = _route(logits, top_k)
    g = group_size if group_size > 0 else t
    if t % g:
        raise ValueError(f"moe_group {group_size} does not divide the "
                         f"{t} tokens of the call")
    flat_e = idx.reshape(t // g, g * top_k)               # token-major slots
    pos = _rank_positions(flat_e, e, ranking).reshape(t, top_k)
    return {"idx": idx, "w": w, "pos": pos, "keep": pos < capacity,
            "aux": _aux(probs, idx, e)}


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


def _einsum_moe(a: dict, xf: torch.Tensor, p: dict, e: int, k: int,
                cap: int, g: int) -> torch.Tensor:
    t, d = xf.shape
    cdt = xf.dtype
    n_groups = t // g
    keep = a["keep"].reshape(-1).to(cdt)
    flat_t = torch.arange(t, device=xf.device).repeat_interleave(k)
    # (token, expert * cap + pos) of each slot; a dropped slot writes its
    # 0 at its own expert's last column, which no other slot of the token
    # touches (its k experts are distinct)
    col = a["idx"].reshape(-1) * cap + a["pos"].reshape(-1).clamp_max(
        cap - 1)
    disp = torch.zeros((t, e * cap), dtype=cdt, device=xf.device)
    comb = torch.zeros_like(disp)
    disp.index_put_((flat_t, col), keep)
    comb.index_put_((flat_t, col), a["w"].reshape(-1).to(cdt) * keep)
    disp = disp.reshape(n_groups, g, e, cap)
    # the combine weights carry the router's gradient: under a mesh they
    # re-enter as a replicated DTensor (constrain), so it comes back plain
    comb = constrain(comb.reshape(n_groups, g, e, cap), (None,) * 4)
    buf = torch.einsum("gtec,gtd->gecd", disp, xf.reshape(n_groups, g, d))
    # grouped: shard groups over data; one group: shard the capacity
    cap_axes = (("moe_groups", "experts", None, None) if n_groups > 1
                else (None, "experts", "expert_cap", None))
    hbuf = constrain(_expert_ffn(constrain(buf, cap_axes), p, cdt),
                     cap_axes)
    return torch.einsum("gtec,gecd->gtd", comb, hbuf).reshape(t, d)


def _gather_moe(a: dict, xf: torch.Tensor, p: dict, e: int, k: int,
                cap: int, g: int) -> torch.Tensor:
    t, d = xf.shape
    cdt = xf.dtype
    rows = (t // g) * e * cap
    flat_t = torch.arange(t, device=xf.device).repeat_interleave(k)
    # each slot's row in the buffers: a group's experts after the
    # previous group's
    dest = (flat_t // g * e + a["idx"].reshape(-1)) * cap \
        + a["pos"].reshape(-1)
    keep = a["keep"].reshape(-1)
    # a dropped slot lands in one extra row past the buffers, cut off after
    # (the index write and read take replicated tensors under a mesh)
    buf = torch.zeros((rows + 1, d), dtype=cdt, device=xf.device)
    buf.index_copy_(0, torch.where(keep, dest, rows), replicate(xf)[flat_t])
    # grouped: shard groups over data; one group: (E, C, d), the capacity
    # sharded, as the reference lays it out
    shape, cap_axes = (((t // g, e, cap, d), ("moe_groups", "experts",
                                                None, None)) if g < t
                       else ((e, cap, d), ("experts", "expert_cap", None)))
    hbuf = constrain(_expert_ffn(constrain(
        buf[:rows].reshape(shape), cap_axes), p, cdt), cap_axes)
    gathered = replicate(hbuf).reshape(rows, d).index_select(
        0, torch.where(keep, dest, 0))
    gathered = gathered * (a["w"].reshape(-1).to(cdt) * keep.to(cdt))[:, None]
    return gathered.reshape(t, k, d).sum(1)


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


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              opts: MoEOptions) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), aux loss scalar (fp32) * aux_coef)."""
    global degrades
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = x.dtype
    xf = x.reshape(b * s, d)
    t = b * s
    impl = opts.impl
    if impl == "shard":
        mesh = _shard_mesh(e)
        if mesh is not None:
            out, aux = _shard_moe(p, xf, cfg, opts, mesh)
            return _with_shared(p, xf, out, cdt).reshape(b, s, d), \
                aux * opts.aux_coef
        impl = "gather"          # the reference's guarded degrade
        degrades += 1

    # routing on replicated logits under a mesh: no DTensor strategy for
    # its sort, one-hot ranking and scatters
    logits = replicate((xf @ p["router"].to(cdt)).to(torch.float32))
    if impl == "dense":
        with mesh_context(None):            # the oracle: all replicated
            out, aux = _dense_moe(logits, replicate(xf), {
                n: replicate(p[n]) for n in ("wg", "wu", "wd")}, e, k)
    elif impl in ("einsum", "gather"):
        g = opts.group_size if opts.group_size > 0 else t
        cap = _capacity(g, k, e, opts.capacity_factor)
        a = assign_experts(logits, k, e, cap, opts.group_size, opts.ranking)
        aux = a["aux"]
        fn = _einsum_moe if impl == "einsum" else _gather_moe
        out = fn(a, xf, p, e, k, cap, g)
    else:
        raise ValueError(f"unknown moe impl {opts.impl!r}")
    # a plain output re-enters the mesh's tensors through constrain (its
    # gradient then comes back plain)
    out = constrain(out, ("batch", None))
    return _with_shared(p, xf, out, cdt).reshape(b, s, d), \
        constrain(aux, ()) * opts.aux_coef


def _with_shared(p: dict, xf: torch.Tensor, out: torch.Tensor,
                 cdt: torch.dtype) -> torch.Tensor:
    """``out`` plus the shared experts' swiglu of ``xf``, if any."""
    if "shared" not in p:
        return out
    sh = p["shared"]
    hs = F.silu(xf @ sh["wg"].to(cdt)) * (xf @ sh["wu"].to(cdt))
    hs = constrain(hs, ("batch", "ffn"))
    return out + hs @ sh["wd"].to(cdt)
