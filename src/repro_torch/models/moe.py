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
* ``"shard"``   — the reference's explicit expert parallelism over a
  mesh's ``model`` axis.  With no mesh (the port runs on one device until
  ROADMAP M12) it degrades to ``gather``, as the reference does when no
  mesh with a ``model`` axis is active; :data:`degrades` counts each.

The expert products run as one batched product over the experts.
Routing, ranking and the aux loss are plain tensor code here, as in the
reference: no kernel of its own.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig

__all__ = ["MoEOptions", "init_moe", "moe_axes", "apply_moe",
           "assign_experts", "degrades", "reset_degrades"]

#: ``impl="shard"`` calls run as ``gather`` (no mesh) since the last
#: :func:`reset_degrades`
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
    comb = comb.reshape(n_groups, g, e, cap)
    buf = torch.einsum("gtec,gtd->gecd", disp, xf.reshape(n_groups, g, d))
    hbuf = _expert_ffn(buf, p, cdt)
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
    buf = torch.zeros((rows + 1, d), dtype=cdt, device=xf.device)
    buf.index_copy_(0, torch.where(keep, dest, rows), xf[flat_t])
    hbuf = _expert_ffn(buf[:rows].reshape(t // g, e, cap, d), p, cdt)
    gathered = hbuf.reshape(rows, d).index_select(
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
        impl = "gather"          # no mesh: the reference's guarded degrade
        degrades += 1

    logits = (xf @ p["router"].to(cdt)).to(torch.float32)
    if impl == "dense":
        out, aux = _dense_moe(logits, xf, p, e, k)
    elif impl in ("einsum", "gather"):
        g = opts.group_size if opts.group_size > 0 else t
        cap = _capacity(g, k, e, opts.capacity_factor)
        a = assign_experts(logits, k, e, cap, opts.group_size, opts.ranking)
        aux = a["aux"]
        fn = _einsum_moe if impl == "einsum" else _gather_moe
        out = fn(a, xf, p, e, k, cap, g)
    else:
        raise ValueError(f"unknown moe impl {opts.impl!r}")

    if "shared" in p:
        sh = p["shared"]
        hs = F.silu(xf @ sh["wg"].to(cdt)) * (xf @ sh["wu"].to(cdt))
        out = out + hs @ sh["wd"].to(cdt)
    return out.reshape(b, s, d), aux * opts.aux_coef
