"""GQA attention (prefill + cached decode), with qk-norm and sliding window.

The port of the reference's ``models/attention.py``: the full-sequence
``apply_gqa`` (prefill, through the attention op and its flash-attention
kernel), the shared-ring decode (scalar ``pos``) and the per-row decode
(vector ``pos``) that the serve step runs.

Cache writes are in place (``index_copy_`` / ``index_put_``) where the
reference rebuilds the whole cache with ``jnp.where`` /
``dynamic_update_slice``: the write touches one slot per row instead of
copying every layer's cache each token.  The returned cache holds the
same tensors as the one passed in.  Under a mesh the decode writes and
attends on each rank's own shard of the cache, as GSPMD partitions the
reference's (:func:`decode_gqa`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              current_rules, entry_dims,
                                              from_local, local_shard,
                                              local_start, local_view,
                                              logical_to_spec, mesh_shape,
                                              placements, reduce_over,
                                              shard_dims, shard_index,
                                              spec_of_dims)
from repro_torch.kernels.attention import attention as attn_op
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.models.common import (KernelOptions, apply_rope, dense_init,
                                       rms_norm_pair, rope)
from repro_torch.models.config import ModelConfig

__all__ = ["init_gqa", "gqa_axes", "apply_gqa", "init_gqa_cache",
           "gqa_cache_axes", "decode_gqa", "sharded_attention",
           "softmax_weighted"]


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, (d, h, dh)),
        "wk": dense_init(gen, (d, hk, dh)),
        "wv": dense_init(gen, (d, hk, dh)),
        "wo": dense_init(gen, (h, dh, d), in_axis=0),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32,
                                 device=gen.device)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32,
                                 device=gen.device)
    return p


def gqa_axes(cfg: ModelConfig) -> dict:
    ax = {
        "wq": ("fsdp", "heads", "head_dim"),
        "wk": ("fsdp", "kv_heads", "head_dim"),
        "wv": ("fsdp", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "fsdp"),
    }
    if cfg.qk_norm:
        ax["q_norm"] = ("head_dim",)
        ax["k_norm"] = ("head_dim",)
    return ax


def project_heads(x: torch.Tensor, w: torch.Tensor,
                  heads_axis: str) -> torch.Tensor:
    """``einsum("bsd,dhk->bhsk", x, w)``.  Under a mesh whose dims the
    ``heads_axis`` count does not divide (8 kv heads on a 16-way model
    dim), on each rank's batch rows with the whole of ``w``: DTensor would
    shard the product's flattened (heads, head_dim) dim over the model dim
    and then fail to unflatten it.  The gradient of ``w`` is then a
    partial sum over the batch's mesh dims, and the product comes back
    placed by the batch."""
    mesh = current_mesh()
    if mesh is None or logical_to_spec((heads_axis,), w.shape[1:], mesh):
        return torch.einsum("bsd,dhk->bhsk", x, w)
    bspec = logical_to_spec(("batch",), x.shape, mesh)
    batch = bspec[0] if bspec else ()
    batch = (batch,) if isinstance(batch, str) else batch
    xl = local_shard(x, mesh, bspec)
    wl = local_shard(w, mesh, (), {n: "partial" for n in batch})
    return from_local(torch.einsum("bsd,dhk->bhsk", xl, wl), mesh, bspec)


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 opts: KernelOptions, positions: torch.Tensor):
    """x (B,S,d) -> q (B,H,S,dh), k/v (B,Hk,S,dh) with rope applied."""
    cdt = x.dtype
    q = project_heads(x, p["wq"].to(cdt), "heads")
    k = project_heads(x, p["wk"].to(cdt), "kv_heads")
    v = project_heads(x, p["wv"].to(cdt), "kv_heads")
    if cfg.qk_norm:
        q, k = rms_norm_pair(q, p["q_norm"], k, p["k_norm"], cfg.rms_eps,
                             opts)
    cos, sin = rope(positions, cfg.d_head, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, ("batch", "heads", "seq", "head_dim"))
    k = constrain(k, ("batch", "kv_heads", "seq", "head_dim"))
    v = constrain(v, ("batch", "kv_heads", "seq", "head_dim"))
    return q, k, v


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_axis: str = "kv_heads", **kw) -> torch.Tensor:
    """``attn_op(q, k, v, **kw)`` (B,H,S,dh); under a mesh on each rank's
    own shard, as GSPMD partitions the reference's attention: the batch
    over the data dims and the heads over the model dim (heads are
    independent), the sequence gathered (causal attention needs every
    key).  Each rank computes only its heads, and holds only their
    scores.  Heads whose count the model dim does not divide split as
    GSPMD pads them: in chunks of ``ceil(H / n)`` (``torch.chunk``'s), so
    that the last ranks hold fewer or none; the outputs are gathered back
    (padded to even chunks), replicated over the heads' dims as the
    heads' layout leaves them.  Where the kv heads stay
    replicated (their count does not divide the dim) a rank takes the kv
    heads of its own q heads, and its gradient for k and v (and for q,
    where the q heads split unevenly) is a partial sum over the heads'
    mesh dims.  Returns a DTensor placed as q's shards (a plain tensor
    without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return attn_op(q, k, v, **kw)
    sizes = mesh_shape(mesh)
    q_spec = logical_to_spec(("batch", "heads"), q.shape, mesh)
    kv_spec = logical_to_spec(("batch", kv_axis), k.shape, mesh)
    bdims = entry_dims(q_spec[0] if q_spec else None)
    heads = entry_dims(q_spec[1] if len(q_spec) > 1 else None)
    kv_split = len(kv_spec) > 1 and kv_spec[1] is not None
    # where the heads do not divide: the dims they would split
    uneven = () if heads else tuple(
        n for n in current_rules().get("heads") or ()
        if n in sizes and n not in bdims)
    hdims = heads or uneven
    partial = {n: "partial" for n in hdims} if not kv_split else None
    bspec = spec_of_dims((bdims,))
    ql = local_shard(q, mesh, bspec if uneven else q_spec, partial
                     if uneven else None)
    kl, vl = (local_shard(t, mesh, kv_spec, partial) for t in (k, v))
    n_h, h = 1, q.shape[1]
    for n in hdims:
        n_h *= sizes[n]
    h_loc_max = -(-h // n_h) if uneven else ql.shape[1]
    first = min(shard_index(mesh, hdims) * h_loc_max, h) if hdims else 0
    if uneven:
        ql = ql[:, first:first + h_loc_max]
    h_loc = ql.shape[1]
    if hdims and not kv_split and h_loc:
        # the kv heads of this rank's q heads: one per group of them, or
        # one per q head where the rank's heads split a group
        g = h // k.shape[1]
        idx = torch.arange(first, first + h_loc, device=ql.device) // g
        if h_loc % g == 0 and first % g == 0:
            idx = idx[::g]
        kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
    if h_loc:
        out = attn_op(ql, kl, vl, **kw)
    else:
        # a rank with no head: an empty output that still depends on its
        # inputs, so that its backward runs the collectives the others do
        out = ((ql.sum() + kl.sum() + vl.sum()) * 0).expand(
            ql.shape[:3] + vl.shape[3:])
    shape = list(q.shape[:3] + v.shape[3:])
    if uneven:
        # padded to ceil(H / n) heads a rank, gathered over the heads'
        # dims, the padding cut off: the heads come back replicated (the
        # placement their count leaves them), the batch still split
        out = F.pad(out, (0, 0, 0, 0, 0, h_loc_max - h_loc))
        shape[1] = h_loc_max * n_h
    out = from_local(out, mesh, spec_of_dims((bdims, hdims)), shape)
    if uneven:
        out = out.redistribute(mesh, placements(bspec, mesh))[:, :h]
    return out


def apply_gqa(p: dict, x: torch.Tensor, cfg: ModelConfig,
              opts: KernelOptions, *, window: int | None = None,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence (prefill) attention. x (B,S,d) -> (B,S,d)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, opts, positions)
    out = sharded_attention(q, k, v, causal=True, window=window,
                            block_q=opts.block_q, block_kv=opts.block_kv,
                            impl=opts.impl_for("attention"),
                            swa_impl=opts.swa_impl)    # (B,H,S,dh)
    out = constrain(out, ("batch", "heads", "seq", "head_dim"))
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(x.dtype))
    return constrain(y, ("batch", "seq", None))


# -- decode with ring-buffer cache ---------------------------------------------

def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int | None = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str | None = None) -> dict:
    """Ring-buffer KV cache.  ``window`` bounds the buffer for SWA layers;
    ``device`` defaults to ``cuda`` (:func:`compat.resolve_device`)."""
    device = compat.resolve_device(device)
    w = min(window, max_len) if window else max_len
    hk, dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": torch.zeros((batch, hk, w, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, hk, w, dh), dtype=dtype, device=device),
        "slot_pos": torch.full((w,), -1, dtype=torch.int32, device=device),
    }


def gqa_cache_axes(cfg: ModelConfig) -> dict:
    return {
        "k": ("batch", "kv_heads", "seq_kv", "head_dim"),
        "v": ("batch", "kv_heads", "seq_kv", "head_dim"),
        "slot_pos": (None,),
    }


def softmax_weighted(scores: torch.Tensor, values: torch.Tensor, eq: str,
                     seq_dims: tuple[str, ...] = (),
                     mesh=None) -> torch.Tensor:
    """``einsum(eq, softmax(scores), values)``, the softmax over the last
    dim of ``scores`` (the cache slots).  With the slots split over the
    mesh dims ``seq_dims`` each rank holds a part of them, and the
    softmax is split as flash decoding splits it: each rank's max, sum of
    exponentials and weighted sum of ``values``, the max all-reduced
    (MAX), each part rescaled to it and the sums all-reduced (SUM), then
    divided.  A rank whose slots are all masked (the finite ``NEG_INF``)
    contributes weight 0 once any rank holds a valid slot."""
    if not seq_dims:
        return torch.einsum(eq, torch.softmax(scores, dim=-1), values)
    m = reduce_over(scores.amax(-1, keepdim=True), "max", seq_dims, mesh)
    e = torch.exp(scores - m)
    den = reduce_over(e.sum(-1, keepdim=True), "sum", seq_dims, mesh)
    num = reduce_over(torch.einsum(eq, e, values), "sum", seq_dims, mesh)
    return num / den


def _put(cl: torch.Tensor, dim: int, idx: torch.Tensor, new: torch.Tensor,
         own: torch.Tensor | None) -> None:
    """``cl``'s slots ``idx`` along ``dim`` set to ``new`` in place; where
    ``own`` (broadcastable to ``new``) is false the slot keeps its value
    (the write belongs to another rank's shard, or to no slot)."""
    if own is not None:
        new = torch.where(own, new, cl.index_select(dim, idx))
    cl.index_copy_(dim, idx, new)


def _attend(p: dict, ql: torch.Tensor, ckl: torch.Tensor, cvl: torch.Tensor,
            valid: torch.Tensor, cfg: ModelConfig, out_dtype: torch.dtype,
            dims: tuple, mesh) -> torch.Tensor:
    """Softmax attention of this rank's q (b,h,1,dh) over its shard of the
    cache (b,hk,w,dh), masked by ``valid`` (broadcastable to
    (b,hk,G,w)); ``dims`` are the cache's :func:`shard_dims`, whose batch
    and kv-head entries the local tensors already follow.  Returns
    (B,1,d) (a DTensor under a mesh)."""
    b, h, _, dh = ql.shape
    hk = ckl.shape[1]
    qg = ql.reshape(b, hk, h // hk, dh)
    scores = torch.einsum("bhgk,bhwk->bhgw", qg.to(torch.float32),
                          ckl.to(torch.float32)) * (cfg.d_head ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    out = softmax_weighted(scores, cvl.to(torch.float32), "bhgw,bhwk->bhgk",
                           dims[2], mesh)
    out = from_local(out.reshape(b, h, 1, dh).to(out_dtype), mesh,
                     spec_of_dims(dims[:2]))
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(out_dtype))


def _local_inputs(cache_leaf: torch.Tensor, *ts: torch.Tensor):
    """The cache leaf's :func:`shard_dims`, the mesh, and ``ts`` (q, k, v
    of the new token, (B, heads, 1, dh)) as this rank's plain shards: the
    batch rows and kv heads the rank holds of the cache (the q heads of
    its kv heads; the token's one slot unsplit).  Without a mesh the
    tensors pass untouched."""
    dims = shard_dims(cache_leaf)
    mesh = current_mesh()
    if mesh is None:
        return dims, None, ts
    spec = spec_of_dims(dims[:2])
    return dims, mesh, tuple(local_shard(t, mesh, spec) for t in ts)


def decode_gqa(p: dict, cache: dict, x: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig, opts: KernelOptions, *,
               window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step. x (B,1,d) -> ((B,1,d), cache).

    ``pos`` scalar int32: the classic shared-ring path — every row is at
    the same position, the write lands in ring slot ``pos % w``, and
    validity comes from the shared ``slot_pos`` map.

    ``pos`` vector (B,) int32: per-row positions for paged per-request
    caches — row b writes slot ``pos[b]`` (contiguous layout: slot index
    == absolute position, so the cache seq capacity must be the full
    max_len) and validity is ``slot <= pos[b]``; ``slot_pos`` passes
    through untouched.  Rows whose position is out of range (>= w) write
    nothing, which is what lets chunked prefill keep inactive rows
    harmless.

    The cache is updated in place and returned.  Under a mesh the cache
    leaves are DTensors placed by their axes, and each rank writes and
    attends on its own shard (:func:`_local_inputs`): a slot is written
    by the rank that holds it, and where the slots are split (the
    ``seq`` cache layout) the softmax is split over the ranks
    (:func:`softmax_weighted`).  Nothing of the cache's size moves.
    """
    if pos.ndim == 1:
        return _decode_gqa_rows(p, cache, x, pos, cfg, opts, window=window)
    q, k, v = _project_qkv(p, x, cfg, opts, pos[None])
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    w = ck.shape[2]
    dims, mesh, (q, k, v) = _local_inputs(ck, q, k, v)
    ckl, cvl, sposl = local_view(ck), local_view(cv), local_view(spos)
    s0, wl = local_start(ck, 2), ckl.shape[2]
    pos = local_view(pos)
    slot = torch.remainder(pos, w).to(torch.long).reshape(1)
    # the slot's offset in this rank's shard; a rank that does not hold
    # it keeps its slots (one index, clamped into range)
    loc = slot - s0
    own = ((loc >= 0) & (loc < wl)) if dims[2] else None
    idx = loc.clamp(0, wl - 1)
    _put(ckl, 2, idx, k.to(ckl.dtype), own)
    _put(cvl, 2, idx, v.to(cvl.dtype), own)
    sposl.index_copy_(0, slot, pos.to(sposl.dtype).reshape(1))
    span = sposl[s0:s0 + wl]
    valid = (span >= 0) & (span <= pos)
    if window is not None:
        valid &= span > pos - window
    y = _attend(p, q, ckl, cvl, valid, cfg, x.dtype, dims, mesh)
    return y, {"k": ck, "v": cv, "slot_pos": spos}


def _decode_gqa_rows(p: dict, cache: dict, x: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig,
                     opts: KernelOptions, *,
                     window: int | None = None) -> tuple[torch.Tensor, dict]:
    """Vector-pos decode: row b at position pos[b] (see :func:`decode_gqa`)."""
    q, k, v = _project_qkv(p, x, cfg, opts, pos[:, None, None])
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[2]
    dims, mesh, (q, k, v) = _local_inputs(ck, q, k, v)
    ckl, cvl = local_view(ck), local_view(cv)
    b0, bl = local_start(ck, 0), ckl.shape[0]
    s0, wl = local_start(ck, 2), ckl.shape[2]
    pos = local_view(pos)[b0:b0 + bl]
    # One slot per row: an in-range row writes its new k/v at pos[b] on
    # the rank that holds the slot; any other row rewrites a slot with
    # the value already there.
    rows = torch.arange(bl, device=ckl.device)
    loc = pos.clamp(0, w - 1).to(torch.long) - s0
    keep = (pos < w) & (loc >= 0) & (loc < wl)
    slots = loc.clamp(0, wl - 1)
    keep = keep[:, None, None]
    ckl[rows, :, slots] = torch.where(keep, k[:, :, 0].to(ckl.dtype),
                                      ckl[rows, :, slots])
    cvl[rows, :, slots] = torch.where(keep, v[:, :, 0].to(cvl.dtype),
                                      cvl[rows, :, slots])
    span = s0 + torch.arange(wl, dtype=pos.dtype, device=ckl.device)
    valid = span[None, :] <= pos[:, None]               # contiguous prefix
    if window is not None:
        valid &= span[None, :] > pos[:, None] - window
    y = _attend(p, q, ckl, cvl, valid[:, None, None, :], cfg, x.dtype,
                dims, mesh)
    return y, {"k": ck, "v": cv, "slot_pos": cache["slot_pos"]}
