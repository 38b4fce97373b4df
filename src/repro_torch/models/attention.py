"""GQA attention (prefill + cached decode), with qk-norm and sliding window.

The port of the reference's ``models/attention.py``: the full-sequence
``apply_gqa`` (prefill, through the attention op and its flash-attention
kernel), the shared-ring decode (scalar ``pos``) and the per-row decode
(vector ``pos``) that the serve step runs.

Cache writes are in place (``index_copy_`` / ``index_put_``) where the
reference rebuilds the whole cache with ``jnp.where`` /
``dynamic_update_slice``: the write touches one slot per row instead of
copying every layer's cache each token.  The returned cache holds the
same tensors as the one passed in.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              local_shard, logical_to_spec,
                                              placements, replicate,
                                              shard_index)
from repro_torch.kernels.attention import attention as attn_op
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.models.common import (KernelOptions, apply_rope, dense_init,
                                       rms_norm_pair, rope)
from repro_torch.models.config import ModelConfig

__all__ = ["init_gqa", "gqa_axes", "apply_gqa", "init_gqa_cache",
           "gqa_cache_axes", "decode_gqa", "sharded_attention"]


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


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 opts: KernelOptions, positions: torch.Tensor):
    """x (B,S,d) -> q (B,H,S,dh), k/v (B,Hk,S,dh) with rope applied."""
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(cdt))
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
    scores.  Where the kv heads stay replicated (their count does not
    divide the dim) a rank takes the kv heads of its own q heads, and its
    gradient for k and v is a partial sum over the heads' mesh dims.
    Returns a DTensor placed as q's shards (a plain tensor without a
    mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return attn_op(q, k, v, **kw)
    from torch.distributed.tensor import DTensor
    q_spec = logical_to_spec(("batch", "heads"), q.shape, mesh)
    kv_spec = logical_to_spec(("batch", kv_axis), k.shape, mesh)
    heads = q_spec[1] if len(q_spec) > 1 else None
    heads = (heads,) if isinstance(heads, str) else (heads or ())
    kv_split = len(kv_spec) > 1 and kv_spec[1] is not None
    partial = {n: "partial" for n in heads} if not kv_split else None
    ql = local_shard(q, mesh, q_spec)
    kl, vl = (local_shard(t, mesh, kv_spec, partial) for t in (k, v))
    if heads and not kv_split:
        # the kv heads of this rank's q heads: one per group of them, or
        # one per q head where the rank's heads split a group
        h_loc, g = ql.shape[1], q.shape[1] // k.shape[1]
        first = shard_index(mesh, heads) * h_loc
        idx = torch.arange(first, first + h_loc, device=ql.device) // g
        if h_loc % g == 0:
            idx = idx[::g]
        kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
    out = attn_op(ql, kl, vl, **kw)
    return DTensor.from_local(out, mesh, placements(q_spec, mesh),
                              run_check=False)


def attention_inputs(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The decode attention's inputs under a mesh: the batch dim sharded,
    the heads replicated (the cached steps attend over a replicated copy
    of the cache, see ``training.steps._cached_step``; the plain products
    fold (batch, heads) into one dim, which DTensor refuses while the
    heads dim is sharded); without a mesh they pass untouched."""
    return tuple(constrain(t, ("batch", None, None, None)) for t in ts)


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


def _attend(p: dict, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
            valid: torch.Tensor, cfg: ModelConfig,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Softmax attention of q (B,H,1,dh) over the cache, masked by
    ``valid`` (broadcastable to (B,Hk,G,w)); returns (B,1,d)."""
    b = q.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, = attention_inputs(q)
    qg = q.reshape(b, hk, h // hk, dh)
    scores = torch.einsum("bhgk,bhwk->bhgw", qg.to(torch.float32),
                          ck.to(torch.float32)) * (dh ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgw,bhwk->bhgk", probs, cv.to(torch.float32))
    out = out.reshape(b, h, 1, dh).to(out_dtype)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(out_dtype))


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

    The cache is updated in place and returned.
    """
    if pos.ndim == 1:
        return _decode_gqa_rows(p, cache, x, pos, cfg, opts, window=window)
    q, k, v = _project_qkv(p, x, cfg, opts, pos[None])
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    w = ck.shape[2]
    slot = torch.remainder(pos, w).to(torch.long).reshape(1)
    # the cache writes take replicated values under a mesh (no DTensor
    # strategy for the index writes; the step's cache is replicated)
    k, v = replicate(k), replicate(v)
    ck.index_copy_(2, slot, k.to(ck.dtype))
    cv.index_copy_(2, slot, v.to(cv.dtype))
    spos.index_copy_(0, slot, pos.to(spos.dtype).reshape(1))
    valid = (spos >= 0) & (spos <= pos)
    if window is not None:
        valid &= spos > pos - window
    y = _attend(p, q, ck, cv, valid, cfg, x.dtype)
    return y, {"k": ck, "v": cv, "slot_pos": spos}


def _decode_gqa_rows(p: dict, cache: dict, x: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig,
                     opts: KernelOptions, *,
                     window: int | None = None) -> tuple[torch.Tensor, dict]:
    """Vector-pos decode: row b at position pos[b] (see :func:`decode_gqa`)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, opts, pos[:, None, None])
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[2]
    # One slot per row: an in-range row writes its new k/v at pos[b]; an
    # out-of-range row rewrites slot w-1 with the value already there.
    rows = torch.arange(b, device=x.device)
    slots = pos.clamp(0, w - 1).to(torch.long)
    keep = (pos < w)[:, None, None]
    k, v = replicate(k), replicate(v)      # as in decode_gqa
    ck[rows, :, slots] = torch.where(keep, k[:, :, 0].to(ck.dtype),
                                     ck[rows, :, slots])
    cv[rows, :, slots] = torch.where(keep, v[:, :, 0].to(cv.dtype),
                                     cv[rows, :, slots])
    span = torch.arange(w, dtype=pos.dtype, device=x.device)
    valid = span[None, :] <= pos[:, None]               # contiguous prefix
    if window is not None:
        valid &= span[None, :] > pos[:, None] - window
    y = _attend(p, q, ck, cv, valid[:, None, None, :], cfg, x.dtype)
    return y, {"k": ck, "v": cv, "slot_pos": cache["slot_pos"]}
