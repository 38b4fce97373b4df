"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of the reference's ``models/mla.py``.  Prefill: q/k/v are
materialized from low-rank latents and run through the flash attention
op (the kernel, under ``attention_impl=cuda``) with q/k head dim
``nope + rope`` and v head dim ``d_head``; the two latent norms go
through the RMSNorm op.

Decode: the **absorbed** form — scores are computed directly against the
cached ``(kv_lora + rope_head_dim)``-wide latent (W_uk absorbed into the
query, W_uv applied after attention), so the cache is ~1/``n_heads`` the
size of a GQA cache.  It is plain tensor code, as in the reference.

Cache writes are in place, as in :mod:`repro_torch.models.attention`: the
returned cache holds the tensors passed in; under a mesh each rank writes
and attends on its own shard of it.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              from_local, local_shard,
                                              local_start, local_view,
                                              shard_dims, spec_of_dims)
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.models.attention import (_put, sharded_attention,
                                          softmax_weighted)
from repro_torch.models.common import (KernelOptions, apply_rope, dense_init,
                                       rms_norm, rope)
from repro_torch.models.config import ModelConfig

__all__ = ["init_mla", "mla_axes", "apply_mla", "init_mla_cache",
           "mla_cache_axes", "decode_mla"]


def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, dh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.d_head
    ones = lambda n: torch.ones((n,), dtype=torch.float32, device=gen.device)
    return {
        "w_dq": dense_init(gen, (d, qr)),
        "q_norm": ones(qr),
        "w_uq": dense_init(gen, (qr, h, nd + rd)),
        "w_dkv": dense_init(gen, (d, kvr)),
        "kv_norm": ones(kvr),
        "w_kr": dense_init(gen, (d, rd)),
        "w_uk": dense_init(gen, (kvr, h, nd)),
        "w_uv": dense_init(gen, (kvr, h, dh)),
        "wo": dense_init(gen, (h, dh, d), in_axis=0),
    }


def mla_axes(cfg: ModelConfig) -> dict:
    return {
        "w_dq": ("fsdp", None),
        "q_norm": (None,),
        "w_uq": ("fsdp", "heads", "head_dim"),
        "w_dkv": ("fsdp", None),
        "kv_norm": (None,),
        "w_kr": ("fsdp", None),
        "w_uk": ("fsdp", "heads", "head_dim"),
        "w_uv": ("fsdp", "heads", "head_dim"),
        "wo": ("heads", "head_dim", "fsdp"),
    }


def _latents(p: dict, x: torch.Tensor, cfg: ModelConfig,
             opts: KernelOptions, positions: torch.Tensor):
    """Shared by all paths: q heads (nope, rope) (B,H,S,·), the normalised
    kv latent (B,S,kv_lora) and the rotary shared key (B,1,S,rope)."""
    cdt = x.dtype
    nd = cfg.nope_head_dim
    cq = rms_norm(x @ p["w_dq"].to(cdt), p["q_norm"], cfg.rms_eps, opts)
    q = torch.einsum("bsr,rhk->bhsk", cq, p["w_uq"].to(cdt))
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    ckv = rms_norm(x @ p["w_dkv"].to(cdt), p["kv_norm"], cfg.rms_eps, opts)
    k_rope = (x @ p["w_kr"].to(cdt))[:, None]           # (B,1,S,rd)
    cos, sin = rope(positions, cfg.rope_head_dim, cfg.rope_theta)
    return (q_nope, apply_rope(q_rope, cos, sin), ckv,
            apply_rope(k_rope, cos, sin))


def apply_mla(p: dict, x: torch.Tensor, cfg: ModelConfig,
              opts: KernelOptions, *, window: int | None = None,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Materialized prefill path. x (B,S,d) -> (B,S,d)."""
    b, s, _ = x.shape
    h, nd, rd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, opts, positions)
    cdt = x.dtype
    k_nope = torch.einsum("bsr,rhk->bhsk", ckv, p["w_uk"].to(cdt))
    v = torch.einsum("bsr,rhk->bhsk", ckv, p["w_uv"].to(cdt))
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, rd)], -1)
    q = constrain(q, ("batch", "heads", "seq", "head_dim"))
    k = constrain(k, ("batch", "heads", "seq", "head_dim"))
    v = constrain(v, ("batch", "heads", "seq", "head_dim"))
    out = sharded_attention(q, k, v, kv_axis="heads", causal=True,
                            window=window, scale=(nd + rd) ** -0.5,
                            block_q=opts.block_q, block_kv=opts.block_kv,
                            impl=opts.impl_for("attention"))  # (B,H,S,dh)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(cdt))
    return constrain(y, ("batch", "seq", None))


# -- absorbed decode ---------------------------------------------------------

def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int | None = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str | None = None) -> dict:
    """The latent cache: ``ckv`` and ``k_rope`` rows per slot, and the
    shared ``slot_pos`` map; ``device`` defaults to ``cuda``
    (:func:`compat.resolve_device`)."""
    device = compat.resolve_device(device)
    w = min(window, max_len) if window else max_len
    return {
        "ckv": torch.zeros((batch, w, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, w, cfg.rope_head_dim), dtype=dtype,
                              device=device),
        "slot_pos": torch.full((w,), -1, dtype=torch.int32, device=device),
    }


def mla_cache_axes(cfg: ModelConfig) -> dict:
    return {
        "ckv": ("batch", "seq_kv", None),
        "k_rope": ("batch", "seq_kv", None),
        "slot_pos": (None,),
    }


def _absorbed(p: dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
              ckv: torch.Tensor, k_rope: torch.Tensor, cache: dict,
              cfg: ModelConfig, cdt: torch.dtype):
    """The absorbed query (``W_uk`` folded in) and the new token's latent
    and rotary key as this rank's plain shards: the batch rows it holds
    of the latent cache, every head.  Returns ``(dims, mesh, q_eff (b,H,r),
    q_rope (b,H,1,rd), ckv (b,1,r), k_rope (b,1,1,rd))``; without a mesh
    the tensors pass as they are."""
    q_eff = torch.einsum("bhsk,rhk->bhr", q_nope, p["w_uk"].to(cdt))
    dims = shard_dims(cache["ckv"])
    mesh = current_mesh()
    ts = (q_eff, q_rope, ckv, k_rope)
    if mesh is not None:
        spec = spec_of_dims(dims[:1])
        ts = tuple(local_shard(t, mesh, spec) for t in ts)
    return (dims, mesh) + ts


def _attend_latent(p: dict, q_eff: torch.Tensor, q_rope: torch.Tensor,
                   cckv: torch.Tensor, ckr: torch.Tensor, valid: torch.Tensor,
                   cfg: ModelConfig, cdt: torch.dtype, dims: tuple,
                   mesh) -> torch.Tensor:
    """Attention of this rank's absorbed query over its shard of the
    latent cache, masked by ``valid`` (broadcastable to (b,H,w)); the
    latent output is combined over the slot shards (the split softmax of
    :func:`repro_torch.models.attention.softmax_weighted`) before
    ``W_uv`` and ``wo``.  Returns (B,1,d) (a DTensor under a mesh)."""
    f32 = torch.float32
    scores = (torch.einsum("bhr,bwr->bhw", q_eff.to(f32), cckv.to(f32))
              + torch.einsum("bhsk,bwk->bhw", q_rope.to(f32), ckr.to(f32))
              ) * ((cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    o_latent = softmax_weighted(scores, cckv.to(f32), "bhw,bwr->bhr",
                                dims[1], mesh)
    o_latent = from_local(o_latent.to(cdt), mesh, spec_of_dims(dims[:1]))
    out = torch.einsum("bhr,rhk->bhk", o_latent, p["w_uv"].to(cdt))
    return torch.einsum("bhk,hkd->bd", out, p["wo"].to(cdt))[:, None]


def decode_mla(p: dict, cache: dict, x: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig, opts: KernelOptions, *,
               window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One absorbed decode step. x (B,1,d) -> ((B,1,d), cache).

    ``pos`` scalar: the shared ring slot ``pos % w`` and ``slot_pos``
    validity (all rows in lockstep).  ``pos`` vector (B,): per-row
    contiguous slots for paged per-request caches, as
    :func:`repro_torch.models.attention.decode_gqa`; a row whose position
    is out of range writes nothing.  The cache is updated in place and
    returned; under a mesh each rank writes and attends on its own shard
    of the latent cache, as in
    :func:`repro_torch.models.attention.decode_gqa`.
    """
    if pos.ndim == 1:
        return _decode_mla_rows(p, cache, x, pos, cfg, opts, window=window)
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, opts, pos[None])
    dims, mesh, q_eff, q_rope, ckv, k_rope = _absorbed(
        p, q_nope, q_rope, ckv, k_rope, cache, cfg, x.dtype)
    cckv, ckr, spos = cache["ckv"], cache["k_rope"], cache["slot_pos"]
    ckvl, ckrl, sposl = local_view(cckv), local_view(ckr), local_view(spos)
    w = cckv.shape[1]
    s0, wl = local_start(cckv, 1), ckvl.shape[1]
    pos = local_view(pos)
    slot = torch.remainder(pos, w).to(torch.long).reshape(1)
    loc = slot - s0
    own = ((loc >= 0) & (loc < wl)) if dims[1] else None
    idx = loc.clamp(0, wl - 1)
    _put(ckvl, 1, idx, ckv.to(ckvl.dtype), own)
    _put(ckrl, 1, idx, k_rope[:, 0].to(ckrl.dtype), own)
    sposl.index_copy_(0, slot, pos.to(sposl.dtype).reshape(1))
    span = sposl[s0:s0 + wl]
    valid = (span >= 0) & (span <= pos)
    if window is not None:
        valid &= span > pos - window
    y = _attend_latent(p, q_eff, q_rope, ckvl, ckrl, valid, cfg, x.dtype,
                       dims, mesh)
    return y, {"ckv": cckv, "k_rope": ckr, "slot_pos": spos}


def _decode_mla_rows(p: dict, cache: dict, x: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig,
                     opts: KernelOptions, *,
                     window: int | None = None) -> tuple[torch.Tensor, dict]:
    """Vector-pos absorbed decode: row b at position pos[b]."""
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, opts,
                                           pos[:, None, None])
    dims, mesh, q_eff, q_rope, ckv, k_rope = _absorbed(
        p, q_nope, q_rope, ckv, k_rope, cache, cfg, x.dtype)
    cckv, ckr = cache["ckv"], cache["k_rope"]
    ckvl, ckrl = local_view(cckv), local_view(ckr)
    w = cckv.shape[1]
    b0, bl = local_start(cckv, 0), ckvl.shape[0]
    s0, wl = local_start(cckv, 1), ckvl.shape[1]
    pos = local_view(pos)[b0:b0 + bl]
    # One slot per row: an in-range row writes its latent at pos[b] on the
    # rank that holds the slot; any other row rewrites a slot with the
    # value already there.
    rows = torch.arange(bl, device=ckvl.device)
    loc = pos.clamp(0, w - 1).to(torch.long) - s0
    keep = ((pos >= 0) & (pos < w) & (loc >= 0) & (loc < wl))[:, None]
    slots = loc.clamp(0, wl - 1)
    ckvl[rows, slots] = torch.where(keep, ckv[:, 0].to(ckvl.dtype),
                                    ckvl[rows, slots])
    ckrl[rows, slots] = torch.where(keep, k_rope[:, 0, 0].to(ckrl.dtype),
                                    ckrl[rows, slots])
    span = s0 + torch.arange(wl, dtype=pos.dtype, device=ckvl.device)
    valid = span[None, :] <= pos[:, None]               # contiguous prefix
    if window is not None:
        valid &= span[None, :] > pos[:, None] - window
    y = _attend_latent(p, q_eff, q_rope, ckvl, ckrl, valid[:, None, :], cfg,
                       x.dtype, dims, mesh)
    return y, {"ckv": cckv, "k_rope": ckr, "slot_pos": cache["slot_pos"]}
