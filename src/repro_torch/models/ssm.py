"""Mamba-style selective SSM heads (Hymba, arXiv:2411.13676; SSD form of
Mamba-2).

The port of the reference's ``models/ssm.py``, leaf for leaf in its
parameter layout.  Per head: a scalar input-dependent decay
``log a_t = -softplus(dt) * exp(a_log)`` (clamped to ``[LOG_A_MIN,
-1e-4]`` for fp32-safe chunking), B/C projections shared by the heads
(``ssm_state`` = N), a short causal depthwise conv on the input and a skip
term D.

The full-sequence forward runs the chunked linear attention (its CUDA
kernel under ``linear_attention_impl=cuda``) with the inclusive read, no
bonus, q = C and k = B broadcast over the heads and the decay as
``(B*H, S, 1)``.  Decode advances the ``(B, H, N, dh)`` state with one
batched step over (batch, head) and keeps the conv's last ``_CONV_K - 1``
inputs; both cache leaves are written in place, as the port's other
caches are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              from_local, is_dtensor,
                                              local_shard, logical_to_spec,
                                              shard_dims, spec_of_dims,
                                              write_local)
from repro_torch.kernels.linear_attention import linear_attention
from repro_torch.models.chunk_scan import step_linear_attention
from repro_torch.models.common import KernelOptions, dense_init
from repro_torch.models.config import ModelConfig

__all__ = ["init_ssm", "ssm_axes", "apply_ssm", "init_ssm_cache",
           "ssm_cache_axes", "decode_ssm", "LOG_A_MIN"]

LOG_A_MIN = -1.0        # per-step log-decay clamp (fp32-safe chunking)
_CONV_K = 4


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_heads * cfg.d_head


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    d = cfg.d_model
    di = _d_inner(cfg)
    n, h = cfg.ssm_state, cfg.ssm_heads
    full = lambda value: torch.full((h,), value, dtype=torch.float32,
                                    device=gen.device)
    return {
        "w_in": dense_init(gen, (d, di)),
        "conv": dense_init(gen, (_CONV_K, di)) * 0.5,
        "w_b": dense_init(gen, (d, n)),
        "w_c": dense_init(gen, (d, n)),
        "w_dt": dense_init(gen, (d, h)),
        "dt_bias": full(0.0),
        "a_log": full(0.0),
        "skip_d": full(1.0),
        "w_out": dense_init(gen, (di, d)),
    }


def ssm_axes(cfg: ModelConfig) -> dict:
    return {
        "w_in": ("fsdp", "heads"), "conv": (None, "heads"),
        "w_b": ("fsdp", "state"), "w_c": ("fsdp", "state"),
        "w_dt": ("fsdp", None), "dt_bias": (None,), "a_log": (None,),
        "skip_d": (None,), "w_out": ("heads", "fsdp"),
    }


def _conv_causal(xi: torch.Tensor, kern: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. xi (B,S,di), kern (K,di); ``state`` (B,K-1,di)
    holds the inputs before the first (zeros without)."""
    k = kern.shape[0]
    if state is None:
        xp = F.pad(xi, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(xi.dtype), xi], dim=1)   # (B, S+K-1, di)
    s = xi.shape[1]
    out = xp[:, 0:s] * kern[0].to(xi.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * kern[i].to(xi.dtype)
    return out


def _conv_placed(xi: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """:func:`_conv_causal` of the full sequence; under a mesh on each
    rank's own rows and channels (the conv is depthwise: rows and
    channels are independent; the sequence gathered, as each position
    needs the ones before it).  DTensor's pad fails to plan its
    redistribution on some releases (torch 2.11 at hymba's 16-way
    channel split)."""
    if not is_dtensor(xi):
        return _conv_causal(xi, kern)
    mesh = xi.device_mesh
    rows, _, chans = shard_dims(xi)
    spec = spec_of_dims((rows, (), chans))
    out = _conv_causal(local_shard(xi, mesh, spec),
                       local_shard(kern, mesh, spec_of_dims(((), chans)),
                                   {n: "partial" for n in rows}))
    return from_local(out, mesh, spec)


def _gates(p: dict, x: torch.Tensor):
    """x (B,S,d) -> B (B,S,N), C (B,S,N), dt (B,S,H), log_a (B,S,H); dt and
    log_a in fp32 (float64 for a float64 ``x``)."""
    cdt = x.dtype
    acc = torch.promote_types(cdt, torch.float32)
    bmat = x @ p["w_b"].to(cdt)
    cmat = x @ p["w_c"].to(cdt)
    dt = F.softplus(x.to(acc) @ p["w_dt"].to(acc) + p["dt_bias"].to(acc))
    log_a = torch.clamp(-dt * torch.exp(p["a_log"].to(acc)), LOG_A_MIN,
                        -1e-4)
    return bmat, cmat, dt, log_a


def _split_heads(x: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """``x (..., h * dh) -> (..., h, dh)``.  Under a mesh whose dims the
    head count does not divide (25 heads on a 16-way model dim), the last
    dim is gathered first: DTensor cannot unflatten a shard of it."""
    if current_mesh() is not None and not logical_to_spec(("heads",), (h,)):
        x = constrain(x, ("batch",) + (None,) * (x.ndim - 1))
    return x.reshape(*x.shape[:-1], h, dh)


def apply_ssm(p: dict, x: torch.Tensor, cfg: ModelConfig,
              opts: KernelOptions) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d)."""
    b, s, _ = x.shape
    h, dh, n = cfg.ssm_heads, cfg.d_head, cfg.ssm_state
    cdt = x.dtype
    xi = F.silu(_conv_placed(x @ p["w_in"].to(cdt), p["conv"]))
    bmat, cmat, dt, log_a = _gates(p, x)
    xh = _split_heads(xi, h, dh)
    v = xh * dt.to(cdt)[..., None]                    # dt-scaled input
    # under a mesh the scan runs on each rank's batch rows (rows are
    # independent; DTensor cannot fold the sharded batch into (B*H) rows)
    mesh = current_mesh()
    spec = logical_to_spec(("batch",), (b,)) if mesh is not None else ()
    if mesh is not None:
        cmat, bmat, v, log_a = (local_shard(t, mesh, spec)
                                for t in (cmat, bmat, v, log_a))
    bl = v.shape[0]
    # per (batch, head): q = C (S,N), k = B (S,N), v (S,dh), decay (S,1)
    qb = cmat[:, None].expand(bl, h, s, n).reshape(bl * h, s, n)
    kb = bmat[:, None].expand(bl, h, s, n).reshape(bl * h, s, n)
    vb = v.transpose(1, 2).reshape(bl * h, s, dh)
    wb = log_a.transpose(1, 2).reshape(bl * h, s, 1)
    o = linear_attention(qb, kb, vb, wb, inclusive=True,
                         chunk=min(opts.chunk_len, s),
                         impl=opts.impl_for("linear_attention"))
    o = o.reshape(bl, h, s, dh).transpose(1, 2)       # (B,S,H,dh)
    o = from_local(o, mesh, spec)
    o = o + xh * p["skip_d"].to(cdt)[None, None, :, None]
    return constrain(o.reshape(b, s, h * dh) @ p["w_out"].to(cdt),
                     ("batch", "seq", None))


def init_ssm_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                   window: int | None = None,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str | None = None) -> dict:
    """Recurrent row state: the fp32 ``(B, H, N, dh)`` state and the conv's
    last ``_CONV_K - 1`` inputs in ``dtype``.  O(1) in sequence length
    (``max_len`` and ``window`` are unused); ``device`` defaults to
    ``cuda`` (:func:`compat.resolve_device`)."""
    del max_len, window
    device = compat.resolve_device(device)
    h, dh, n = cfg.ssm_heads, cfg.d_head, cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, n, dh), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, _d_inner(cfg)), dtype=dtype,
                            device=device),
    }


def ssm_cache_axes(cfg: ModelConfig) -> dict:
    return {"state": ("batch", "heads", "state", None),
            "conv": ("batch", None, "heads")}


def decode_ssm(p: dict, cache: dict, x: torch.Tensor, pos,
               cfg: ModelConfig, opts: KernelOptions,
               **_) -> tuple[torch.Tensor, dict]:
    """One step. x (B,1,d) -> ((B,1,d), cache); ``state`` and ``conv`` are
    written in place (``pos`` is unused: the state is the whole history).
    The reference's vmap over (batch, head) is the batch dims of one
    :func:`step_linear_attention` call."""
    b = x.shape[0]
    h, dh, n = cfg.ssm_heads, cfg.d_head, cfg.ssm_state
    cdt = x.dtype
    xin = x @ p["w_in"].to(cdt)                        # (B,1,di)
    conv = cache["conv"]
    xi = F.silu(_conv_causal(xin, p["conv"], conv))[:, 0]
    new_conv = torch.cat([conv[:, 1:], xin.to(conv.dtype)], dim=1)
    bmat, cmat, dt, log_a = (t[:, 0] for t in _gates(p, x))
    xh = _split_heads(xi, h, dh)
    v = xh * dt.to(cdt)[..., None]
    o, new_state = step_linear_attention(
        cmat[:, None].expand(b, h, n), bmat[:, None].expand(b, h, n), v,
        log_a[..., None], cache["state"], inclusive=True)
    o = o + xh * p["skip_d"].to(cdt)[None, :, None]
    y = (o.reshape(b, h * dh) @ p["w_out"].to(cdt))[:, None]
    # under a mesh each rank writes its own rows and heads of the state
    write_local(cache["state"], new_state)
    write_local(conv, new_conv)
    return y, cache
