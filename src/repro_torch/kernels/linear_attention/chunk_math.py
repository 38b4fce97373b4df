"""Chunked linear-attention recurrence — the shared engine of RWKV6 (Finch)
and Mamba-style SSM heads (Hymba), in plain PyTorch.

The port of the reference's leaf module
(``src/repro/kernels/linear_attention/chunk_math.py``): it imports nothing
but torch, so both the kernel oracle (:mod:`.ref`) and the model layers
(:mod:`repro_torch.models.chunk_scan` re-exports it) depend on it.

Computes, per head, the gated linear recurrence

    S_t = diag(w_t) . S_{t-1} + k_t v_t^T            (state: (dk, dv))
    o_t = q_t . S_{t-1} + (q_t . (u (.) k_t)) v_t     (exclusive, RWKV6)
    o_t = q_t . S_t                                   (inclusive, SSM)

in chunks: within a chunk everything is dense products; across chunks the
per-chunk summaries (total decay, decayed kv sum) compose into the state
entering each chunk.  The reference composes them with
``lax.associative_scan``; PyTorch has no stable one, so this module folds
them with a loop over the chunks — the same sums in another order, exact up
to fp32 rounding.  It is the oracle, not a fast path.

Every function takes any leading batch dims (``(..., T, dk)``), where the
reference's take one head and are ``vmap``-ed.

Numerics: everything is computed in fp32 whatever the inputs' dtype, as
in the reference, or in float64 where an input is float64 (a witness of
the fp32 rounding; the reference has no such mode).  The per-step
log-decay must be clamped (``>= -1`` in the models) so the within-chunk
``exp(-cumsum(log w))`` factors stay fp32-finite (at most ``exp(64)`` at
chunk 64).  The per-step oracle applies the same math, so
the chunked form is exact up to fp32 roundoff, not an approximation.
"""
from __future__ import annotations

import torch

__all__ = ["chunked_linear_attention", "step_linear_attention",
           "naive_linear_attention"]

_F32 = torch.float32


def _acc(*ts) -> torch.dtype:
    """The accumulation dtype: fp32, or float64 if any input is."""
    return (torch.float64 if any(t is not None and t.dtype == torch.float64
                                 for t in ts) else _F32)


def chunked_linear_attention(
    q: torch.Tensor,          # (..., T, dk)
    k: torch.Tensor,          # (..., T, dk)
    v: torch.Tensor,          # (..., T, dv)
    log_w: torch.Tensor,      # (..., T, dk) or (..., T, 1): log decay (<= 0)
    *,
    bonus: torch.Tensor | None = None,      # (..., dk) RWKV "u" (exclusive)
    inclusive: bool = False,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,  # (..., dk, dv)
    return_state: bool = False,
):
    """Returns o (..., T, dv) in ``v.dtype`` [and the final fp32 (float64
    for float64 inputs) state (..., dk, dv) if requested]."""
    *lead, t, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of chunk {chunk}")
    nc = t // chunk
    acc = _acc(q, k, v, log_w)

    qc = q.to(acc).reshape(*lead, nc, chunk, dk)
    kc = k.to(acc).reshape(*lead, nc, chunk, dk)
    vc = v.to(acc).reshape(*lead, nc, chunk, dv)
    lw = log_w.to(acc).expand(*lead, t, dk).reshape(*lead, nc, chunk, dk)

    la = torch.cumsum(lw, dim=-2)                  # (..., nc, c, dk) inclusive
    la_prev = la - lw                              # exclusive (la_{i-1})
    la_tot = la[..., -1, :]                        # (..., nc, dk)

    # Chunk summaries: total decay + decayed kv sum.
    k_dec = kc * torch.exp(la_tot[..., None, :] - la)
    s_add = torch.einsum("...nck,...ncv->...nkv", k_dec, vc)
    decay = torch.exp(la_tot)

    # The state entering each chunk, folded chunk by chunk from S0.
    state = (init_state.to(acc) if init_state is not None
             else q.new_zeros((*lead, dk, dv), dtype=acc))
    entering = []
    for n in range(nc):
        entering.append(state)
        state = decay[..., n, :, None] * state + s_add[..., n, :, :]
    s_enter = torch.stack(entering, dim=-3)        # (..., nc, dk, dv)

    la_q = la if inclusive else la_prev
    qt = qc * torch.exp(la_q)
    kt = kc * torch.exp(-la)                       # bounded by the clamp
    scores = torch.einsum("...nck,...nsk->...ncs", qt, kt)
    idx = torch.arange(chunk, device=q.device)
    mask = (idx[:, None] >= idx[None, :]) if inclusive \
        else (idx[:, None] > idx[None, :])
    scores = torch.where(mask, scores, torch.zeros((), dtype=acc,
                                                    device=q.device))
    if bonus is not None and not inclusive:
        u = bonus.to(acc)[..., None, None, :]
        diag = (qc * u * kc).sum(-1)               # (..., nc, c)
        scores = scores + diag[..., :, None] * torch.eye(
            chunk, dtype=acc, device=q.device)
    intra = torch.einsum("...ncs,...nsv->...ncv", scores, vc)
    inter = torch.einsum("...nck,...nkv->...ncv", qt, s_enter)
    o = (intra + inter).reshape(*lead, t, dv).to(v.dtype)
    if not return_state:
        return o
    return o, state


def step_linear_attention(
    q: torch.Tensor,          # (..., dk)
    k: torch.Tensor,          # (..., dk)
    v: torch.Tensor,          # (..., dv)
    log_w: torch.Tensor,      # (..., dk) or (..., 1)
    state: torch.Tensor,      # (..., dk, dv)
    *,
    bonus: torch.Tensor | None = None,   # broadcastable to q
    inclusive: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. Returns (o (..., dv) in ``v.dtype``, new fp32
    state (float64 for float64 inputs))."""
    acc = _acc(q, k, v, log_w, state)
    q32, k32, v32 = q.to(acc), k.to(acc), v.to(acc)
    s32 = state.to(acc)
    w = torch.exp(log_w.to(acc).expand_as(q32))
    kv = k32[..., :, None] * v32[..., None, :]
    new_state = w[..., :, None] * s32 + kv
    if inclusive:
        o = torch.einsum("...kv,...k->...v", new_state, q32)
    else:
        o = torch.einsum("...kv,...k->...v", s32, q32)
        if bonus is not None:
            o = o + (q32 * bonus.to(acc) * k32).sum(-1, keepdim=True) * v32
    return o.to(v.dtype), new_state


def naive_linear_attention(q, k, v, log_w, *, bonus=None, inclusive=False,
                           init_state=None, return_state=False):
    """Per-step oracle (a loop over T) — tests only; O(T) serial."""
    *lead, t, dk = q.shape
    dv = v.shape[-1]
    acc = _acc(q, k, v, log_w, init_state)
    state = (init_state.to(acc) if init_state is not None
             else q.new_zeros((*lead, dk, dv), dtype=acc))
    lw = log_w.expand(*lead, t, dk)
    outs = []
    for i in range(t):
        o, state = step_linear_attention(
            q[..., i, :], k[..., i, :], v[..., i, :], lw[..., i, :], state,
            bonus=bonus, inclusive=inclusive)
        outs.append(o)
    o = torch.stack(outs, dim=-2)
    if return_state:
        return o, state
    return o
