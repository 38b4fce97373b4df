"""Plain PyTorch attention (causal / sliding-window / GQA): the numerical
oracle (reference ``ref.py``).

``banded_attention`` is the sliding-window formulation that materializes
only the (S, 2W) diagonal band of scores instead of the full (S, S)
matrix; the ``swa_impl`` spec point selects it.

Beyond :data:`SCORE_BYTES` of fp32 scores, ``attention`` forms them a
block of heads at a time: the same function, in pieces that fit beside a
large model's weights (deepseek-v2's 128 heads at S = 4096 would hold
8.6 GB of scores at once, several times over).

A query row with no valid column (only possible with ``q_offset < 0``)
gets the mean of ``v`` here, as in the reference's oracle (its softmax over
all-``NEG_INF`` scores is uniform); the CUDA kernel, like the reference's
Pallas kernel, writes 0 there.
"""
from __future__ import annotations

import torch

__all__ = ["attention", "banded_attention", "NEG_INF"]

NEG_INF = -1e30
#: the most fp32 scores (bytes) ``attention`` forms at once
SCORE_BYTES = 2 ** 31


def _repeat_kv(k: torch.Tensor, v: torch.Tensor,
               group: int) -> tuple[torch.Tensor, torch.Tensor]:
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    return k, v


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True).clamp_min(1e-30)


def attention(
    q: torch.Tensor,            # (B, H, Sq, D)
    k: torch.Tensor,            # (B, Hk, Skv, D)
    v: torch.Tensor,            # (B, Hk, Skv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,  # sliding window size (cols > row-window)
    scale: float | None = None,
    q_offset: int | None = None,  # position of q[0] within kv; default Skv-Sq
) -> torch.Tensor:
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if h % hk:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    k, v = _repeat_kv(k, v, h // hk)
    scale = scale if scale is not None else d ** -0.5
    q_offset = q_offset if q_offset is not None else skv - sq
    step = max(1, SCORE_BYTES // (4 * b * sq * max(skv, 1)))
    if step < h:
        return torch.cat([
            attention(q[:, i:i + step], k[:, i:i + step], v[:, i:i + step],
                      causal=causal, window=window, scale=scale,
                      q_offset=q_offset)
            for i in range(0, h, step)], 1)

    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", _softmax_rows(s),
                       v.to(torch.float32))
    return out.to(q.dtype)


def banded_attention(
    q: torch.Tensor,            # (B, H, S, D)
    k: torch.Tensor,            # (B, Hk, S, D)
    v: torch.Tensor,            # (B, Hk, S, Dv)
    *,
    window: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal sliding-window attention over the diagonal band only.

    Equivalent to ``attention(..., causal=True, window=window)`` for
    self-attention (q_offset == 0); scores cost O(S * 2W) instead of
    O(S^2).  Requires S % window == 0.
    """
    b, h, s, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    w = window
    if s % w:
        raise ValueError(f"sequence {s} is not a multiple of window {w}")
    k, v = _repeat_kv(k, v, h // hk)
    scale = scale if scale is not None else d ** -0.5
    nb = s // w

    qb = q.reshape(b, h, nb, w, d)
    kb = k.reshape(b, h, nb, w, d)
    vb = v.reshape(b, h, nb, w, dv)
    # previous kv block (block 0's previous is masked out)
    k_prev = torch.cat([torch.zeros_like(kb[:, :, :1]), kb[:, :, :-1]], 2)
    v_prev = torch.cat([torch.zeros_like(vb[:, :, :1]), vb[:, :, :-1]], 2)
    k2 = torch.cat([k_prev, kb], 3)                 # (B,H,nb,2W,D)
    v2 = torch.cat([v_prev, vb], 3)                 # (B,H,nb,2W,Dv)

    sc = torch.einsum("bhnqd,bhnkd->bhnqk", qb.to(torch.float32),
                      k2.to(torch.float32)) * scale
    r = torch.arange(w, device=q.device)[:, None]
    c = torch.arange(2 * w, device=q.device)[None, :]
    mask = (c <= w + r) & (c > r)                   # causal + window
    first = (c >= w) & (c <= w + r)                 # block 0: no prev block
    block0 = torch.arange(nb, device=q.device)[:, None, None] == 0
    sc = torch.where(torch.where(block0, first[None], mask[None]), sc,
                     NEG_INF)
    out = torch.einsum("bhnqk,bhnkv->bhnqv", _softmax_rows(sc),
                       v2.to(torch.float32))
    return out.reshape(b, h, s, dv).to(q.dtype)
