"""Step builders: where the framework's Iridescent spec points live.

Each builder is *handler code* in the paper's sense: it declares
specialization points through the :class:`SpecCtx` it receives and returns
the step function.  Re-building under a different configuration bakes
different constants (kernel implementation, tile sizes, rows per block,
cache and logits dtypes) into the closure the runtime dispatches to.

The port has the serving builders: the phase-disaggregated serve step,
the full-sequence prefill step (the path of the flash attention kernel,
and of the linear-attention kernel for rwkv6 and hymba's SSM heads) and
the single-token decode step.  They declare every spec label the
reference's builders declare.  Two candidate sets differ from the
reference's, because they are tile sizes of the Hopper kernels rather than
of the TPU's VMEM:

* ``block_q`` in (64, 128) and ``block_kv`` in (32, 64): the query and kv
  tile rows of the flash attention kernel, which stages them in fp32 in
  shared memory.  A thread block has at most 227 KB there; at d = 128 the
  (128, 64) pair takes 170 KB, while the reference's 128-1024 rows (up to
  2 MB for a (1024, 1024) pair) do not fit.
* ``norm_block_rows`` in (4,): the rows per thread block of the RMSNorm
  kernel, the one size the library instantiates until a measurement on
  the card picks others.

The train builder waits for ROADMAP M8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.specializer import SpecCtx
from repro_torch.kernels import registry as kernel_registry
from repro_torch.kernels.attention.kernel import (BLOCK_KV, BLOCK_Q,
                                                  DEFAULT_BLOCK_KV,
                                                  DEFAULT_BLOCK_Q)
from repro_torch.kernels.linear_attention.kernel import CHUNKS
from repro_torch.kernels.rmsnorm.kernel import BLOCK_ROWS, DEFAULT_BLOCK_ROWS
from repro_torch.models import transformer as model
from repro_torch.models.common import KernelOptions
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEOptions
from repro_torch.models.transformer import RunOptions

__all__ = ["SHARDING_PROFILES", "make_prefill_builder", "make_decode_builder",
           "make_serve_builder", "phase_context_fn", "run_options_from_spec"]

#: the reference's layout profiles.  The label and its candidates are kept
#: so tuned configs replay; on one device every profile is the same
#: placement (the distributed slice, ROADMAP M12, gives them meaning).
SHARDING_PROFILES = ("dp", "fsdp", "fsdp_pods", "fsdp_noexp", "seq",
                     "serve_ep")


def run_options_from_spec(spec: SpecCtx, cfg: ModelConfig, *,
                          kernel_impl: str | None = None,
                          window: int | None = None) -> RunOptions:
    """Declare the model-level spec points and bundle the chosen constants.

    The implementation choice per kernel family the step exercises
    (``rmsnorm_impl``; ``attention_impl`` for attention mixers,
    ``linear_attention_impl`` for rwkv6/hymba) has as candidates the
    registry entries *available on this host*; a choice that guard-misses
    at dispatch (a host tensor asking for ``cuda``) degrades to torch_ref
    inside the registry (paper §4.4.3).  ``block_q``/``block_kv`` are the
    flash attention kernel's tiles (see the module docstring for why their
    candidates are not the reference's); ``chunk_len`` (rwkv6/hymba) the
    linear attention's chunk, in the reference's (16, 32, 64), which the
    kernel instantiates as they are; ``swa_impl`` is declared for a
    sliding-window model or ``window`` override only.  A MoE model
    declares the reference's dispatch points with its labels, candidates
    and defaults: ``moe_impl`` (einsum, gather, shard — ``shard`` runs
    ``gather`` until the port has a mesh, ROADMAP M12),
    ``capacity_factor``, ``moe_group`` and ``moe_ranking``.
    ``logits_dtype`` sets the full-sequence forward's logits (decode logits
    are always fp32, as in the reference).  The training points
    (``remat``, gradient-safe implementations) arrive with the train
    builder (ROADMAP M8).
    """
    model.check_supported(cfg)
    uses_attention = cfg.mixer in ("attn", "hymba")
    uses_linear_attention = cfg.mixer in ("rwkv6", "hymba")
    ko = KernelOptions(
        impl=kernel_impl,
        rmsnorm_impl=kernel_registry.impl_point(spec, "rmsnorm",
                                                default=kernel_impl),
        attention_impl=(kernel_registry.impl_point(spec, "attention",
                                                   default=kernel_impl)
                        if uses_attention else None),
        linear_attention_impl=(
            kernel_registry.impl_point(spec, "linear_attention",
                                       default=kernel_impl)
            if uses_linear_attention else None),
        block_q=spec.enum("block_q", DEFAULT_BLOCK_Q, BLOCK_Q,
                          guarded=False),
        block_kv=spec.enum("block_kv", DEFAULT_BLOCK_KV, BLOCK_KV,
                           guarded=False),
        norm_block_rows=spec.enum("norm_block_rows", DEFAULT_BLOCK_ROWS,
                                  BLOCK_ROWS, guarded=False),
        chunk_len=(spec.enum("chunk_len", 64, CHUNKS, guarded=False)
                   if uses_linear_attention else 64),
        swa_impl=(spec.enum("swa_impl", "full", ("full", "banded"),
                            guarded=False)
                  if (cfg.window or window) else "full"),
    )
    moe = MoEOptions()
    if cfg.is_moe:
        moe = MoEOptions(
            impl=spec.enum("moe_impl", "einsum",
                           ("einsum", "gather", "shard"), guarded=False),
            capacity_factor=spec.enum("capacity_factor", 1.25,
                                      (1.0, 1.25, 1.5, 2.0), guarded=False),
            group_size=spec.enum("moe_group", 0, (0, 1024, 4096),
                                 guarded=False),
            ranking=spec.enum("moe_ranking", "cumsum", ("cumsum", "sort"),
                              guarded=False),
        )
    return RunOptions(
        kernels=ko, moe=moe, window=window,
        logits_dtype=spec.enum("logits_dtype", "float32",
                               ("float32", "bfloat16"), guarded=False))


def _declare_sharding(spec: SpecCtx) -> None:
    """The reference's layout profile, declared for replay: on one device
    every profile is the same placement (ROADMAP M12 gives them
    meaning)."""
    spec.enum("sharding_profile", "fsdp", SHARDING_PROFILES, guarded=False)


def _with_cache_points(spec: SpecCtx, opts: RunOptions) -> RunOptions:
    """The cached steps' points: the KV cache dtype, and the cache layout
    (declared for replay; one device has one layout)."""
    opts = dataclasses.replace(opts, decode_cache_dtype=spec.enum(
        "cache_dtype", "bfloat16", ("bfloat16", "float32"), guarded=False))
    _declare_sharding(spec)
    spec.enum("cache_layout", "seq", ("seq", "batch"), guarded=False)
    return opts


def make_prefill_builder(cfg: ModelConfig, *, kernel_impl: str | None = None,
                         window: int | None = None
                         ) -> Callable[[SpecCtx], Callable]:
    """Handler builder for ``prefill_step(params, batch) -> logits``.

    ``batch`` holds ``tokens (B, S)`` (or ``embeds (B, S, d)``, the stub
    frontends' input); the step runs the full-sequence forward
    (:func:`repro_torch.models.transformer.apply`), whose attention is the
    flash attention kernel under ``attention_impl=cuda`` (an rwkv6 time
    mix and hymba's SSM heads: the linear-attention kernel under
    ``linear_attention_impl=cuda``),
    and returns the logits ``(B, S, V)`` in ``logits_dtype``.
    """

    def builder(spec: SpecCtx) -> Callable:
        opts = run_options_from_spec(spec, cfg, kernel_impl=kernel_impl,
                                     window=window)
        _declare_sharding(spec)

        def prefill_step(params, batch):
            logits, _ = model.apply(params, cfg, opts,
                                    tokens=batch.get("tokens"),
                                    embeds=batch.get("embeds"))
            return logits

        return prefill_step

    return builder


def make_decode_builder(cfg: ModelConfig, *, kernel_impl: str | None = None,
                        window: int | None = None
                        ) -> Callable[[SpecCtx], Callable]:
    """Handler builder for ``serve_step(params, cache, tokens, pos)``: one
    new token for the whole batch against the KV cache
    (:func:`repro_torch.models.transformer.decode_step`; the cache is
    updated in place).  Returns ``(logits (B, V), cache)``."""

    def builder(spec: SpecCtx) -> Callable:
        opts = _with_cache_points(spec, run_options_from_spec(
            spec, cfg, kernel_impl=kernel_impl, window=window))

        def serve_step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos, cfg, opts)

        return serve_step

    return builder


def phase_context_fn(args, kwargs) -> tuple[str, int]:
    """Context key for the phase-disaggregated serve handler:
    ``(phase, bucket)``.  The phase is read off the token rank at dispatch
    time — ``(B, C)`` is a chunked-prefill step, ``(B,)`` a decode step —
    so prefill and decode traffic land in *separate* specialization
    contexts of the same handler, each with its own dispatch snapshot and
    its own Controller search."""
    tokens = args[2]
    phase = "prefill" if getattr(tokens, "ndim", 1) == 2 else "decode"
    return (phase, int(tokens.shape[0]))


def make_serve_builder(cfg: ModelConfig, *, kernel_impl: str | None = None
                       ) -> Callable[[SpecCtx], Callable]:
    """Handler builder for the phase-disaggregated
    ``serve_step(params, cache, tokens, pos, n_new)``.

    One registered handler serves both phases, branching on the token
    rank: ``tokens (B,)`` runs one vector-pos decode step, ``tokens (B, C)``
    runs a chunked prefill
    (:func:`repro_torch.models.transformer.prefill_chunk`).  Register it
    with ``context_fn=phase_context_fn`` and the two phases become separate
    ``(phase, bucket)`` specialization contexts.

    ``pos (B,)`` is each row's write position; ``n_new (B,)`` the valid
    token count per row (prefill only).  Returns ``(logits (B, V), cache)``;
    the cache is updated in place.  The port runs on one device (sharded
    serving: ROADMAP M12).
    """

    def builder(spec: SpecCtx) -> Callable:
        opts = _with_cache_points(spec, run_options_from_spec(
            spec, cfg, kernel_impl=kernel_impl))

        def serve_step(params, cache, tokens, pos, n_new):
            if tokens.ndim == 2:
                return model.prefill_chunk(params, cache, tokens, pos,
                                           n_new, cfg, opts)
            return model.decode_step(params, cache, tokens, pos, cfg, opts)

        return serve_step

    return builder
