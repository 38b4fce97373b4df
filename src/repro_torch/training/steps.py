"""Step builders: where the framework's Iridescent spec points live.

Each builder is *handler code* in the paper's sense: it declares
specialization points through the :class:`SpecCtx` it receives and returns
the step function.  Re-building under a different configuration bakes
different constants (kernel implementation, rows per block, cache and
logits dtypes) into the closure the runtime dispatches to.

This slice ports the serve builder.  It declares every spec label the
reference's serve builder declares, with the same candidate sets except
``norm_block_rows``: it is the rows per thread block of the Hopper
RMSNorm, and offers only the size the library instantiates (4) until a
measurement on the card picks others.  The prefill, decode and train
builders wait for ROADMAP M8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.specializer import SpecCtx
from repro_torch.kernels import registry as kernel_registry
from repro_torch.kernels.rmsnorm.kernel import BLOCK_ROWS, DEFAULT_BLOCK_ROWS
from repro_torch.models import transformer as model
from repro_torch.models.common import KernelOptions
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RunOptions

__all__ = ["SHARDING_PROFILES", "make_serve_builder", "phase_context_fn",
           "run_options_from_spec"]

#: the reference's layout profiles.  The label and its candidates are kept
#: so tuned configs replay; on one device every profile is the same
#: placement (the distributed slice, ROADMAP M12, gives them meaning).
SHARDING_PROFILES = ("dp", "fsdp", "fsdp_pods", "fsdp_noexp", "seq",
                     "serve_ep")


def run_options_from_spec(spec: SpecCtx, cfg: ModelConfig, *,
                          kernel_impl: str | None = None) -> RunOptions:
    """Declare the decode step's model-level spec points and bundle the
    chosen constants.

    ``block_q``, ``block_kv``, ``logits_dtype`` (and ``swa_impl`` for a
    sliding-window model) are declared with the reference's candidates so
    its configs replay; nothing on the decode path reads them yet (the
    attention kernel, ROADMAP K2, will; decode logits are always fp32, as
    in the reference).  The training points (``remat``, gradient-safe
    implementations) and the long-context ``window`` override arrive with
    the builders that use them (ROADMAP M8).
    """
    # Implementation choice per kernel family the step exercises: the
    # candidate set is the registry entries *available on this host*; a
    # choice that still guard-misses at dispatch degrades to torch_ref
    # inside the registry (paper §4.4.3).  The attention family arrives
    # with its kernel (ROADMAP K2); linear attention with M7.
    if cfg.mixer != "attn":
        raise NotImplementedError(
            f"mixer {cfg.mixer!r} is not ported yet (ROADMAP M7)")
    if cfg.is_moe:
        raise NotImplementedError("MoE is not ported yet (ROADMAP M7)")
    ko = KernelOptions(
        impl=kernel_impl,
        rmsnorm_impl=kernel_registry.impl_point(spec, "rmsnorm",
                                                default=kernel_impl),
        norm_block_rows=spec.enum("norm_block_rows", DEFAULT_BLOCK_ROWS,
                                  BLOCK_ROWS, guarded=False),
    )
    spec.enum("block_q", 512, (128, 256, 512, 1024), guarded=False)
    spec.enum("block_kv", 512, (128, 256, 512, 1024), guarded=False)
    if cfg.window:
        spec.enum("swa_impl", "full", ("full", "banded"), guarded=False)
    spec.enum("logits_dtype", "float32", ("float32", "bfloat16"),
              guarded=False)
    return RunOptions(kernels=ko)


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
        opts = run_options_from_spec(spec, cfg, kernel_impl=kernel_impl)
        opts = dataclasses.replace(opts, decode_cache_dtype=spec.enum(
            "cache_dtype", "bfloat16", ("bfloat16", "float32"),
            guarded=False))
        # Layout points, declared for replay; one device has one layout.
        spec.enum("sharding_profile", "fsdp", SHARDING_PROFILES,
                  guarded=False)
        spec.enum("cache_layout", "seq", ("seq", "batch"), guarded=False)

        def serve_step(params, cache, tokens, pos, n_new):
            if tokens.ndim == 2:
                return model.prefill_chunk(params, cache, tokens, pos,
                                           n_new, cfg, opts)
            return model.decode_step(params, cache, tokens, pos, cfg, opts)

        return serve_step

    return builder
