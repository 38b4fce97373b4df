from repro_torch.training.steps import (SHARDING_PROFILES,
                                        make_decode_builder,
                                        make_prefill_builder,
                                        make_serve_builder, phase_context_fn,
                                        run_options_from_spec)

__all__ = ["SHARDING_PROFILES", "make_decode_builder", "make_prefill_builder",
           "make_serve_builder", "phase_context_fn", "run_options_from_spec"]
