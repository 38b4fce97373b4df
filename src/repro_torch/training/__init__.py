from repro_torch.training.steps import (SHARDING_PROFILES,
                                        chunked_cross_entropy, cross_entropy,
                                        make_decode_builder,
                                        make_prefill_builder,
                                        make_serve_builder, make_train_builder,
                                        phase_context_fn,
                                        run_options_from_spec)

__all__ = ["SHARDING_PROFILES", "chunked_cross_entropy", "cross_entropy",
           "make_decode_builder", "make_prefill_builder", "make_serve_builder",
           "make_train_builder", "phase_context_fn", "run_options_from_spec"]
