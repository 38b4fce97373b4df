from repro_torch.models.config import ModelConfig
from repro_torch.models.common import KernelOptions
from repro_torch.models.convert import (params_from_numpy,
                                         train_state_from_numpy)
from repro_torch.models.transformer import (RunOptions, apply, cache_axes,
                                            decode_step, init_cache,
                                            init_params, param_axes,
                                            prefill_chunk)

__all__ = ["ModelConfig", "KernelOptions", "RunOptions", "apply",
           "cache_axes", "decode_step", "init_cache", "init_params",
           "param_axes", "params_from_numpy", "prefill_chunk",
           "train_state_from_numpy"]
