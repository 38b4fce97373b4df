from repro_torch.models.config import ModelConfig
from repro_torch.models.common import KernelOptions
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (RunOptions, cache_axes,
                                            decode_step, init_cache,
                                            init_params, param_axes,
                                            prefill_chunk)

__all__ = ["ModelConfig", "KernelOptions", "RunOptions", "cache_axes",
           "decode_step", "init_cache", "init_params", "param_axes",
           "params_from_numpy", "prefill_chunk"]
