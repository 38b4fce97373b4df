"""The optimizer of the port (AdamW; the port of ``repro.optim``)."""
from repro_torch.optim.adamw import (OptConfig, apply_updates, cosine_lr,
                                     init_opt_state, opt_state_axes,
                                     update_in_place)

__all__ = ["OptConfig", "apply_updates", "cosine_lr", "init_opt_state",
           "opt_state_axes", "update_in_place"]
