"""Checkpoints and specialization state (the port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (PLANE_RECORD_VERSION,
                                          CheckpointManager,
                                          load_plane_record,
                                          load_safety_state,
                                          restore_spec_state,
                                          save_plane_record, save_spec_state)

__all__ = ["CheckpointManager", "restore_spec_state", "save_spec_state",
           "load_safety_state", "PLANE_RECORD_VERSION", "load_plane_record",
           "save_plane_record"]
