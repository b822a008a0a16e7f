"""Tree checkpoints in the JAX package's npz + JSON format (the port's own
copy: ``repro.checkpoint`` imports JAX)."""
from repro_torch.checkpoint.checkpoint import (CheckpointError,
                                               jax_key_layout,
                                               load_checkpoint, read_meta,
                                               save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "read_meta",
           "jax_key_layout", "CheckpointError"]
