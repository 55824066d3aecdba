"""repro_torch.checkpoint — async, restart-safe checkpoints in the JAX
package's on-disk layout (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
