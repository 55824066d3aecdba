"""repro_torch.optim — AdamW, LR schedules (incl. WSD), gradient compression
(counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamState, Optimizer, adamw,
                                     apply_updates, global_norm)
from repro_torch.optim import schedules, compress  # noqa: F401

__all__ = ["AdamState", "Optimizer", "adamw", "apply_updates",
           "global_norm", "schedules", "compress"]
