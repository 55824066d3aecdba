"""repro_torch.data — deterministic, restart-safe token streams
(counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import (ByteCorpus, SyntheticLM, host_slice,
                                       prefetch)

__all__ = ["SyntheticLM", "ByteCorpus", "host_slice", "prefetch"]
