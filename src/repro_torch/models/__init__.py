"""repro_torch.models — the LM facade and its layers (counterpart of
``repro.models``; dense family so far)."""
