"""repro_torch.models — the LM facade and its layers (counterpart of
``repro.models``; the dense and MoE families so far)."""
