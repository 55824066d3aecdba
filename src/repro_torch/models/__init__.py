"""repro_torch.models — the LM facade and its layers (counterpart of
``repro.models``; the dense, MoE, SSM and hybrid families so far)."""
