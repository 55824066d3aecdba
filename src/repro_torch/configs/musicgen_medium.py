"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.

Decoder-only over EnCodec tokens; the EnCodec encoder + text conditioner are
STUBBED: the caller provides precomputed conditioning frame embeddings for
the first ``frontend_len`` positions.  [arXiv:2306.05284; hf-verified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10_000.0,
    frontend="audio",
    frontend_len=256,
    param_dtype="bfloat16",
))
