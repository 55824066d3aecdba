"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, MQA, embedding scaling by sqrt(d_model).
[arXiv:2403.08295; hf-verified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_kind="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    param_dtype="bfloat16",
))
