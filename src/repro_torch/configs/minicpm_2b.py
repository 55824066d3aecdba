"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.

Llama-like arch; the WSD learning-rate schedule (the paper's signature
contribution) lives in repro_torch.optim.schedules.
[arXiv:2404.06395; hf-verified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
))
