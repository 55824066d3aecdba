"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, ssm_state=128,
vocab=50280.  SSD (state-space duality) chunked scan.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,               # 32 heads
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
    param_dtype="float32",
))
