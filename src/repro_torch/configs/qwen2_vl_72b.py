"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  M-RoPE (3-stream rotary), dynamic-resolution vision frontend
STUBBED: the caller provides precomputed patch embeddings for the first
``frontend_len`` positions.  [arXiv:2409.12191; hf-verified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    m_rope=True,
    mrope_sections=(16, 24, 24),   # t/h/w split of head_dim/2 = 64
    frontend="vision",
    frontend_len=1024,             # 32x32 patch raster
    grid_hw=32,
    param_dtype="bfloat16",
))
