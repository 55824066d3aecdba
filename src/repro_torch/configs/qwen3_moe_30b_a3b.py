"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf-verified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                        # all-MoE FFN (no dense MLP layers)
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    param_dtype="bfloat16",
))
