"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP branch (Snowflake Arctic's
dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base; hf-verified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                     # dense residual branch width
    vocab_size=32000,
    rope_theta=10_000.0,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    param_dtype="bfloat16",
))
