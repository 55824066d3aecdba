"""zamba2-7b [hybrid]: 81L d_model=3584 Mamba2 backbone + one weight-shared
attention block (32H kv=32, d_ff=14336) applied every 6 layers,
ssm_state=64, vocab=32000.  [arXiv:2411.15242; unverified]

Simplification vs the HF checkpoint: Zamba2 alternates two shared blocks and
adds per-site LoRA deltas; we model one shared block, no LoRA (noted in
DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,               # 112 heads
    ssm_groups=1,
    conv_width=4,
    attn_every=6,
    param_dtype="bfloat16",
))
