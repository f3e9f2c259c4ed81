"""zamba2-1.2b [hybrid] — Mamba2 backbone + ONE shared transformer block
(weights reused) applied every 6 SSM layers with [hidden, embedding]
concat input projection. [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm=True, ssm_version=2, ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
)
