"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts
(shared hidden 4x1408=5632, sigmoid-gated). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    moe=True, num_experts=60, num_experts_per_tok=4,
    moe_d_ff=1408, shared_expert_d_ff=5632,
    norm_topk_prob=False,
)
