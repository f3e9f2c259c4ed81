"""qwen2.5-32b [dense] — GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    # 33B params: bf16 params + bf16 optimizer moments on a single pod
    param_dtype="bfloat16",
)
