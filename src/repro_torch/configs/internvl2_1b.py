"""internvl2-1b [vlm] — InternViT frontend STUB (precomputed patch
embeddings) + Qwen2-0.5B-like LM backbone (tied embeddings, QKV bias).
[arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    frontend="vision_patches", frontend_tokens=256,
)
