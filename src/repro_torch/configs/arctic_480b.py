"""arctic-480b [moe] — 128 experts top-2 IN PARALLEL with a dense residual
FFN path (dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    rope_theta=1_000_000.0,
    moe=True, num_experts=128, num_experts_per_tok=2,
    moe_d_ff=4864, dense_residual=True,
    # ~480B params: bf16 params/moments; fp32 master needs the 2-pod mesh
    param_dtype="bfloat16",
)
