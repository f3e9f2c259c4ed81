"""falcon-mamba-7b [ssm] — pure Mamba1, attention-free, ssm_state=16.
[arXiv:2410.05355; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm=True, ssm_version=1, ssm_state=16, ssm_conv=4, ssm_expand=2,
    dt_rank=256,
)
