"""musicgen-large [audio] — decoder-only over EnCodec tokens; text/melody
conditioning frontend is a STUB supplying precomputed frame embeddings
(assignment: backbone only). Plain-GELU MLP, sinusoidal positions.
[arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    mlp_gated=False, pos_emb="sinusoidal",
    frontend="audio_frames", frontend_tokens=64,
)
