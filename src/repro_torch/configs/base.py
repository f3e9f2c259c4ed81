"""Model / run configuration schema.

One :class:`ModelConfig` per assigned architecture (see ``repro/configs/``),
plus the assigned input-shape set (`SHAPES`). Values are the exact published
configs given in the assignment; reduced smoke variants for CPU tests come
from :meth:`ModelConfig.smoke`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # 0 => attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 => d_model // num_heads
    # attention flags
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"          # rope | sinusoidal
    # mlp
    mlp_gated: bool = True         # SwiGLU if True, GELU otherwise
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    # MoE
    moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0              # routed expert hidden size
    shared_expert_d_ff: int = 0    # qwen2-moe shared experts (total hidden)
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3
    norm_topk_prob: bool = True
    # SSM (mamba)
    ssm: bool = False
    ssm_version: int = 1           # 1 = Mamba, 2 = Mamba2 (SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2
    dt_rank: int = 0               # 0 => d_model // 16  (mamba1)
    # hybrid (zamba2): shared transformer block applied every k SSM layers
    hybrid_attn_every: int = 0
    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str = "none"         # none | audio_frames | vision_patches
    frontend_tokens: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # runtime knobs
    attn_chunk_q: int = 256        # chunked-causal attention query block
    ssm_chunk: int = 128           # selective-scan chunk length
    remat: bool = True
    scan_layers: bool = True
    max_seq_len: int = 131072
    # ---- beyond-paper perf knobs (EXPERIMENTS.md §Perf; default = the
    #      paper-faithful baseline behaviour) ----
    attn_bwd_remat: bool = False   # recompute scores in attention backward
    hoist_weight_gather: bool = False  # FSDP gather once per step, not
    #                                    once per microbatch
    moe_expert_pad: int = 0        # inert router-masked experts appended so
    #                                E divides the expert-parallel axis
    ssm_scan_constrain: bool = False   # keep dI/heads sharded inside the
    #                                    selective-scan chunk bodies

    # ---------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards 16-ways evenly."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------- param count
    def param_count(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        per_layer = 0
        if not self.attention_free and self.hybrid_attn_every == 0:
            H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
            per_layer += D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.qkv_bias:
                per_layer += (H + 2 * KV) * hd
        if self.ssm:
            dI, N = self.d_inner, self.ssm_state
            if self.ssm_version == 1:
                per_layer += (D * 2 * dI + dI * self.ssm_conv
                              + dI * (self.dt_rank_ + 2 * N)
                              + self.dt_rank_ * dI + dI * N + 2 * dI
                              + dI * D)
            else:
                nh = self.ssm_heads
                per_layer += (D * (2 * dI + 2 * N + nh)
                              + (dI + 2 * N) * self.ssm_conv
                              + 3 * nh + dI + dI * D)
        if self.moe:
            per_layer += D * self.num_experts                      # router
            per_layer += self.num_experts * 3 * D * self.moe_d_ff  # experts
            if self.shared_expert_d_ff:
                per_layer += 3 * D * self.shared_expert_d_ff + D
            if self.dense_residual:
                per_layer += 3 * D * F
        elif F and not self.ssm:
            per_layer += 3 * D * F if self.mlp_gated else 2 * D * F
        per_layer += 2 * D  # norms
        n += self.num_layers * per_layer
        if self.hybrid_attn_every:
            H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
            # one SHARED transformer block (2D concat in-proj + attn + mlp)
            n += (2 * D) * D + D * H * hd + 2 * D * KV * hd + H * hd * D \
                + 3 * D * self.d_ff + 2 * D
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if not self.moe:
            return self.param_count()
        dead = (self.num_experts - self.num_experts_per_tok) \
            * 3 * self.d_model * self.moe_d_ff * self.num_layers
        return self.param_count() - dead

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2 if self.hybrid_attn_every == 0 else 3,
            d_model=64,
            num_heads=0 if self.attention_free else 4,
            num_kv_heads=0 if self.attention_free else max(
                1, min(self.num_kv_heads, 2)),
            head_dim=16 if not self.attention_free else 0,
            d_ff=96 if self.d_ff else 0,
            vocab_size=503,           # deliberately odd: exercises padding
            num_experts=8 if self.moe else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            moe_d_ff=32 if self.moe else 0,
            shared_expert_d_ff=48 if self.shared_expert_d_ff else 0,
            ssm_state=16 if self.ssm else 0,
            ssm_head_dim=16 if self.ssm else 64,
            dt_rank=8 if self.ssm and self.ssm_version == 1 else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            frontend_tokens=8 if self.frontend != "none" else 0,
            attn_chunk_q=16,
            ssm_chunk=8,
            max_seq_len=256,
        )


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


#: Assigned input shapes (LM family): seq_len x global_batch.
SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention: run for ssm/hybrid only."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch (quadratic); "
                       "long_500k runs only for ssm/hybrid (DESIGN.md §4)")
    return True, ""
