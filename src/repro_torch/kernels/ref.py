"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each CUDA kernel in ``csrc/`` is held against the function here on the
card, and the CPU path of every wrapper runs it. They repeat the reference
math of ``repro.kernels.ref`` / ``repro.kernels.paged_attention`` (fp32
scores from the compute-dtype operands) and are no yardstick of speed.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "paged_attention_ref", "lsdnn_layer_ref",
           "NEG_INF"]

NEG_INF = -2.0 ** 30  # large-but-finite, as the reference kernels


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); GQA softmax attention, causal mask
    ``q_index >= k_index``. Returns (B,S,H,hd) in q.dtype; softmax in fp32
    (the operands are upcast: bf16 values are exact in fp32, so this is the
    reference's fp32 accumulation)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        * (hd ** -0.5)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] \
            >= torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(B, S, H, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, pool_kv: torch.Tensor,
                        tables: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
    """The page loop of the reference ``_paged_attention_xla``, kept
    exactly: per-row clamp ``jc = min(j, nb_row - 1)``, the ``j < nb_row``
    guard (a row whose pages ran out would otherwise re-read and
    double-count its last page) and ``l == 0 -> 1`` for fully-masked rows.

    q: (B, H, hd); pool_kv: (2, N, KV, bs, hd) one layer's stacked pages;
    tables: (B, max_blocks) int32; lengths: (B,) int32 per-row position
    ``pos`` (keys ``0..pos`` attend). Returns (B, H, hd) in q.dtype.

    The loop bound ``max(lengths) // bs + 1`` is read on the host: this is
    the plain (CPU) path, the CUDA kernel needs no such sync.
    """
    B, H, hd = q.shape
    _, _, KV, bs, _ = pool_kv.shape
    G = H // KV
    mb = tables.shape[1]
    dev = q.device
    qg = q.reshape(B, KV, G, hd).float()
    lengths = lengths.to(torch.int64)
    nb_row = lengths // bs + 1
    nb_max = int(nb_row.max())
    ar = torch.arange(bs, device=dev)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32, device=dev)
    scale = hd ** -0.5
    for j in range(nb_max):
        jc = torch.clamp(nb_row - 1, max=j).clamp(max=mb - 1)
        blk = tables.gather(1, jc[:, None])[:, 0].long()
        kv_j = pool_kv[:, blk].float()                   # (2, B, KV, bs, hd)
        s = torch.einsum("bkgh,bksh->bkgs", qg, kv_j[0]) * scale
        kpos = jc[:, None] * bs + ar
        mask = (kpos <= lengths[:, None]) & (j < nb_row)[:, None]
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgs,bksh->bkgh", p, kv_j[1])
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).reshape(B, H, hd).to(q.dtype)


def lsdnn_layer_ref(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    cap: float = 32.0) -> torch.Tensor:
    """One LSDNN inference layer (paper §5.3, HPEC sparse-DNN challenge):
    ``clamp(relu(y @ w + b), 0, cap)``. y: (T, F); w: (F, G); b: (G,).
    The operands are upcast and summed in fp32 (bf16 values are exact in
    fp32, so this is the reference's fp32 accumulation); the result is cast
    back to ``y.dtype``. On CUDA the product is full fp32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default)."""
    z = y.float() @ w.float() + b.float()
    return z.clamp(0.0, cap).to(y.dtype)
