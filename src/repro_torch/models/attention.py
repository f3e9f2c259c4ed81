"""GQA attention, serving subset (torch port of ``repro.models.attention``).

Implementations of full-sequence attention (prefill):

* ``full``    — materializes (S x S) scores; short sequences.
* ``chunked`` — a loop over query blocks with a causal mask; O(S * chunk)
                activation memory. Ragged S pads the query side only.
* ``flash``   — K2, the hand-written CUDA flash kernel
                (:mod:`repro_torch.kernels.flash_attention`); the counterpart
                of the reference's ``impl="pallas"`` branch. The serve
                engine picks it on CUDA and keeps the plain paths as its
                oracle.

Paged decode (:func:`paged_decode_attention`) reads through K1 or its plain
page loop or the gather oracle; chunked-prefill windows
(:func:`paged_prefill_window_attention`) keep the gather read, as in the
reference. The zamba2 shared block's slot decode
(:func:`decode_attention_rows`) reads a per-slot contiguous span, and the
per-call baseline's one-token decode (:func:`decode_attention`) a
contiguous cache at one scalar position, both in plain torch as in the
reference (neither is a Pallas kernel there).

Tensor-parallel serving (:mod:`repro_torch.distributed.sharding`): a rank
holds a column slice of ``wq/wk/wv`` (its heads) and of ``wo``. Head
counts are read from the weights, so every path runs on the rank's heads;
:func:`_project_out` reassembles the heads and the output columns with
tiled all-gathers, keyed by shape as in the reference
(``src/repro/models/attention.py:170-174``).

fp32-accumulated products: the reference computes scores with
``preferred_element_type=float32`` from compute-dtype operands, and a torch
bf16 matmul would return bf16. The plain paths here upcast the operands to
fp32 first: bf16 values are exact in fp32, so this is fp32 accumulation.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import gather_tp
from .layers import dtype_of, rms_norm, rope

__all__ = ["attention", "decode_attention", "paged_decode_attention",
           "paged_prefill_window_attention", "decode_attention_rows",
           "NEG_INF"]

NEG_INF = -2.0 ** 30  # large-but-finite: keeps bf16 softmax NaN-free


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, D = x.shape
    hd = cfg.hd
    H = p["wq"].shape[-1] // hd
    KV = p["wk"].shape[-1] // hd
    cdt = dtype_of(cfg.compute_dtype)
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _project_out(out2, p, cfg: ModelConfig, cdt):
    """``out2 @ wo`` for (..., heads * hd) attention outputs; under serve
    TP the local heads are gathered first and the local ``wo`` columns
    after (identities off a group)."""
    if out2.shape[-1] != p["wo"].shape[0]:     # serve TP: concat heads
        out2 = gather_tp(out2, -1)
    y = out2 @ p["wo"].to(cdt)
    if y.shape[-1] != cfg.d_model:             # serve TP: concat columns
        y = gather_tp(y, -1)
    return y


def _softmax_attend(s, v, mask):
    """Masked softmax over the last axis of fp32 scores (the reference's
    max / exp / sum, kept verbatim) -> probabilities in v's dtype."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)


def _full_attention(q, k, v, q_pos, k_pos):
    """Reference path: (B,S,H,hd) x (B,T,KV,hd) with causal mask."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        * (hd ** -0.5)
    mask = q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]
    probs = _softmax_attend(s, v, mask)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, S, H, hd)


def _chunked_attention(q, k, v, q_pos, k_pos, chunk_q: int):
    """Loop over query chunks; keys stay whole (masked). A ragged tail pads
    the QUERY side only (padded rows fully masked and sliced off)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    pad = (-S) % chunk_q
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=-(2 ** 30))
    kf = k.float()
    outs = []
    for c in range(0, S + pad, chunk_q):
        qb = q[:, c:c + chunk_q].reshape(B, chunk_q, KV, G, hd)
        qpb = q_pos[:, c:c + chunk_q]
        s = torch.einsum("bqkgh,bskh->bkgqs", qb.float(), kf) * (hd ** -0.5)
        mask = qpb[:, None, None, :, None] >= k_pos[:, None, None, None, :]
        probs = _softmax_attend(s, v, mask)
        ob = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
        outs.append(ob.reshape(B, chunk_q, H, hd))
    return torch.cat(outs, dim=1)[:, :S]


def attention(p, x, cfg: ModelConfig, positions, impl: str = "chunked",
              return_kv: bool = False):
    """Causal self-attention over the whole sequence (prefill).

    ``impl="flash"`` runs K2 (its plain version for CPU tensors); it assumes
    ``positions`` is ``arange(S)`` per row, which holds for prefill."""
    B, S, D = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if impl == "flash":
        from ..kernels.ops import flash_attention
        out = flash_attention(q, k, v, causal=True)
    elif impl == "full" or S <= cfg.attn_chunk_q or \
            (S % cfg.attn_chunk_q != 0 and S <= 8192):
        out = _full_attention(q, k, v, positions, positions)
    elif impl == "chunked":
        out = _chunked_attention(q, k, v, positions, positions,
                                 cfg.attn_chunk_q)
    else:
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(expected 'chunked', 'full' or 'flash')")
    y = _project_out(out.reshape(B, S, -1), p, cfg, cdt)
    if return_kv:
        return y, (k, v)
    return y


def paged_decode_attention(p, x, cfg: ModelConfig, pool_kv, tables, pos,
                           active, impl: Optional[str] = None):
    """One-token decode against ONE layer's paged KV pool.

    x: (B, 1, D); pool_kv: (2, N, KV, block, hd) — a view of this layer's
    stacked pages, written IN PLACE (the new token's K and V land in one
    fused scatter); tables: (B, max_blocks) int32; pos: (B,) int32 per-row
    positions; active: (B,) bool (masked rows write to the sink). Returns
    (y (B, 1, D), pool_kv).

    impl: ``"kernel"`` (K1; its plain loop for CPU tensors), ``"loop"``
    (the plain page loop), ``"gather"`` (the materializing oracle), None
    (:func:`repro_torch.kernels.ops.default_paged_impl` for the pool's
    device).
    """
    from ..kernels.ops import default_paged_impl, paged_attention
    from ..serve.kvcache import append_kv, gather_read_attention

    if impl is None:
        impl = default_paged_impl(pool_kv.device)
    B = x.shape[0]
    hd = cfg.hd
    H = p["wq"].shape[-1] // hd
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    append_kv(pool_kv, k[:, 0], v[:, 0], tables, pos, active)
    qh = q.reshape(B, H, hd)
    if impl == "gather":
        out = gather_read_attention(qh, pool_kv, tables, pos)
    else:
        out = paged_attention(qh, pool_kv, tables, pos, impl=impl)
    y = _project_out(out.reshape(B, H * hd).to(cdt), p, cfg, cdt)
    return y[:, None, :], pool_kv


def paged_prefill_window_attention(p, x, cfg: ModelConfig, pool_kv, tables,
                                   positions, valid):
    """One chunked-prefill WINDOW against one layer's paged KV pool.

    The window's K/V is scattered (in place) through the row's block table
    and its queries attend to the row's paged prefix plus the causal part
    of the window, read through the gather path (once per window, not per
    token). x: (B, C, D); pool_kv: (2, N, KV, block, hd); tables:
    (B, max_blocks) int32; positions: (B, C) absolute positions; valid:
    (B, C) bool. Returns (y (B, C, D), pool_kv).
    """
    from ..serve.kvcache import gather_pages, scatter_token_window

    B, C, D = x.shape
    hd = cfg.hd
    H = p["wq"].shape[-1] // hd
    KV = p["wk"].shape[-1] // hd
    G = H // KV
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, positions)
    scatter_token_window(pool_kv, k, v, tables, positions[:, 0], valid)
    ks, vs = gather_pages(pool_kv, tables)           # (B, KV, T, hd)
    T = ks.shape[2]
    qg = q.reshape(B, C, KV, G, hd)
    s = torch.einsum("bckgh,bksh->bkgcs", qg.float(), ks.float()) \
        * (hd ** -0.5)
    kpos = torch.arange(T, device=x.device)
    mask = kpos[None, None, None, None, :] \
        <= positions.long()[:, None, None, :, None]
    probs = _softmax_attend(s, vs, mask)
    out = torch.einsum("bkgcs,bksh->bckgh", probs, vs)
    y = _project_out(out.reshape(B, C, H * hd).to(cdt), p, cfg, cdt)
    return y, pool_kv


def decode_attention_rows(p, x, cfg: ModelConfig, cache_k, cache_v, pos):
    """One-token decode against per-slot contiguous KV spans, each row at
    its own position (the zamba2 shared block's slot decode).

    x: (B, 1, D); cache_[kv]: (B, KV, S_max, hd), written IN PLACE: row
    ``b`` stores its token's K and V at ``pos[b]`` and attends to keys
    ``0..pos[b]``; pos: (B,) int with every ``pos[b] < S_max`` (the
    reference's scatter drops an out-of-range index, torch's raises; the
    engine's submit check keeps positions in range). The probabilities are
    rounded to the cache dtype before P V, as in the reference. Returns
    (y (B, 1, D), cache_k, cache_v).
    """
    B = x.shape[0]
    hd = cfg.hd
    H = p["wq"].shape[-1] // hd
    KV = p["wk"].shape[-1] // hd
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    pl = pos.long()
    cache_k[bidx, :, pl] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, :, pl] = v[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg.float(), cache_k.float()) \
        * (hd ** -0.5)
    kpos = torch.arange(cache_k.shape[2], device=x.device)
    mask = (kpos[None, :] <= pl[:, None])[:, None, None, :]
    probs = _softmax_attend(s, cache_v, mask)
    out = torch.einsum("bkgs,bksh->bkgh", probs, cache_v)
    y = _project_out(out.reshape(B, H * hd).to(cdt), p, cfg, cdt)
    return y[:, None, :], cache_k, cache_v


def decode_attention(p, x, cfg: ModelConfig, cache_k, cache_v, pos: int):
    """One-token decode against a contiguous KV cache at ONE scalar
    position (the reference's ``decode_attention``; the per-call
    baseline's ``lm.decode_step``): :func:`decode_attention_rows` with
    every row at ``pos`` (an int below S_max), which writes each row's K
    and V there in place and attends to keys ``0..pos`` with the
    reference's arithmetic. Returns (y (B, 1, D), cache_k, cache_v)."""
    rows = torch.full((x.shape[0],), pos, dtype=torch.int32,
                      device=x.device)
    return decode_attention_rows(p, x, cfg, cache_k, cache_v, rows)
