"""K1: paged decode attention, read in place through the block tables.

The counterpart of ``repro.kernels.paged_attention``: one new token per
batch row attends over that row's K/V pages of ONE layer's stacked pool
``(2, N, KV, block, hd)``, pages past ``lengths[b] // block + 1`` skipped,
with an online softmax over pages. On a CUDA tensor :func:`paged_attention`
launches the hand-written Hopper kernel of ``csrc/paged_attention.cu`` (one
block of 8 warps per (row, kv head), the row's pages strided over the
warps, their partial softmaxes merged once at the end); on a CPU tensor it
runs the plain page loop (:func:`repro_torch.kernels.ref.paged_attention_ref`).
There is no fallback from one to the other: a CUDA tensor gets the kernel or
an exception.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_cuda", "launches"]

#: kernel launches made by :func:`paged_attention_cuda` in this process
launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: _build.FLOAT32, torch.bfloat16: _build.BFLOAT16}
_SCALES = {hd: float(hd ** -0.5) for hd in _HEAD_DIMS}


def paged_attention_cuda(q: torch.Tensor, pool_kv: torch.Tensor,
                         tables: torch.Tensor, lengths: torch.Tensor
                         ) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream. Checks device, dtype, shape
    and contiguity and raises on anything the kernel does not take (the
    serve path calls this once per layer of every decode step, so the
    checks compare devices and shape tuples directly)."""
    global launches
    dev = q.device
    if not (q.is_cuda and pool_kv.is_cuda and tables.is_cuda
            and lengths.is_cuda):
        raise ValueError("paged_attention_cuda needs CUDA tensors")
    if not (pool_kv.device == dev and tables.device == dev
            and lengths.device == dev):
        raise ValueError("paged_attention_cuda: tensors on different devices")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or pool_kv.dtype != q.dtype:
        raise TypeError(f"paged_attention_cuda: q/pool dtype {q.dtype}/"
                        f"{pool_kv.dtype}; expected both float32 or bfloat16")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention_cuda: tables/lengths must be int32")
    B, H, hd = q.shape
    two, N, KV, bs, hd2 = pool_kv.shape
    if two != 2 or hd2 != hd or hd not in _HEAD_DIMS or H % KV:
        raise ValueError(f"paged_attention_cuda: q {tuple(q.shape)} vs pool "
                         f"{tuple(pool_kv.shape)} (head dim in {_HEAD_DIMS},"
                         " H divisible by KV)")
    if tables.dim() != 2 or tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"paged_attention_cuda: tables "
                         f"{tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if not (q.is_contiguous() and pool_kv.is_contiguous()
            and tables.is_contiguous() and lengths.is_contiguous()):
        name = next(n for n, t in (("q", q), ("pool_kv", pool_kv),
                                   ("tables", tables), ("lengths", lengths))
                    if not t.is_contiguous())
        raise ValueError(f"paged_attention_cuda: {name} not contiguous")
    idx = dev.index
    lib = _build.ensure_built(idx)
    out = torch.empty_like(q)
    err = lib.repro_paged_attention(
        dtype, q.data_ptr(), pool_kv.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, KV, N, bs, hd,
        tables.shape[1], _SCALES[hd], _build.current_stream(idx))
    _build.check(err, "paged_attention")
    launches += 1
    return out


def paged_attention(q: torch.Tensor, pool_kv: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
    """One-token decode attention straight off the paged KV pool.

    q: (B, H, hd) post-RoPE queries; pool_kv: (2, N, KV, block, hd) one
    layer's stacked pages; tables: (B, max_blocks) int32 (unused entries
    point at the sink block); lengths: (B,) int32 per-row position ``pos``
    (keys ``0..pos`` attend). Returns (B, H, hd) in q.dtype. CUDA tensors
    launch the kernel; CPU tensors take the plain page loop."""
    if q.is_cuda:
        return paged_attention_cuda(q, pool_kv, tables, lengths)
    return paged_attention_ref(q, pool_kv, tables, lengths)
