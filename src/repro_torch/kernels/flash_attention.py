"""K2: causal / non-causal GQA flash-attention forward.

The counterpart of ``repro.kernels.flash_attention``. On a CUDA tensor
:func:`flash_attention` launches the hand-written Hopper kernel of
``csrc/flash_attention.cu``: for bf16 a tensor-core kernel (``mma.sync``
for Q K^T and P V, K/V tiles through a ``cp.async`` ring, the online
softmax in registers, P rounded to bf16 before P V as the plain version
does), for fp32 an exact CUDA-core kernel; kv tiles above the causal
diagonal are pruned by the loop bound and ragged S and T masked, where the
TPU kernel asserted tile multiples. On a CPU tensor it runs the plain
:func:`repro_torch.kernels.ref.flash_attention_ref`. A CUDA tensor gets the
kernel or an exception, never the plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_cuda", "launches"]

#: kernel launches made by :func:`flash_attention_cuda` in this process
launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: _build.FLOAT32, torch.bfloat16: _build.BFLOAT16}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch K2 on PyTorch's current stream. Checks device, dtype, shape
    and contiguity and raises on anything the kernel does not take."""
    global launches
    B, S, H, hd = q.shape
    Bk, T, KV, hdk = k.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention_cuda: tensors on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; expected all float32 or all bfloat16")
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd \
            or hd not in _HEAD_DIMS or H % KV:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (head dim in "
                         f"{_HEAD_DIMS}, H divisible by KV)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} not contiguous")
    lib = _build.ensure_built(q.device.index)
    out = torch.empty_like(q)
    err = lib.repro_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, T, H, KV, hd, int(bool(causal)),
        float(hd ** -0.5), _build.current_stream(q.device.index))
    _build.check(err, "flash_attention")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) -> (B,S,H,hd) in q.dtype, fp32
    softmax. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)
