"""Shared layer primitives: norms, RoPE, positional embeddings, init.

Counterpart of ``repro.models.layers``; same signatures and layouts, on
torch tensors. Init takes an explicit ``torch.Generator`` (its numbers
differ from ``jax.random``'s; the parity tests load the reference's own
params through :func:`repro_torch.params.from_reference` instead).

The column- and row-parallel products of the partitioned train step
(:func:`column_parallel`, :func:`row_parallel`) are plain products off it:
under a :class:`repro_torch.distributed.sharding.TrainRegion` whose
products are partitioned, each weight is this rank's ``tp`` block, the
input of a column-parallel product enters the region (its gradient summed
over ``tp`` in the backward) and a row-parallel product's partial sums
leave it (summed over ``tp`` in the forward). Each names its layer's
kind: a kind that runs whole on every rank takes neither collective.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..distributed.sharding import tp_part

__all__ = ["rms_norm", "rope", "sinusoidal_positions", "dense_init",
           "normal_init", "dtype_of", "matmul_f32", "tp_copy",
           "column_parallel", "row_parallel"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_init(generator: torch.Generator, shape: Sequence[int],
                scale: float = 0.02, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) * scale, drawn in fp32 on the generator's device."""
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.float32) -> torch.Tensor:
    """Fan-in scaled init (LeCun normal)."""
    fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
    return normal_init(generator, shape, 1.0 / max(1.0, fan_in) ** 0.5,
                       dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32 from compute-dtype
    operands: the reference's ``preferred_element_type=float32`` (the
    logits products). A 2-D bf16/fp16 product on CUDA asks cuBLAS for an
    fp32 result directly; elsewhere the operands are upcast (bf16 values
    are exact in fp32, so both are fp32 accumulation of the same
    products). fp32 matmuls run in full fp32: TF32 is off by default
    (``torch.backends.cuda.matmul.allow_tf32``)."""
    if a.is_cuda and a.dim() == 2 and b.dim() == 2 and a.dtype == b.dtype \
            and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def tp_copy(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` (replicated over ``tp``) into the partitioned region: the
    identity, whose backward sums the ranks' gradients; the identity off
    it, and where the layer ``kind`` runs whole
    (:func:`repro_torch.distributed.sharding.tp_whole`)."""
    part = tp_part(kind)
    return x if part is None else part.copy_in(x)


def column_parallel(x: torch.Tensor, *ws: torch.Tensor, kind: str):
    """``[x @ w for w in ws]``, ``x`` entering the region once: each ``w``
    is this rank's block of output columns (of a layer ``kind`` that
    partitions; else the whole weight)."""
    x = tp_copy(x, kind)
    return [x @ w for w in ws]


def row_parallel(x: torch.Tensor, w: torch.Tensor, bias=None, *,
                 kind: str) -> torch.Tensor:
    """``x @ w (+ bias)``, ``w`` this rank's block of input rows and ``x``
    the matching columns: the partial products summed over ``tp``, then
    the replicated ``bias`` added once, after the sum (a layer ``kind``
    that runs whole: the product alone)."""
    y = x @ w
    part = tp_part(kind)
    if part is not None:
        y = part.reduce_out(y)
    return y if bias is None else y + bias


def _rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(hd: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    # cached per device: a host-to-device copy from pageable memory
    # synchronizes the stream, and rope runs twice per layer per token
    return torch.from_numpy(_rope_freqs(hd, theta)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    angles = positions[..., None].float() * freqs            # (..,S,hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..,S,1,hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """(..., S) int -> (..., S, D) sinusoidal embedding (musicgen)."""
    half = d_model // 2
    freqs = torch.exp(-np.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
