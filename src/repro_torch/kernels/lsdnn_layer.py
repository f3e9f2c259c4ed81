"""K4: one LSDNN inference layer, ``clamp(relu(y @ w + b), 0, cap)``.

The counterpart of ``repro.kernels.lsdnn_layer``. On a CUDA tensor
:func:`lsdnn_layer` launches the hand-written Hopper kernel of
``csrc/lsdnn_layer.cu`` (a tiled fp32 SGEMM with the bias + clamp epilogue
in registers; ragged T, F and G masked, where the TPU kernel asserted tile
multiples); on a CPU tensor it runs the plain
:func:`repro_torch.kernels.ref.lsdnn_layer_ref`. A CUDA tensor gets the
kernel or an exception, never the plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import lsdnn_layer_ref

__all__ = ["lsdnn_layer", "lsdnn_layer_cuda", "launches"]

#: kernel launches made by :func:`lsdnn_layer_cuda` in this process (a launch
#: recorded into a CUDA graph counts once, at capture, not per replay)
launches = 0

_DTYPES = {torch.float32: _build.FLOAT32, torch.bfloat16: _build.BFLOAT16}
_MAX_ROWS = 65535 * 128          # the grid's row-tile axis is gridDim.y


def lsdnn_layer_cuda(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     cap: float = 32.0) -> torch.Tensor:
    """Launch K4 on PyTorch's current stream. Checks device, dtype, shape
    and contiguity and raises on anything the kernel does not take."""
    global launches
    if not (y.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError("lsdnn_layer_cuda needs CUDA tensors")
    if len({y.device, w.device, b.device}) != 1:
        raise ValueError("lsdnn_layer_cuda: tensors on different devices")
    if y.dtype not in _DTYPES or w.dtype != y.dtype or b.dtype != y.dtype:
        raise TypeError(f"lsdnn_layer_cuda: dtypes {y.dtype}/{w.dtype}/"
                        f"{b.dtype}; expected all float32 or all bfloat16")
    if y.dim() != 2 or w.dim() != 2 or b.dim() != 1 \
            or w.shape[0] != y.shape[1] or b.shape[0] != w.shape[1]:
        raise ValueError(f"lsdnn_layer_cuda: y {tuple(y.shape)} w "
                         f"{tuple(w.shape)} b {tuple(b.shape)}; expected "
                         "(T, F), (F, G), (G,)")
    T, F = y.shape
    G = w.shape[1]
    if min(T, F, G) == 0 or T > _MAX_ROWS:
        raise ValueError(f"lsdnn_layer_cuda: T={T} F={F} G={G} (each >= 1, "
                         f"T <= {_MAX_ROWS})")
    for name, t in (("y", y), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"lsdnn_layer_cuda: {name} not contiguous")
    lib = _build.ensure_built()
    out = torch.empty((T, G), dtype=y.dtype, device=y.device)
    err = lib.repro_lsdnn_layer(
        _DTYPES[y.dtype], y.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), T, F, G, float(cap),
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "lsdnn_layer")
    launches += 1
    return out


def lsdnn_layer(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cap: float = 32.0) -> torch.Tensor:
    """y: (T, F); w: (F, G); b: (G,) -> clamp(relu(y @ w + b), 0, cap) in
    y.dtype, fp32 accumulation. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if y.is_cuda:
        return lsdnn_layer_cuda(y, w, b, cap=cap)
    return lsdnn_layer_ref(y, w, b, cap=cap)
