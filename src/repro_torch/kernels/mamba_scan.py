"""K3: the Mamba1 selective scan, ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
``y_t = <h_t, C_t>``.

The counterpart of ``repro.kernels.mamba_scan``. On a CUDA tensor
:func:`mamba_scan` launches the hand-written Hopper kernel of
``csrc/mamba_scan.cu`` (one thread per (channel, state) element with the
state in a register for the whole sequence, an optional initial state, and
ragged S and dI masked, where the TPU kernel asserted block multiples); on
a CPU tensor it runs the plain sequential
:func:`repro_torch.kernels.ref.mamba_scan_ref`. A CUDA tensor gets the
kernel or an exception, never the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_cuda", "launches", "MAX_STATE"]

#: kernel launches made by :func:`mamba_scan_cuda` in this process
launches = 0

#: the kernel keeps one state per lane of a 16- or 32-lane group
MAX_STATE = 32

_DTYPES = {torch.float32: _build.FLOAT32, torch.bfloat16: _build.BFLOAT16}


def mamba_scan_cuda(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, A: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on PyTorch's current stream. Checks device, dtype, shape
    and contiguity and raises on anything the kernel does not take."""
    global launches
    named = [("dt", dt), ("x", x), ("Bc", Bc), ("Cc", Cc), ("A", A)]
    if h0 is not None:
        named.append(("h0", h0))
    if not all(t.is_cuda for _, t in named):
        raise ValueError("mamba_scan_cuda needs CUDA tensors")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("mamba_scan_cuda: tensors on different devices")
    if x.dtype not in _DTYPES or Bc.dtype != x.dtype or Cc.dtype != x.dtype:
        raise TypeError(f"mamba_scan_cuda: x/Bc/Cc dtypes {x.dtype}/"
                        f"{Bc.dtype}/{Cc.dtype}; expected all float32 or all "
                        "bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("mamba_scan_cuda: dt, A and h0 must be float32")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan_cuda: x {tuple(x.shape)} A "
                         f"{tuple(A.shape)}; expected (B, S, dI), (dI, N)")
    B, S, dI = x.shape
    N = A.shape[1]
    if tuple(dt.shape) != (B, S, dI) or tuple(A.shape) != (dI, N) \
            or tuple(Bc.shape) != (B, S, N) or tuple(Cc.shape) != (B, S, N) \
            or (h0 is not None and tuple(h0.shape) != (B, dI, N)):
        raise ValueError(
            f"mamba_scan_cuda: dt {tuple(dt.shape)} x {tuple(x.shape)} Bc "
            f"{tuple(Bc.shape)} Cc {tuple(Cc.shape)} A {tuple(A.shape)} h0 "
            f"{None if h0 is None else tuple(h0.shape)}; expected (B, S, "
            "dI) x2, (B, S, N) x2, (dI, N), (B, dI, N)")
    if min(B, S, dI, N) == 0 or B > 65535:
        raise ValueError(f"mamba_scan_cuda: B={B} S={S} dI={dI} N={N} (each "
                         ">= 1, B <= 65535)")
    if N > MAX_STATE:
        raise ValueError(f"mamba_scan_cuda: state size N={N} > {MAX_STATE}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan_cuda: {name} not contiguous")
    lib = _build.ensure_built(x.device.index)
    y = torch.empty((B, S, dI), dtype=torch.float32, device=x.device)
    hT = torch.empty((B, dI, N), dtype=torch.float32, device=x.device)
    err = lib.repro_mamba_scan(
        _DTYPES[x.dtype], dt.data_ptr(), x.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), A.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        B, S, dI, N, _build.current_stream(x.device.index))
    _build.check(err, "mamba_scan")
    launches += 1
    return y, hT


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt (B, S, dI) fp32; x (B, S, dI); A (dI, N) fp32; Bc, Cc (B, S, N);
    h0 (B, dI, N) fp32 or None (zero state). Returns y (B, S, dI) fp32 and
    the final state (B, dI, N) fp32. CUDA tensors launch the kernel; CPU
    tensors take the plain sequential scan."""
    if dt.is_cuda or x.is_cuda:
        return mamba_scan_cuda(dt, x, Bc, Cc, A, h0=h0)
    return mamba_scan_ref(dt, A, Bc, Cc, x, h0=h0)
