"""K3: the Mamba1 selective scan, ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
``y_t = <h_t, C_t>``.

The counterpart of ``repro.kernels.mamba_scan``. On a CUDA tensor
:func:`mamba_scan` launches the hand-written Hopper kernel of
``csrc/mamba_scan.cu`` (4 states of one channel per thread, in registers
for the whole sequence; chunks of 32 steps loaded one chunk ahead into a
2-stage shared-memory ring; an optional initial state; ragged S and dI
masked, where the TPU kernel asserted block multiples); on a CPU tensor it
runs the plain sequential
:func:`repro_torch.kernels.ref.mamba_scan_ref`. A CUDA tensor gets the
kernel or an exception, never the plain version.

:func:`mamba_scan` is differentiable, so serving and training call the
same function. When autograd records a CUDA call, :class:`MambaScan` runs
K3 keeping the state before every :data:`STATE_CHUNK`-step chunk
(``mamba_scan_cuda(..., save_states=True)``), and its backward is the
hand-written reverse scan of :mod:`repro_torch.kernels.mamba_scan_bwd`;
otherwise K3 runs alone, as it serves. On the CPU autograd differentiates
the plain scan. Training starts from a zero (or a given) state: ``h0``
takes no gradient, and an ``h0`` that requires one is refused.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import mamba_scan_bwd as _bwd
from .mamba_scan_bwd import STATE_CHUNK
from .ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_cuda", "MambaScan", "launches",
           "MAX_STATE", "STATE_CHUNK"]

#: kernel launches made by :func:`mamba_scan_cuda` in this process
launches = 0

#: the kernel keeps 4 states per lane of a 4- or 8-lane group per channel
MAX_STATE = 32

_DTYPES = {torch.float32: _build.FLOAT32, torch.bfloat16: _build.BFLOAT16}


def mamba_scan_cuda(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, A: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    save_states: bool = False):
    """Launch K3 on PyTorch's current stream. Checks device, dtype, shape
    and contiguity and raises on anything the kernel does not take.
    Returns (y, hT), or (y, hT, hs) with ``save_states``: hs (B,
    ceil(S / STATE_CHUNK), dI, N) fp32, the state before each chunk (hs[:,
    0] is h0, or zeros)."""
    global launches
    if not (dt.is_cuda and x.is_cuda and Bc.is_cuda and Cc.is_cuda
            and A.is_cuda and (h0 is None or h0.is_cuda)):
        raise ValueError("mamba_scan_cuda needs CUDA tensors")
    dev = x.device
    if not (dt.device == dev and Bc.device == dev and Cc.device == dev
            and A.device == dev and (h0 is None or h0.device == dev)):
        raise ValueError("mamba_scan_cuda: tensors on different devices")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or Bc.dtype != x.dtype or Cc.dtype != x.dtype:
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
    if dt.shape != x.shape or A.shape[0] != dI \
            or Bc.shape != (B, S, N) or Cc.shape != (B, S, N) \
            or (h0 is not None and h0.shape != (B, dI, N)):
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
    if not (dt.is_contiguous() and x.is_contiguous() and Bc.is_contiguous()
            and Cc.is_contiguous() and A.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        name = next(n for n, t in (("dt", dt), ("x", x), ("Bc", Bc),
                                   ("Cc", Cc), ("A", A), ("h0", h0))
                    if t is not None and not t.is_contiguous())
        raise ValueError(f"mamba_scan_cuda: {name} not contiguous")
    lib = _build.ensure_built(dev.index)
    y = torch.empty((B, S, dI), dtype=torch.float32, device=dev)
    hT = torch.empty((B, dI, N), dtype=torch.float32, device=dev)
    args = (dtype, dt.data_ptr(), x.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), A.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            hT.data_ptr())
    stream = _build.current_stream(dev.index)
    if save_states:
        hs = torch.empty((B, -(-S // STATE_CHUNK), dI, N),
                         dtype=torch.float32, device=dev)
        err = lib.repro_mamba_scan_states(*args, hs.data_ptr(), B, S, dI, N,
                                          stream)
    else:
        err = lib.repro_mamba_scan(*args, B, S, dI, N, stream)
    _build.check(err, "mamba_scan")
    launches += 1
    return (y, hT, hs) if save_states else (y, hT)


class MambaScan(torch.autograd.Function):
    """K3 forward, keeping the states the backward kernel recomputes its
    chunks from; the backward kernel backward. ``h0`` takes no
    gradient."""

    @staticmethod
    def forward(ctx, dt, x, Bc, Cc, A, h0):
        y, hT, hs = mamba_scan_cuda(dt, x, Bc, Cc, A, h0=h0,
                                    save_states=True)
        ctx.save_for_backward(dt, x, Bc, Cc, A, hs)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, x, Bc, Cc, A, hs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(dt)
        grads = _bwd.mamba_scan_bwd_cuda(
            dt, x, Bc, Cc, A, hs, dy.float().contiguous(),
            None if dhT is None else dhT.float().contiguous())
        return (*grads, None)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt (B, S, dI) fp32; x (B, S, dI); A (dI, N) fp32; Bc, Cc (B, S, N);
    h0 (B, dI, N) fp32 or None (zero state). Returns y (B, S, dI) fp32 and
    the final state (B, dI, N) fp32. CUDA tensors launch K3, and
    :class:`MambaScan` when autograd records and an input needs a
    gradient; CPU tensors take the plain sequential scan, which autograd
    differentiates. Raises if ``h0`` requires a gradient."""
    if h0 is not None and h0.requires_grad:
        raise ValueError("mamba_scan: h0 takes no gradient (training starts "
                         "from a given or zero state)")
    if not (dt.is_cuda or x.is_cuda):
        return mamba_scan_ref(dt, A, Bc, Cc, x, h0=h0)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (dt, x, Bc, Cc, A))):
        return mamba_scan_cuda(dt, x, Bc, Cc, A, h0=h0)
    if A.shape[-1] > _bwd.MAX_STATE:
        raise ValueError(f"mamba_scan: state size N={A.shape[-1]} > "
                         f"{_bwd.MAX_STATE}, the backward kernel's limit")
    return MambaScan.apply(dt, x, Bc, Cc, A, h0)
