"""The backward of K3: :func:`mamba_scan_bwd_cuda`, the hand-written
reverse scan of ``csrc/mamba_scan_bwd.cu``, which recomputes each
:data:`STATE_CHUNK`-step chunk's states from the one K3 saved before it
(``mamba_scan_cuda(..., save_states=True)``).

No TPU kernel is replaced: the JAX package differentiates its plain
chunked scan (``_m1_scan``) with XLA, and its Pallas scan has no backward.
:class:`repro_torch.kernels.mamba_scan.MambaScan` puts K3 and this kernel
behind ``torch.autograd``; its plain version is ``torch.autograd`` through
:func:`repro_torch.kernels.ref.mamba_scan_ref`. A CUDA tensor gets the
kernel or an exception, never the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["mamba_scan_bwd_cuda", "launches", "MAX_STATE", "STATE_CHUNK"]

#: kernel launches made by :func:`mamba_scan_bwd_cuda` in this process:
#: two a call, the reverse scan and the fixed-order sums behind it
launches = 0

#: the backward keeps 4 states per lane of a 4-lane group per channel
MAX_STATE = 16

#: steps between the saved states the backward recomputes its chunks from
STATE_CHUNK = 32

#: channels a block of the reverse scan covers (its partial sums' count)
_BLOCK_CH = 64

_DTYPES = {torch.float32: _build.FLOAT32, torch.bfloat16: _build.BFLOAT16}


def mamba_scan_bwd_cuda(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
                        Cc: torch.Tensor, A: torch.Tensor, hs: torch.Tensor,
                        dy: torch.Tensor, dhT: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward on PyTorch's current stream. The forward's
    inputs as :func:`repro_torch.kernels.mamba_scan.mamba_scan_cuda` takes
    them, ``hs`` (B, ceil(S / 32), dI, N) its saved states, ``dy`` (B, S,
    dI) and ``dhT`` (B, dI, N) or None, fp32. Returns (d dt, dx, dB, dC,
    dA) shaped as dt, x, Bc, Cc and A: dx, dB and dC in x's dtype, d dt
    and dA in fp32."""
    global launches
    tensors = (dt, x, Bc, Cc, A, hs, dy) + ((dhT,) if dhT is not None
                                             else ())
    if not all(t.is_cuda for t in tensors):
        raise ValueError("mamba_scan_bwd_cuda needs CUDA tensors")
    dev = x.device
    if any(t.device != dev for t in tensors):
        raise ValueError("mamba_scan_bwd_cuda: tensors on different devices")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or Bc.dtype != x.dtype or Cc.dtype != x.dtype:
        raise TypeError(f"mamba_scan_bwd_cuda: x/Bc/Cc dtypes {x.dtype}/"
                        f"{Bc.dtype}/{Cc.dtype}; expected all float32 or all "
                        "bfloat16")
    if any(t.dtype != torch.float32 for t in (dt, A, hs, dy)) \
            or (dhT is not None and dhT.dtype != torch.float32):
        raise TypeError("mamba_scan_bwd_cuda: dt, A, hs, dy and dhT must be "
                        "float32")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan_bwd_cuda: x {tuple(x.shape)} A "
                         f"{tuple(A.shape)}; expected (B, S, dI), (dI, N)")
    B, S, dI = x.shape
    N = A.shape[1]
    nch = -(-S // STATE_CHUNK)
    if dt.shape != x.shape or dy.shape != x.shape or A.shape[0] != dI \
            or Bc.shape != (B, S, N) or Cc.shape != (B, S, N) \
            or hs.shape != (B, nch, dI, N) \
            or (dhT is not None and dhT.shape != (B, dI, N)):
        raise ValueError(
            f"mamba_scan_bwd_cuda: dt {tuple(dt.shape)} x {tuple(x.shape)} "
            f"Bc {tuple(Bc.shape)} Cc {tuple(Cc.shape)} A {tuple(A.shape)} "
            f"hs {tuple(hs.shape)} dy {tuple(dy.shape)}; expected (B, S, dI) "
            f"x2, (B, S, N) x2, (dI, N), ({B}, {nch}, {dI}, {N}), (B, S, dI)")
    if min(B, S, dI, N) == 0 or B > 65535:
        raise ValueError(f"mamba_scan_bwd_cuda: B={B} S={S} dI={dI} N={N} "
                         "(each >= 1, B <= 65535)")
    if N > MAX_STATE:
        raise ValueError(f"mamba_scan_bwd_cuda: state size N={N} > "
                         f"{MAX_STATE}")
    for name, t in (("dt", dt), ("x", x), ("Bc", Bc), ("Cc", Cc), ("A", A),
                    ("hs", hs), ("dy", dy), ("dhT", dhT)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"mamba_scan_bwd_cuda: {name} not contiguous")
    lib = _build.ensure_built(dev.index)
    f32 = dict(dtype=torch.float32, device=dev)
    ddt = torch.empty((B, S, dI), **f32)
    dx = torch.empty((B, S, dI), dtype=x.dtype, device=dev)
    dB = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dA = torch.empty((dI, N), **f32)
    part = torch.empty((-(-dI // _BLOCK_CH), B, S, 2 * MAX_STATE), **f32)
    dA_part = torch.empty((B, dI, N), **f32)
    err = lib.repro_mamba_scan_bwd(
        dtype, dt.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), hs.data_ptr(), dy.data_ptr(),
        None if dhT is None else dhT.data_ptr(), ddt.data_ptr(),
        dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
        part.data_ptr(), dA_part.data_ptr(), B, S, dI, N,
        _build.current_stream(dev.index))
    _build.check(err, "mamba_scan_bwd")
    launches += 2
    return ddt, dx, dB, dC, dA
