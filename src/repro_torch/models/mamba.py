"""Mamba1 (selective scan) block of the port: the falcon-mamba half of
``repro.models.mamba``, same signatures and layouts on torch tensors.

* :func:`mamba_forward` (prefill) runs the whole sequence through ONE
  selective scan, :func:`repro_torch.kernels.ops.mamba_scan`: K3 on CUDA,
  its plain sequential version on the CPU. The reference runs ``_m1_scan``
  instead, an associative scan inside chunks of ``ssm_chunk`` steps linked
  by a ``lax.scan`` carry; the chunks bound XLA's O(chunk * dI * N)
  activation memory. The kernel keeps each state in a register for the
  whole sequence and needs no chunks, so ``ssm_chunk`` and
  ``ssm_scan_constrain`` are unused here. The two orders of summation differ
  by fp32 rounding only.
* :func:`mamba_step` (decode) is the single-token recurrence on the carried
  ``(conv_buf, h)``.

A prompt shorter than ``ssm_conv - 1`` tokens leaves a conv tail with fewer
than K-1 rows in the reference (which then fails to seat it in its
fixed-slot pool); here the tail is left-padded with zeros, the buffer a
token-by-token decode from :func:`init_mamba_state` would hold.

Mamba2 (zamba2's SSD form) comes with its own slice: the dispatch raises
``ValueError`` for ``ssm_version == 2``. The reference's ``constrain``
sharding hooks are identities off a mesh and are dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import mamba_scan_ref
from .layers import dtype_of

__all__ = ["mamba_forward", "mamba_step", "init_mamba_state", "SCAN_IMPLS"]

#: prefill scan paths: ``"kernel"`` (K3 on CUDA, the plain scan on the CPU)
#: and ``"plain"`` (the plain sequential scan on any device)
SCAN_IMPLS = ("kernel", "plain")


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (C, K); b: (C,)."""
    S = x.shape[1]
    K = w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:S] * w[:, 0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[:, k]
    return y + b


def _conv_step(buf: torch.Tensor, x1: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv. buf: (B, K-1, C) past inputs; x1: (B, C)."""
    window = torch.cat([buf, x1[:, None, :]], dim=1)          # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, w) + b
    return y, window[:, 1:, :]


def _require_m1(cfg: ModelConfig) -> None:
    if not cfg.ssm or cfg.ssm_version != 1:
        raise ValueError(f"{cfg.name}: repro_torch.models.mamba covers Mamba1 "
                         "(falcon-mamba) only; Mamba2 (SSD, zamba2) comes "
                         "with the zamba2 slice")


def _m1_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False, impl: str = "kernel"):
    B, S, D = x.shape
    dI, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.ssm_conv
    cdt = dtype_of(cfg.compute_dtype)
    xz = x @ p["in_proj"].to(cdt)
    x_in, z = xz.split(dI, dim=-1)
    xh = F.silu(_causal_conv(x_in, p["conv_w"].to(cdt),
                             p["conv_b"].to(cdt)))
    proj = xh @ p["x_proj"].to(cdt)
    dtr, Bc, Cc = proj.split([R, N, N], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x itself
    # above threshold=20, where the dropped log1p(exp(-x)) is below 2.1e-9
    # (1.1e-10 of x, far below fp32's resolution there)
    dt = F.softplus(dtr @ p["dt_proj"].to(cdt)
                    + p["dt_bias"].float())                  # (B,S,dI) f32
    A = -torch.exp(p["A_log"].float())                       # (dI,N) f32
    if impl == "kernel":
        y, hT = ops.mamba_scan(dt, xh, Bc.contiguous(), Cc.contiguous(), A,
                               h0=h0)
    elif impl == "plain":
        y, hT = mamba_scan_ref(dt, A, Bc, Cc, xh, h0=h0)
    else:
        raise ValueError(f"unknown scan impl {impl!r} (expected one of "
                         f"{SCAN_IMPLS})")
    y = y + p["ssm_D"].float() * xh.float()
    y = y.to(cdt) * F.silu(z)
    out = y @ p["out_proj"].to(cdt)
    if return_state:
        # conv tail: the last K-1 pre-conv inputs (the reference recomputes
        # this slice of the in-projection; here it is read off xz)
        tail = x_in[:, -(K - 1):, :]
        if S < K - 1:
            tail = F.pad(tail, (0, 0, K - 1 - S, 0))
        return out, (tail, hT)
    return out


def _m1_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """x1: (B, D); state = (conv_buf (B, K-1, dI), h (B, dI, N))."""
    conv_buf, h = state
    cdt = dtype_of(cfg.compute_dtype)
    dI, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    xz = x1 @ p["in_proj"].to(cdt)
    xh, z = xz.split(dI, dim=-1)
    xh, conv_buf = _conv_step(conv_buf.to(cdt), xh, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt))
    xh = F.silu(xh)
    proj = xh @ p["x_proj"].to(cdt)
    dtr, Bc, Cc = proj.split([R, N, N], dim=-1)
    dt = F.softplus(dtr @ p["dt_proj"].to(cdt)     # see _m1_forward
                    + p["dt_bias"].float())                  # (B,dI) f32
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[..., None] * A)                         # (B,dI,N)
    xf = xh.float()
    h = a * h + (dt * xf)[..., None] * Bc.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cc.float()) + p["ssm_D"].float() * xf
    y = y.to(cdt) * F.silu(z)
    return y @ p["out_proj"].to(cdt), (conv_buf, h)


# ==================================================================== dispatch
def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                  return_state: bool = False, impl: str = "kernel"):
    """Full-sequence Mamba1 block: x (B, S, D) -> (B, S, D) in the compute
    dtype; with ``return_state`` also ``(conv_tail (B, K-1, dI), h (B, dI,
    N) fp32)``. ``impl`` picks the scan (:data:`SCAN_IMPLS`)."""
    _require_m1(cfg)
    return _m1_forward(p, x, cfg, h0, return_state, impl)


def mamba_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """One token through a Mamba1 block: x1 (B, D) -> ((B, D), new state)."""
    _require_m1(cfg)
    return _m1_step(p, x1, cfg, state)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv_buf (B, K-1, dI) in ``dtype``, h (B, dI, N) fp32) zeros for
    decode; ``device`` None means CUDA."""
    _require_m1(cfg)
    dev = resolve_device(device)
    return (torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                        device=dev),
            torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=dev))
