"""Mamba1 (selective scan) and Mamba2 (SSD) blocks of the port: the
counterpart of ``repro.models.mamba``, same signatures and layouts on torch
tensors.

Mamba1 (falcon-mamba):

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

Mamba2 (zamba2): :func:`_ssd_scan` is the reference's SSD dual form in
plain torch (no TPU kernel computes it): inside a chunk the scalar-per-head
decay turns the recurrence into a masked, decayed "attention" of C against
B, and a carried state links the chunks. The chunk rule is the
reference's: ``chunk = min(ssm_chunk, S)``, and a ragged S runs as ONE
chunk, whose (B, S, S, nh) fp32 temporaries grow with S squared.
:func:`_m2_step` is the per-head recurrence the dual form stands for.

A prompt shorter than ``ssm_conv - 1`` tokens leaves a conv tail with fewer
than K-1 rows in the reference (which then fails to seat it in its
fixed-slot pool); here the tail is left-padded with zeros, the buffer a
token-by-token decode from :func:`init_mamba_state` would hold. The
reference's ``constrain`` sharding hooks are identities off a mesh and are
dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import mamba_scan_ref
from .layers import dtype_of, rms_norm

__all__ = ["mamba_forward", "mamba_step", "init_mamba_state", "SCAN_IMPLS"]

#: Mamba1 prefill scan paths: ``"kernel"`` (K3 on CUDA, the plain scan on
#: the CPU) and ``"plain"`` (the plain sequential scan on any device)
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


def _conv_tail(x_in: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 pre-conv inputs of x_in (B, S, C), left-padded with
    zeros when S < K-1 (the reference recomputes this slice of the
    in-projection; here it is read off the projection already made)."""
    tail = x_in[:, -(K - 1):, :]
    S = x_in.shape[1]
    return F.pad(tail, (0, 0, K - 1 - S, 0)) if S < K - 1 else tail


def _require_ssm(cfg: ModelConfig) -> None:
    if not cfg.ssm or cfg.ssm_version not in (1, 2):
        raise ValueError(f"{cfg.name}: not a Mamba1 or Mamba2 config "
                         f"(ssm={cfg.ssm}, ssm_version={cfg.ssm_version})")


# ===================================================================== Mamba1
def _m1_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False, impl: str = "kernel"):
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
        return out, (_conv_tail(x_in, K), hT)
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


# ===================================================================== Mamba2
def _ssd_scan(xh, dt, A, Bc, Cc, h0, chunk: int):
    """SSD dual form. xh: (B, S, nh, hp); dt: (B, S, nh) fp32; A: (nh,)
    fp32; Bc, Cc: (B, S, N); h0: (B, nh, hp, N) fp32. Returns y (B, S, nh,
    hp) and the final h, both fp32. A ragged S runs as one chunk (the
    reference's rule)."""
    S = xh.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    xf, Bf, Cf = xh.float(), Bc.float(), Cc.float()
    loga = dt * A                                             # (B,S,nh) <= 0
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()[None, :, :, None]
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        c = slice(c0, c0 + chunk)
        x_c, dt_c, b_c, c_c = xf[:, c], dt[:, c], Bf[:, c], Cf[:, c]
        L = torch.cumsum(loga[:, c], dim=1)                   # (B,c,nh)
        # intra-chunk: causal "attention" with decay (above the diagonal
        # seg >= 0 may overflow exp; the mask selects 0 there)
        seg = L[:, :, None, :] - L[:, None, :, :]             # (B,t,s,nh)
        decay = torch.where(causal, torch.exp(seg), 0.0)
        cb = torch.einsum("btn,bsn->bts", c_c, b_c)
        w = cb[..., None] * decay * dt_c[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", w, x_c)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("btn,bhpn->bthp", c_c, h) \
            * torch.exp(L)[..., None]
        # chunk state: sum_s exp(L_last - L_s) dt_s x_s B_s^T
        rdecay = torch.exp(L[:, -1:, :] - L)                  # (B,c,nh)
        hc = torch.einsum("bshp,bsn->bhpn",
                          x_c * (dt_c * rdecay)[..., None], b_c)
        h = h * torch.exp(L[:, -1])[..., None, None] + hc
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _m2_split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """in_proj output -> (z, pre-conv xBC, dt)."""
    dI, N = cfg.d_inner, cfg.ssm_state
    return zxbcdt.split([dI, dI + 2 * N, cfg.ssm_heads], dim=-1)


def _m2_out(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig, cdt
            ) -> torch.Tensor:
    """Gated norm and out-projection: rms_norm(y * silu(z)) @ out_proj."""
    y = rms_norm(y.to(cdt) * F.silu(z), p["ssm_norm"], cfg.rms_eps)
    return y @ p["out_proj"].to(cdt)


def _m2_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False):
    B, S, _ = x.shape
    dI, N, nh, hp = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    z, xbc_in, dt = _m2_split(x @ p["in_proj"].to(cdt), cfg)
    xbc = F.silu(_causal_conv(xbc_in, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt)))
    xh, Bc, Cc = xbc.split([dI, N, N], dim=-1)
    # softplus: see _m1_forward
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,S,nh)
    A = -torch.exp(p["A_log"].float())                       # (nh,)
    xhh = xh.reshape(B, S, nh, hp)
    if h0 is None:
        h0 = torch.zeros((B, nh, hp, N), dtype=torch.float32,
                         device=x.device)
    y, hT = _ssd_scan(xhh, dt, A, Bc, Cc, h0, cfg.ssm_chunk)
    y = y + p["ssm_D"].float()[:, None] * xhh.float()
    out = _m2_out(p, y.reshape(B, S, dI), z, cfg, cdt)
    if return_state:
        return out, (_conv_tail(xbc_in, cfg.ssm_conv), hT)
    return out


def _m2_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """x1: (B, D); state = (conv_buf (B, K-1, dI+2N), h (B, nh, hp, N))."""
    conv_buf, h = state
    B = x1.shape[0]
    dI, N, nh, hp = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    z, xbc, dt = _m2_split(x1 @ p["in_proj"].to(cdt), cfg)
    xbc, conv_buf = _conv_step(conv_buf.to(cdt), xbc, p["conv_w"].to(cdt),
                               p["conv_b"].to(cdt))
    xh, Bc, Cc = F.silu(xbc).split([dI, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,nh)
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))      # (B,nh)
    xhh = xh.reshape(B, nh, hp).float()
    h = a[..., None, None] * h \
        + (dt[..., None] * xhh)[..., None] * Bc.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cc.float()) \
        + p["ssm_D"].float()[:, None] * xhh
    return _m2_out(p, y.reshape(B, dI), z, cfg, cdt), (conv_buf, h)


# ==================================================================== dispatch
def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                  return_state: bool = False, impl: str = "kernel"):
    """Full-sequence Mamba block: x (B, S, D) -> (B, S, D) in the compute
    dtype; with ``return_state`` also ``(conv_tail, h)`` in
    :func:`init_mamba_state`'s layout. ``impl`` picks Mamba1's scan
    (:data:`SCAN_IMPLS`); Mamba2's SSD has one path."""
    _require_ssm(cfg)
    if cfg.ssm_version == 2:
        return _m2_forward(p, x, cfg, h0, return_state)
    return _m1_forward(p, x, cfg, h0, return_state, impl)


def mamba_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """One token through a Mamba block: x1 (B, D) -> ((B, D), new state)."""
    _require_ssm(cfg)
    f = _m1_step if cfg.ssm_version == 1 else _m2_step
    return f(p, x1, cfg, state)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeros for decode, ``device`` None meaning CUDA. Mamba1: (conv_buf
    (B, K-1, dI) in ``dtype``, h (B, dI, N) fp32); Mamba2: (conv_buf (B,
    K-1, dI+2N) in ``dtype``, h (B, nh, hp, N) fp32)."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    if cfg.ssm_version == 1:
        conv_dim, hshape = cfg.d_inner, (cfg.d_inner, cfg.ssm_state)
    else:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        hshape = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return (torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                        device=dev),
            torch.zeros((batch, *hshape), dtype=torch.float32, device=dev))
